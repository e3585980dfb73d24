// Front-to-back nearest-hit walk over a chunked triangle pool, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel ntracer_tpu/engine/resident_kernels.py
// `nearest_hit` (pallas_call body `_nearest_kernel` -> `_nearest_walk_live`,
// pair test `_chunk_hits_vals`, entry bounds `_entry_all`).  Its plain
// PyTorch twin is `nearest_hit_ref` in
// ntracer_tpu_torch/engine/resident_kernels.py; the two agree bit for bit.
// The entry pass, the candidate scan and the pair test live in
// pair_test.cuh, shared with the occlusion walk (occluded.cu).
//
// What it computes.  One CUDA block walks one 512-ray block (a 32x16-pixel
// tile), one thread per ray.  First every thread computes its slab entry
// into every chunk's box (chunks in visit order), and the block keeps the
// minimum over its rays per chunk position (`emin`, in global scratch, so
// the pool has no chunk-count limit).  Then the walk picks the next four
// candidate positions (emin below the block's largest best t) with the
// bound from before the previous group's updates -- the TPU kernel's
// grouped rule, so both visit the same chunks -- and visits them: the
// chunk's plane rows, offset rows and id row are staged in shared memory
// and each thread tests its ray against the 128 slots in lane order,
// keeping the first lane of the minimum and updating its best on strict <.
//
// What bounds it.  Per-visit pair-test arithmetic: each visit is 512 x 128
// pair tests of d*d multiply-adds plus one IEEE division (d = 4: ~50
// instructions a pair).  The flagship 120-cell frame makes ~9.6 visits per
// block; its whole pool is ~442 KB and sits in L2, so device memory is not
// the limit.  The design keeps the pool rows in shared memory for the
// block's visit (all threads read the same address: broadcast, no bank
// conflicts) and the ray in registers, and skips dead blocks outright.
// Making the pair test cheaper (fewer divisions, several rays a thread,
// async staging of the next chunk) is later work.
//
// Build: nvcc --fmad=false, IEEE division (see engine/_build.py).  No a*b+c
// is contracted, so every operation rounds as in the twin.

#include "pair_test.cuh"

namespace {

using namespace ntr;

template <int D, bool SHARED>
__global__ void __launch_bounds__(RB) nearest_kernel(
    const float* __restrict__ oT, const float* __restrict__ dT,
    const int* __restrict__ skip, const float* __restrict__ init_t,
    const int* __restrict__ order, int n_eff, const int* __restrict__ blive,
    const float* __restrict__ klo_t, const float* __restrict__ khi_t,
    int ncp, const float* __restrict__ gt, const float* __restrict__ ci,
    const int* __restrict__ ids, int pr, int R, float* __restrict__ out_t,
    int* __restrict__ out_slot, int* __restrict__ visits,
    float* __restrict__ emin_all) {
  __shared__ float s_g[D * D * CK];    // plane rows of the visited chunk
  __shared__ float s_c[D * CK];        // offset rows (ci, or sh if SHARED)
  __shared__ int s_id[CK];             // pool id row
  __shared__ float s_wmin[NW * 32];    // per-warp entry minima
  __shared__ float s_red[NW];
  __shared__ int s_cand[NCAND];

  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  const int r = blk * RB + tid;
  const float it = init_t[r];
  if (!blive[blk]) {                   // every ray of the block is dead
    out_t[r] = it;
    out_slot[r] = -1;
    if (tid == 0) visits[blk] = 0;
    return;
  }

  float o[D], dv[D], inv[D];
  load_ray<D>(oT, dT, R, r, o, dv, inv);
  const int sk = skip[r];
  float* emin = emin_all + (size_t)blk * n_eff;

  // 1. min-over-rays slab entry of every chunk position
  entry_minima<D>(o, dv, inv, klo_t, khi_t, ncp, n_eff, emin, s_wmin);

  float best = it;
  int best_id = -1;
  int nvis = 0;

  auto visit = [&](int idx) {
    stage_chunk<D>(gt, ci, ids, pr, idx, s_g, s_c, s_id);
    float cbest = INFINITY;
    int carg = 0;
    for (int l = 0; l < CK; ++l) {
      float t;
      const bool valid =
          pair_test<D, SHARED>(s_g, s_c, l, o, dv, t) && (s_id[l] != sk);
      if (valid && t < cbest) {
        cbest = t;
        carg = l;
      }
    }
    if (cbest < best) {
      best = cbest;
      best_id = idx * CK + carg;
    }
    __syncthreads();
  };

  // 2. the walk
  int cur[NCAND], nxt[NCAND];
  find_cands(0, block_max(best, s_red), n_eff, emin, s_cand, cur);
  while (cur[0] != SENT) {
    // the next group is picked with the bound from before this group
    const int kn = cur[NCAND - 1] == SENT ? n_eff : cur[NCAND - 1] + 1;
    find_cands(kn, block_max(best, s_red), n_eff, emin, s_cand, nxt);
    for (int j = 0; j < NCAND; ++j) {
      if (cur[j] != SENT) {
        visit(order[cur[j]]);
        ++nvis;
      }
    }
#pragma unroll
    for (int j = 0; j < NCAND; ++j) cur[j] = nxt[j];
  }

  out_t[r] = best;
  out_slot[r] = best_id;
  if (tid == 0) visits[blk] = nvis;
}

template <int D, bool SHARED>
void launch(int grid, cudaStream_t s, const float* oT, const float* dT,
            const int* skip, const float* init_t, const int* order, int n_eff,
            const int* blive, const float* klo_t, const float* khi_t, int ncp,
            const float* gt, const float* ci, const int* ids, int pr, int R,
            float* out_t, int* out_slot, int* visits, float* emin) {
  nearest_kernel<D, SHARED><<<grid, RB, 0, s>>>(
      oT, dT, skip, init_t, order, n_eff, blive, klo_t, khi_t, ncp, gt, ci,
      ids, pr, R, out_t, out_slot, visits, emin);
}

}  // namespace

extern "C" {

// Launch the walk on `stream`.  Rays are lane-major (d, R) with 3 <= d <= 8
// and R a multiple of 512; gt (nc, pr, 128), ci (nc, 8, 128), ids (nc, 8, 128) i32; klo_t/khi_t
// (8, ncp) in visit order; emin scratch holds (R / 512) * n_eff floats.
// Returns cudaGetLastError() after the launch.
int ntr_nearest_hit(const float* oT, const float* dT, const int* skip,
                    const float* init_t, const int* order, int n_eff,
                    const int* blive, const float* klo_t, const float* khi_t,
                    int ncp, const float* gt, const float* ci, const int* ids,
                    int pr, int R, int d, int shared, float* out_t,
                    int* out_slot, int* visits, float* emin, void* stream) {
  const int grid = R / RB;
  if (R % RB || grid == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define NTR_CASE(DD)                                                        \
  case DD:                                                                  \
    if (shared)                                                             \
      launch<DD, true>(grid, s, oT, dT, skip, init_t, order, n_eff, blive,  \
                       klo_t, khi_t, ncp, gt, ci, ids, pr, R, out_t,        \
                       out_slot, visits, emin);                             \
    else                                                                    \
      launch<DD, false>(grid, s, oT, dT, skip, init_t, order, n_eff, blive, \
                        klo_t, khi_t, ncp, gt, ci, ids, pr, R, out_t,       \
                        out_slot, visits, emin);                            \
    break;
  switch (d) {
    NTR_CASE(3)
    NTR_CASE(4)
    NTR_CASE(5)
    NTR_CASE(6)
    NTR_CASE(7)
    NTR_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NTR_CASE
  return (int)cudaGetLastError();
}

const char* ntr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
