// Any-hit occlusion walk over a chunked triangle pool, for Hopper (sm_90a):
// is there an opaque hit with 0 < t < ldist along each shadow ray?
//
// Replaces the TPU kernel ntracer_tpu/engine/resident_kernels.py `occluded`
// (pallas_call body `_occlusion_kernel` -> `_occlusion_walk`, candidate scan
// `_candidate_walk`).  Its plain PyTorch twin is `occluded_ref` in
// ntracer_tpu_torch/engine/resident_kernels.py; the two agree on `blocked`
// and on `visits`, ray for ray and block for block.
//
// What it computes.  One CUDA block walks one 512-ray block, one thread per
// ray; a ray with ldist <= 0 is inactive.  A block without an active ray
// writes blocked = 0, visits = 0 and returns.  Otherwise every thread takes
// its slab entry into every chunk's box and the block keeps the minimum per
// chunk position (`emin`, global scratch), as the nearest-hit walk does.
// The walk's bound is the largest ldist among the block's rays that are not
// blocked yet; it picks the next four positions with emin below the bound,
// with the bound from before the previous group's updates (the TPU kernel's
// default grouping, so visit counts stay comparable), and visits them.  A
// visit stages the chunk in shared memory; a thread whose ray is still
// undecided tests it against the 128 slots and stops at the first valid hit
// with t < ldist.  `blocked` is a monotone OR over visits: any superset of
// the necessary chunks gives the same answer, so the grouping changes
// `visits` only.
//
// What bounds it.  Pair-test arithmetic, like the nearest-hit walk: a visit
// is up to 512 x 128 tests of 2*d*d multiply-adds (shadow rays have their
// own origins, so the origin dots are not shared) and one IEEE division.
// The pool (20 KB a chunk at d = 6) sits in L2.  The design spends nothing
// on decided rays (blocked or inactive threads skip the slot loop, and a
// blocked ray lowers the block's bound), exits a slot loop at the first
// hit, and skips dead blocks at the cost of one load per ray.
//
// Build: nvcc --fmad=false, IEEE division (see engine/_build.py).

#include "pair_test.cuh"

namespace {

using namespace ntr;

template <int D>
__global__ void __launch_bounds__(RB) occluded_kernel(
    const float* __restrict__ oT, const float* __restrict__ dT,
    const int* __restrict__ skip, const float* __restrict__ ldist,
    const int* __restrict__ order, int n_eff, const int* __restrict__ blive,
    const float* __restrict__ klo_t, const float* __restrict__ khi_t,
    int ncp, const float* __restrict__ gt, const float* __restrict__ ci,
    const int* __restrict__ ids, int pr, int R,
    unsigned char* __restrict__ out_blocked, int* __restrict__ visits,
    float* __restrict__ emin_all) {
  __shared__ float s_g[D * D * CK];    // plane rows of the visited chunk
  __shared__ float s_c[D * CK];        // offset rows
  __shared__ int s_id[CK];             // pool id row
  __shared__ float s_wmin[NW * 32];    // per-warp entry minima
  __shared__ float s_red[NW];
  __shared__ int s_cand[NCAND];

  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  const int r = blk * RB + tid;
  if (!blive[blk]) {                   // no ray of the block is active
    out_blocked[r] = 0;
    if (tid == 0) visits[blk] = 0;
    return;
  }

  float o[D], dv[D], inv[D];
  load_ray<D>(oT, dT, R, r, o, dv, inv);
  const int sk = skip[r];
  const float ld = ldist[r];
  float* emin = emin_all + (size_t)blk * n_eff;

  // 1. min-over-rays slab entry of every chunk position
  entry_minima<D>(o, dv, inv, klo_t, khi_t, ncp, n_eff, emin, s_wmin);

  bool blocked = false;
  int nvis = 0;

  // largest ldist among the block's rays that are not blocked yet
  auto lmax = [&]() -> float { return block_max(blocked ? 0.f : ld, s_red); };

  auto visit = [&](int idx) {
    stage_chunk<D>(gt, ci, ids, pr, idx, s_g, s_c, s_id);
    // no t < ld can hold for ld <= 0 (valid needs t > 0) or NaN
    if (!blocked && ld > 0.f) {
      for (int l = 0; l < CK; ++l) {
        float t;
        if (pair_test<D, false>(s_g, s_c, l, o, dv, t) && (s_id[l] != sk) &&
            (t < ld)) {
          blocked = true;
          break;
        }
      }
    }
    __syncthreads();
  };

  // 2. the walk
  int cur[NCAND], nxt[NCAND];
  find_cands(0, lmax(), n_eff, emin, s_cand, cur);
  while (cur[0] != SENT) {
    // the next group is picked with the bound from before this group
    const int kn = cur[NCAND - 1] == SENT ? n_eff : cur[NCAND - 1] + 1;
    find_cands(kn, lmax(), n_eff, emin, s_cand, nxt);
    for (int j = 0; j < NCAND; ++j) {
      if (cur[j] != SENT) {
        visit(order[cur[j]]);
        ++nvis;
      }
    }
#pragma unroll
    for (int j = 0; j < NCAND; ++j) cur[j] = nxt[j];
  }

  out_blocked[r] = blocked ? 1 : 0;
  if (tid == 0) visits[blk] = nvis;
}

}  // namespace

extern "C" {

// Launch the occlusion walk on `stream`.  Rays are lane-major (d, R) with
// 3 <= d <= 8 and R a multiple of 512; ldist (R,), <= 0 for inactive rays;
// gt (nc, pr, 128), ci (nc, 8, 128), ids (nc, 8, 128) i32; klo_t/khi_t
// (8, ncp) in visit order; blocked (R,) bytes (0 or 1); emin scratch holds
// (R / 512) * n_eff floats.  Returns cudaGetLastError() after the launch.
int ntr_occluded(const float* oT, const float* dT, const int* skip,
                 const float* ldist, const int* order, int n_eff,
                 const int* blive, const float* klo_t, const float* khi_t,
                 int ncp, const float* gt, const float* ci, const int* ids,
                 int pr, int R, int d, unsigned char* blocked, int* visits,
                 float* emin, void* stream) {
  const int grid = R / RB;
  if (R % RB || grid == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define NTR_CASE(DD)                                                       \
  case DD:                                                                 \
    occluded_kernel<DD><<<grid, RB, 0, s>>>(                               \
        oT, dT, skip, ldist, order, n_eff, blive, klo_t, khi_t, ncp, gt,   \
        ci, ids, pr, R, blocked, visits, emin);                            \
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

}  // extern "C"
