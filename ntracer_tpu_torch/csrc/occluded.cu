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
// STREAM: kernel 2.6, which replaces `occluded_hbm` (pallas_call body
// `_occl_hbm_kernel` -> `_occl_hbm_live`) for pools over the line: the same
// walk, `blocked` and visits, with each visited chunk copied into a ring of
// shared-memory slots while the previous group is tested (chunk_ring.cuh).
//
// Build: nvcc --fmad=false, IEEE division (see engine/_build.py).

#include "chunk_ring.cuh"

namespace {

using namespace ntr;

template <int D, bool STREAM>
__global__ void __launch_bounds__(RB) occluded_kernel(
    const float* __restrict__ oT, const float* __restrict__ dT,
    const int* __restrict__ skip, const float* __restrict__ ldist,
    const int* __restrict__ order, int n_eff, const int* __restrict__ blive,
    const float* __restrict__ klo_t, const float* __restrict__ khi_t,
    int ncp, const float* __restrict__ gt, const float* __restrict__ ci,
    const int* __restrict__ ids, int pr, int R,
    unsigned char* __restrict__ out_blocked, int* __restrict__ visits,
    float* __restrict__ emin_all, int n_slots) {
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

  // largest ldist among the block's rays that are not blocked yet
  auto lmax = [&]() -> float { return block_max(blocked ? 0.f : ld, s_red); };

  auto test = [&](int, const Chunk& ch) {
    // no t < ld can hold for ld <= 0 (valid needs t > 0) or NaN
    if (!blocked && ld > 0.f) {
      for (int l = 0; l < CK; ++l) {
        float t;
        if (pair_test<D, false>(ch.g, ch.c, l, o, dv, t) &&
            (ch.id[l] != sk) && (t < ld)) {
          blocked = true;
          break;
        }
      }
    }
  };

  // 2. the walk
  int nvis;
  if constexpr (STREAM)
    nvis = stream_walk<D, false>(gt, ci, ids, nullptr, pr, order, n_eff, emin,
                                 n_slots, s_cand, lmax, test);
  else
    nvis = resident_walk<D, NCAND, false>(gt, ci, ids, nullptr, pr, order,
                                          n_eff, emin, s_cand, lmax, test);

  out_blocked[r] = blocked ? 1 : 0;
  if (tid == 0) visits[blk] = nvis;
}

template <bool STREAM>
int launch_d(const float* oT, const float* dT, const int* skip,
             const float* ldist, const int* order, int n_eff,
             const int* blive, const float* klo_t, const float* khi_t,
             int ncp, const float* gt, const float* ci, const int* ids,
             int pr, int R, int d, unsigned char* blocked, int* visits,
             float* emin, void* stream) {
  const int grid = R / RB;
  if (R % RB || grid == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int n_slots = 0, smem = 0;
#define NTR_CASE(DD)                                                         \
  case DD: {                                                                 \
    auto kernel = occluded_kernel<DD, STREAM>;                               \
    if (STREAM) {                                                            \
      const cudaError_t err = ring_config<DD, false>(kernel, &n_slots, &smem);\
      if (err != cudaSuccess) return (int)err;                               \
    }                                                                        \
    kernel<<<grid, RB, smem, s>>>(oT, dT, skip, ldist, order, n_eff, blive,  \
                                  klo_t, khi_t, ncp, gt, ci, ids, pr, R,     \
                                  blocked, visits, emin, n_slots);           \
    break;                                                                   \
  }
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
  return launch_d<false>(oT, dT, skip, ldist, order, n_eff, blive, klo_t,
                         khi_t, ncp, gt, ci, ids, pr, R, d, blocked, visits,
                         emin, stream);
}

// The streaming walk (kernel 2.6): arguments and outputs as ntr_occluded;
// gt, ci and ids must be 16-byte aligned.
int ntr_occluded_hbm(const float* oT, const float* dT, const int* skip,
                     const float* ldist, const int* order, int n_eff,
                     const int* blive, const float* klo_t, const float* khi_t,
                     int ncp, const float* gt, const float* ci,
                     const int* ids, int pr, int R, int d,
                     unsigned char* blocked, int* visits, float* emin,
                     void* stream) {
  return launch_d<true>(oT, dT, skip, ldist, order, n_eff, blive, klo_t,
                        khi_t, ncp, gt, ci, ids, pr, R, d, blocked, visits,
                        emin, stream);
}

}  // extern "C"
