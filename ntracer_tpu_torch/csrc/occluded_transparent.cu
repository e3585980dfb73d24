// Filtered occlusion walk over a chunked triangle pool with transparent
// slots, for Hopper (sm_90a): is there an opaque hit with 0 < t < ldist
// along each shadow ray, and how much light do the transparent hits in that
// range let through?
//
// Replaces the TPU kernel ntracer_tpu/engine/resident_kernels.py
// `occluded_transparent` (pallas_call body `_occl_t_kernel` ->
// `_occl_t_live`, candidate scan `_candidate_walk`).  Its plain PyTorch twin
// is `occluded_transparent_ref` in
// ntracer_tpu_torch/engine/resident_kernels.py; the two agree on `blocked`,
// bit for bit on `filt`, and on `visits`, ray for ray and block for block.
//
// What it computes.  Everything of the opaque occlusion walk (occluded.cu):
// liveness by ldist > 0, the bound = the largest ldist of the block's rays
// that are not blocked yet, groups of four candidates picked with the bound
// from before the previous group.  Per visit a thread whose ray is still
// undecided tests the chunk's 128 slots with t < ldist: an opaque slot
// (opacity >= 1) blocks the ray and ends its work; a transparent one
// contributes the factor 1 - opacity.  The visit's factors are multiplied
// as the TPU kernel's halving tree over the lanes -- lanes i and i + 64,
// then i and i + 32, ... -- because three or more real factors in one chunk
// round differently under another association.  The thread walks the lanes
// in bit-reversed order and keeps a 7-level carry stack in registers: lane
// pairs (i, i + 64) meet at level 0, their products at level 1, and so on,
// which is exactly that tree (multiplication commutes, so only the
// association matters).  The visit's product is then multiplied into the
// ray's `filt`, visits in walk order.  `filt` is written as 1 where the ray
// ends blocked or is inactive.
//
// What bounds it.  Pair-test arithmetic, as for the opaque occlusion walk;
// the tree costs 127 multiplies beside 128 pair tests of 2*d*d multiply-adds
// and a division each.  Decided threads (blocked or inactive) skip the slot
// loop, a blocked ray lowers the block's bound, and a dead block costs one
// load and two stores per ray.
//
// STREAM: kernel 2.8, which replaces `occluded_transparent_hbm`
// (pallas_call body `_occl_t_hbm_kernel` -> `_occl_t_hbm_live`) for pools
// over the line: the same walk, `blocked`, `filt` and visits, bit for bit,
// with each visited chunk (opacity row included) copied into a ring of
// shared-memory slots while the previous group is tested (chunk_ring.cuh).
//
// Build: nvcc --fmad=false, IEEE division (see engine/_build.py).

#include "chunk_ring.cuh"

namespace {

using namespace ntr;

constexpr int LEVELS = 7;        // log2(CK): depth of the lane tree
static_assert((1 << LEVELS) == CK, "the lane tree spans one chunk");

template <int D, bool STREAM>
__global__ void __launch_bounds__(RB) occluded_t_kernel(
    const float* __restrict__ oT, const float* __restrict__ dT,
    const int* __restrict__ skip, const float* __restrict__ ldist,
    const int* __restrict__ order, int n_eff, const int* __restrict__ blive,
    const float* __restrict__ klo_t, const float* __restrict__ khi_t,
    int ncp, const float* __restrict__ gt, const float* __restrict__ ci,
    const int* __restrict__ ids, const float* __restrict__ opa, int pr, int R,
    unsigned char* __restrict__ out_blocked, float* __restrict__ out_filt,
    int* __restrict__ visits, float* __restrict__ emin_all, int n_slots) {
  __shared__ float s_wmin[NW * 32];    // per-warp entry minima
  __shared__ float s_red[NW];
  __shared__ int s_cand[NCAND];

  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  const int r = blk * RB + tid;
  if (!blive[blk]) {                   // no ray of the block is active
    out_blocked[r] = 0;
    out_filt[r] = 1.f;
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
  float filt = 1.f;

  // largest ldist among the block's rays that are not blocked yet
  auto lmax = [&]() -> float { return block_max(blocked ? 0.f : ld, s_red); };

  auto test = [&](int, const Chunk& ch) {
    // no t < ld can hold for ld <= 0 (valid needs t > 0) or NaN
    if (!blocked && ld > 0.f) {
      float st[LEVELS];                // carry stack of the lane tree
#pragma unroll
      for (int lev = 0; lev < LEVELS; ++lev) st[lev] = 1.f;
      float prod = 1.f;
      for (int j = 0; j < CK; ++j) {
        const int l = (int)(__brev((unsigned)j) >> (32 - LEVELS));
        float t;
        float x = 1.f;
        if (pair_test<D, false>(ch.g, ch.c, l, o, dv, t) &&
            (ch.id[l] != sk) && (t < ld)) {
          const float op = ch.opa[l];
          if (op >= 1.f) {
            blocked = true;
            break;
          }
          x = 1.f - op;
        }
        // binary-counter carry: level k joins halves that differ in bit k
        // of j, i.e. in bit 6 - k of the lane
#pragma unroll
        for (int lev = 0; lev < LEVELS; ++lev) {
          if ((j >> lev) & 1) {
            x = st[lev] * x;
          } else {
            st[lev] = x;
            break;
          }
        }
        prod = x;                      // after the last lane: the whole tree
      }
      if (!blocked) filt = filt * prod;
    }
  };

  // 2. the walk
  int nvis;
  if constexpr (STREAM)
    nvis = stream_walk<D, true>(gt, ci, ids, opa, pr, order, n_eff, emin,
                                n_slots, s_cand, lmax, test);
  else
    nvis = resident_walk<D, NCAND, true>(gt, ci, ids, opa, pr, order, n_eff,
                                         emin, s_cand, lmax, test);

  out_blocked[r] = blocked ? 1 : 0;
  out_filt[r] = blocked ? 1.f : filt;
  if (tid == 0) visits[blk] = nvis;
}

template <bool STREAM>
int launch_d(const float* oT, const float* dT, const int* skip,
             const float* ldist, const int* order, int n_eff,
             const int* blive, const float* klo_t, const float* khi_t,
             int ncp, const float* gt, const float* ci, const int* ids,
             const float* opa, int pr, int R, int d, unsigned char* blocked,
             float* filt, int* visits, float* emin, void* stream) {
  const int grid = R / RB;
  if (R % RB || grid == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int n_slots = 0, smem = 0;
#define NTR_CASE(DD)                                                         \
  case DD: {                                                                 \
    auto kernel = occluded_t_kernel<DD, STREAM>;                             \
    if (STREAM) {                                                            \
      const cudaError_t err = ring_config<DD, true>(kernel, &n_slots, &smem); \
      if (err != cudaSuccess) return (int)err;                               \
    }                                                                        \
    kernel<<<grid, RB, smem, s>>>(oT, dT, skip, ldist, order, n_eff, blive,  \
                                  klo_t, khi_t, ncp, gt, ci, ids, opa, pr,   \
                                  R, blocked, filt, visits, emin, n_slots);  \
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

// Launch the filtered occlusion walk on `stream`.  Arguments as
// ntr_occluded, plus opa (nc, 8, 128) f32 (row 0 = the slots' opacities)
// and filt (R,) f32.  Returns cudaGetLastError() after the launch.
int ntr_occluded_t(const float* oT, const float* dT, const int* skip,
                   const float* ldist, const int* order, int n_eff,
                   const int* blive, const float* klo_t, const float* khi_t,
                   int ncp, const float* gt, const float* ci, const int* ids,
                   const float* opa, int pr, int R, int d,
                   unsigned char* blocked, float* filt, int* visits,
                   float* emin, void* stream) {
  return launch_d<false>(oT, dT, skip, ldist, order, n_eff, blive, klo_t,
                         khi_t, ncp, gt, ci, ids, opa, pr, R, d, blocked, filt,
                         visits, emin, stream);
}

// The streaming walk (kernel 2.8): arguments and outputs as ntr_occluded_t;
// gt, ci, ids and opa must be 16-byte aligned.
int ntr_occluded_t_hbm(const float* oT, const float* dT, const int* skip,
                       const float* ldist, const int* order, int n_eff,
                       const int* blive, const float* klo_t,
                       const float* khi_t, int ncp, const float* gt,
                       const float* ci, const int* ids, const float* opa,
                       int pr, int R, int d, unsigned char* blocked,
                       float* filt, int* visits, float* emin, void* stream) {
  return launch_d<true>(oT, dT, skip, ldist, order, n_eff, blive, klo_t,
                        khi_t, ncp, gt, ci, ids, opa, pr, R, d, blocked, filt,
                        visits, emin, stream);
}

}  // extern "C"
