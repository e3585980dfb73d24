// Filtered occlusion walk over a chunked triangle pool with transparent
// slots, for Hopper (sm_90a): is there an opaque hit with 0 < t < ldist
// along each shadow ray, and how much light do the transparent hits in that
// range let through?
//
// Replaces two TPU kernels of ntracer_tpu/engine/resident_kernels.py with
// one body, `occluded_t_stream_kernel`: `occluded_transparent` (kernel 2.4,
// pallas_call body `_occl_t_kernel` -> `_occl_t_live`, candidate scan
// `_candidate_walk`), the walk of pools under the line, and
// `occluded_transparent_hbm` (kernel 2.8, body `_occl_t_hbm_kernel` ->
// `_occl_t_hbm_live`), the walk of pools over it.  One C entry,
// `ntr_occluded_t`, launches the body on a pool of any size; the plain
// PyTorch twin is `occluded_transparent_ref` in
// ntracer_tpu_torch/engine/resident_kernels.py.  Kernel and twin agree on
// `blocked`, bit for bit on `filt`, and on `visits`, ray for ray and block
// for block.
//
// What it computes.  Everything of the opaque occlusion walk (occluded.cu):
// liveness by ldist > 0, the bound = the largest ldist of the block's rays
// that are not blocked yet, groups of four candidates picked with the bound
// from before the previous group.  Per visit every ray that is still
// undecided tests the chunk's 128 slots with t < ldist: an opaque slot
// (opacity >= 1) blocks the ray and ends its work; a transparent one
// contributes the factor 1 - opacity.  The visit's factors are multiplied
// as the TPU kernel's halving tree over the lanes -- lanes i and i + 64,
// then i and i + 32, ... -- because three or more real factors in one chunk
// round differently under another association.  The visit's product is
// then multiplied into the ray's `filt`, visits in walk order.  `filt` is
// written as 1 where the ray ends blocked or is inactive, and a block
// without an active ray stores its outputs and returns.
//
// What bounds it.  Pair-test arithmetic, as for the opaque occlusion walk:
// 2*d*d multiply-adds and a division a pair, each edge plane only for the
// pairs that reach it.  The filter adds a multiply for each glass surface a
// ray really crosses.
//
// The design is stream_walk.cuh's loop: each visited chunk (opacity row
// included) is copied into a ring of shared-memory slots while the
// previous group is tested; compacted undecided rays, four slot ranges a
// ray on neighbouring lanes, the straight-line pair test, a visit's tasks
// drawn by whichever warp is free, per-warp slot release, two blocks an
// SM (see there).  A pool under the line (27 chunks for the 4-D 120-cell)
// takes the same body: its chunks stay in the 50 MB L2, and the ring's
// copies come from there.  A visit's product of a ray waits in shared
// memory until the group's boundary, where the group's products join the
// ray's filter in walk order.  Range q of a ray is the positions 32q ..
// 32q + 31 of the bit-reversed lane order: one level-5 subtree T_q of the
// halving tree, whose root joins them as (T_0 * T_1) * (T_2 * T_3) -- two
// shuffles.  Inside a range the lane keeps the tree only over the factors
// other than 1: since 1 * y = y exactly, the tree with its all-ones
// subtrees dropped has the same bits.  A short stack in registers does it
// (`tree_push`): between consecutive non-1 factors at positions a < b the
// tree joins at level h = msb(a ^ b), so a new factor first folds the
// stack's entries below h (left * right), then waits at level h.
//
// Build: nvcc --fmad=false, IEEE division (see engine/_build.py).

#include "stream_walk.cuh"

namespace {

using namespace ntr;

constexpr int RLEVELS = 5;       // log2(SR): depth of a range's subtree
static_assert((1 << RLEVELS) == SR, "a range is one subtree");

// A range's halving tree over its non-1 factors, in position order: `st`
// holds the left operands waiting at each level (bit g of `mask` set where
// one waits), `cur` the rightmost open product, `prev` the last non-1
// position (-1 before the first).
struct RangeTree {
  float st[RLEVELS];
  float cur;
  unsigned mask;
  int prev;
};

__device__ __forceinline__ void tree_init(RangeTree& tr) {
  tr.mask = 0u;
  tr.prev = -1;
  tr.cur = 1.f;
#pragma unroll
  for (int g = 0; g < RLEVELS; ++g) tr.st[g] = 1.f;
}

// Factor x at position j (ascending, 0..SR-1).
__device__ __forceinline__ void tree_push(RangeTree& tr, int j, float x) {
  if (tr.prev >= 0) {
    const int h = 31 - __clz(tr.prev ^ j);
#pragma unroll
    for (int g = 0; g < RLEVELS; ++g)
      if (g < h && ((tr.mask >> g) & 1u)) tr.cur = tr.st[g] * tr.cur;
#pragma unroll
    for (int g = 0; g < RLEVELS; ++g)
      if (g == h) tr.st[g] = tr.cur;
    tr.mask = (tr.mask & ~((1u << h) - 1u)) | (1u << h);
  }
  tr.cur = x;
  tr.prev = j;
}

// The range's product (1 without a non-1 factor).
__device__ __forceinline__ float tree_close(const RangeTree& tr) {
  float p = tr.cur;
#pragma unroll
  for (int g = 0; g < RLEVELS; ++g)
    if ((tr.mask >> g) & 1u) p = tr.st[g] * p;
  return p;
}

// The filtered occlusion walk of kernels 2.4 and 2.8 (stream_walk.cuh).
// One ray a lane: the range tree takes the second ray's registers.
template <int D>
__global__ void __launch_bounds__(RB, STREAM_BLOCKS) occluded_t_stream_kernel(
    const float* __restrict__ oT, const float* __restrict__ dT,
    const int* __restrict__ skip, const float* __restrict__ ldist,
    const int* __restrict__ order, int n_eff, const int* __restrict__ blive,
    const float* __restrict__ klo_t, const float* __restrict__ khi_t,
    int ncp, const float* __restrict__ gt, const float* __restrict__ ci,
    const int* __restrict__ ids, const float* __restrict__ opa, int pr, int R,
    unsigned char* __restrict__ out_blocked, float* __restrict__ out_filt,
    int* __restrict__ visits, float* __restrict__ emin_all, int n_slots) {
  constexpr int RPT = 1;
  constexpr int PER_TASK = GW * RPT;
  __shared__ int s_blk[RB];            // blocked flag of each ray
  __shared__ float s_filt[RB];         // light let through so far
  __shared__ float s_prod[NCAND][RB];  // each visit's product this group
  __shared__ int s_list[RB];           // the group's undecided rays

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
  const float ld = ldist[r];
  float* emin = emin_all + (size_t)blk * n_eff;
  s_blk[tid] = 0;
  s_filt[tid] = 1.f;
  for (int v = 0; v < NCAND; ++v) s_prod[v][tid] = 1.f;
  const int g = lane / SQ, q = lane % SQ;
  const int r0 = blk * RB;

  // one visit, one warp: tasks of PER_TASK listed rays, range q each,
  // drawn from the visit's counter; the visit's product of a ray goes to
  // s_prod[vis] and joins its filter at the group's boundary (fold), in
  // walk order
  auto test = [&](const Chunk& ch, int, int n_live, int* next,
                  int vis) {
    const int n_task = (n_live + PER_TASK - 1) / PER_TASK;
    for (;;) {
      int task = 0;
      if (lane == 0) task = atomicAdd(next, 1);
      task = __shfl_sync(0xffffffffu, task, 0);
      if (task >= n_task) break;
      float ro[RPT][D], rd[RPT][D], rl[RPT];
      int rr[RPT], rsk[RPT];
      bool live[RPT], hit[RPT];
      RangeTree tr[RPT];
#pragma unroll
      for (int c = 0; c < RPT; ++c) {
        const int li = task * PER_TASK + c * GW + g;
        rr[c] = li < n_live ? s_list[li] : 0;
        live[c] = li < n_live && !s_blk[rr[c]];
        hit[c] = false;
        tree_init(tr[c]);
#pragma unroll
        for (int k = 0; k < D; ++k) {
          ro[c][k] = oT[(size_t)k * R + r0 + rr[c]];
          rd[c][k] = dT[(size_t)k * R + r0 + rr[c]];
        }
        rl[c] = ldist[r0 + rr[c]];
        rsk[c] = skip[r0 + rr[c]];
      }
      for (int j = 0; j < SR; ++j) {
        bool want = false;
#pragma unroll
        for (int c = 0; c < RPT; ++c) want = want || (live[c] && !hit[c]);
        if (!__any_sync(0xffffffffu, want)) break;
        const int l = range_lane(q, j);
        const int id = ch.id[l];
        bool go[RPT];
        float t[RPT];
#pragma unroll
        for (int c = 0; c < RPT; ++c)
          go[c] = live[c] && !hit[c] && id != rsk[c];
        pair_test_warp<D, RPT, false, true>(ch, l, ro, rd, rl, go, t);
#pragma unroll
        for (int c = 0; c < RPT; ++c) {
          if (go[c]) {
            const float op = ch.opa[l];
            if (op >= 1.f)
              hit[c] = true;           // an opaque slot blocks the ray
            else
              tree_push(tr[c], j, 1.f - op);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < RPT; ++c) {
        // a ray blocked in any of its four ranges is blocked
        int h = hit[c];
        h |= __shfl_xor_sync(0xffffffffu, h, 1);
        h |= __shfl_xor_sync(0xffffffffu, h, 2);
        // the root of the visit's tree: (T_0 * T_1) * (T_2 * T_3)
        const float t_q = tree_close(tr[c]);
        const float pair = t_q * __shfl_xor_sync(0xffffffffu, t_q, 1);
        const float prod = pair * __shfl_xor_sync(0xffffffffu, pair, 2);
        if (q == 0 && live[c]) {
          if (h)
            s_blk[rr[c]] = 1;
          else
            s_prod[vis][rr[c]] = prod;
        }
      }
    }
  };

  // the group's visit products into the ray's filter, in walk order (a
  // visit that did not test the ray left 1: 1 * y = y)
  auto fold = [&] {
    float f = s_filt[tid];
    for (int v = 0; v < NCAND; ++v) {
      f = f * s_prod[v][tid];
      s_prod[v][tid] = 1.f;
    }
    s_filt[tid] = f;
  };
  auto state = [&] {
    const bool b = s_blk[tid] != 0;
    return RayState{b ? 0.f : ld, !b && ld > 0.f};
  };
  const int nvis = stream_walk<D, true>(
      o, dv, inv, klo_t, khi_t, ncp, gt, ci, ids, opa, pr, order, n_eff,
      emin, n_slots, s_list, state, test, fold);
  const bool blocked = s_blk[tid] != 0;
  out_blocked[r] = blocked ? 1 : 0;
  out_filt[r] = blocked ? 1.f : s_filt[tid];
  if (tid == 0) visits[blk] = nvis;
}

int launch_stream_d(const float* oT, const float* dT, const int* skip,
                    const float* ldist, const int* order, int n_eff,
                    const int* blive, const float* klo_t, const float* khi_t,
                    int ncp, const float* gt, const float* ci, const int* ids,
                    const float* opa, int pr, int R, int d,
                    unsigned char* blocked, float* filt, int* visits,
                    float* emin, void* stream) {
  const int grid = R / RB;
  if (R % RB || grid == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int n_slots = 0, smem = 0;
#define NTR_CASE(DD)                                                         \
  case DD: {                                                                 \
    auto kernel = occluded_t_stream_kernel<DD>;                              \
    const cudaError_t err =                                                  \
        stream_ring_config<DD, true>(kernel, &n_slots, &smem);               \
    if (err != cudaSuccess) return (int)err;                                 \
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

// Launch the filtered occlusion walk (kernels 2.4 and 2.8: a pool of any
// size) on `stream`.  Arguments as ntr_occluded, plus opa (nc, 8, 128) f32
// (row 0 = the slots' opacities) and filt (R,) f32; gt, ci, ids and opa
// must be 16-byte aligned.  Returns cudaGetLastError() after the launch.
int ntr_occluded_t(const float* oT, const float* dT, const int* skip,
                   const float* ldist, const int* order, int n_eff,
                   const int* blive, const float* klo_t, const float* khi_t,
                   int ncp, const float* gt, const float* ci, const int* ids,
                   const float* opa, int pr, int R, int d,
                   unsigned char* blocked, float* filt, int* visits,
                   float* emin, void* stream) {
  return launch_stream_d(oT, dT, skip, ldist, order, n_eff, blive, klo_t,
                         khi_t, ncp, gt, ci, ids, opa, pr, R, d, blocked,
                         filt, visits, emin, stream);
}

// Kernels 2.4 and 2.8 at dimension d as they launch: info as
// ntr_occluded_info.
int ntr_occluded_t_info(int d, int* info) {
#define NTR_CASE(DD)                                                         \
  case DD:                                                                   \
    return (int)stream_kernel_info<DD, true>(occluded_t_stream_kernel<DD>,    \
                                           info);
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
}

}  // extern "C"
