// Front-to-back nearest-hit walk over a chunked triangle pool, for Hopper
// (sm_90a).
//
// Replaces two TPU kernels of ntracer_tpu/engine/resident_kernels.py with
// one body, `nearest_stream_kernel`: `nearest_hit` (kernel 2.1, pallas_call
// body `_nearest_kernel` -> `_nearest_walk_live`, pair test
// `_chunk_hits_vals`, entry bounds `_entry_all`), the walk of pools under
// the line, and `nearest_hit_hbm` (kernel 2.5, body `_nearest_hbm_kernel`
// -> `_nearest_hbm_live`), the walk of pools over it
// (resident_kernels.STREAM_POOL_BYTES, 48 MiB: more than the H100's 50 MB
// L2 holds beside the rest).  One C entry, `ntr_nearest_hit`, launches the
// body on a pool of any size; the plain PyTorch twin is `nearest_hit_ref`
// in ntracer_tpu_torch/engine/resident_kernels.py, and kernel and twin
// agree bit for bit on t, the slot and the visits of each block.
//
// What it computes.  One CUDA block walks one 512-ray block (a 32x16-pixel
// tile).  First every ray's slab entry into every chunk's box (chunks in
// visit order) is taken, and the block keeps the minimum over its rays per
// chunk position (`emin`, in global scratch, so the pool has no
// chunk-count limit).  Then the walk picks the next four candidate
// positions (emin below the block's largest best t) with the bound from
// before the previous group's updates -- the TPU kernel's grouped rule, so
// both visit the same chunks -- and visits them: each ray is tested
// against the chunk's 128 slots, keeping the first lane of the minimum and
// updating its best on strict <.  A block without a live ray stores its
// outputs and returns.
//
// What bounds it.  Per-visit pair-test arithmetic: each visit is 512 x 128
// pair tests of d*d multiply-adds plus one IEEE division, each edge plane
// only for the pairs that reach it.  The flagship 120-cell frame makes
// ~9.6 visits per block over a pool of ~442 KB, which sits in L2; the mesh
// makes ~395 over 63 MiB.
//
// The design is stream_walk.cuh's loop: each visited chunk is copied into
// a ring of shared-memory slots by TMA bulk copies, the rays whose nearest
// hit can still fall (best > 0) are compacted at each group boundary, each
// ray's 128 slots are split into four ranges of 32 on neighbouring lanes,
// a lane holds rays_a_lane<D>() rays so one shared load serves several
// tests, the pair test is one straight line with warp-uniform skips and a
// cut at the ray's best (pair_test_warp), a visit's tasks are drawn by
// whichever warp is free, slots are released per warp, two blocks share an
// SM and the entry pass stages the chunk boxes in shared memory.  A pool
// under the line (27 chunks for the 4-D 120-cell) takes the same body: its
// chunks stay in the 50 MB L2, and the ring's copies come from there.
// What keeps it exact:
//   * the cut.  best only falls and the update is strict <, so a pair with
//     t >= the ray's best at the group boundary never wins; a range also
//     cuts at its own nearest hit so far (a later lane wins no tie);
//   * the merge.  The sequential rule -- per visit the lowest lane of the
//     chunk's minimum, taken when strictly below best -- ends at the
//     lexicographic minimum of (t, visit, lane) over the group's pairs
//     below the boundary's best.  The four ranges' minima of (t, lane) are
//     merged by two shuffles, and each visit's is folded into one 64-bit
//     key a ray (t's bits, then the visit, then the lane: t > 0, so its
//     bits order as the floats) by a shared-memory atomicMin, whatever
//     order the visits' tasks run in; the group boundary turns the key into
//     best and the slot.
//
// Build: nvcc --fmad=false, IEEE division (see engine/_build.py).  No a*b+c
// is contracted, so every operation rounds as in the twin.

#include "stream_walk.cuh"

namespace {

using namespace ntr;

constexpr unsigned long long NO_KEY = ~0ull;

// Kernels 2.1 and 2.5: the streaming nearest-hit walk (stream_walk.cuh).
template <int D, bool SHARED>
__global__ void __launch_bounds__(RB, STREAM_BLOCKS) nearest_stream_kernel(
    const float* __restrict__ oT, const float* __restrict__ dT,
    const int* __restrict__ skip, const float* __restrict__ init_t,
    const int* __restrict__ order, int n_eff, const int* __restrict__ blive,
    const float* __restrict__ klo_t, const float* __restrict__ khi_t,
    int ncp, const float* __restrict__ gt, const float* __restrict__ ci,
    const int* __restrict__ ids, int pr, int R, float* __restrict__ out_t,
    int* __restrict__ out_slot, int* __restrict__ visits,
    float* __restrict__ emin_all, int n_slots) {
  constexpr int RPT = rays_a_lane<D>();
  constexpr int PER_TASK = GW * RPT;
  __shared__ float s_best[RB];         // each ray's nearest hit so far
  __shared__ int s_bid[RB];            // and its slot id
  __shared__ unsigned long long s_key[RB];   // the group's best (t, visit,
                                             // lane), NO_KEY if none
  __shared__ int s_list[RB];           // the group's live rays
  __shared__ int s_vidx[NCAND];        // pool chunk of each visit

  const int tid = threadIdx.x, lane = tid & 31;
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
  float* emin = emin_all + (size_t)blk * n_eff;
  s_best[tid] = it;
  s_bid[tid] = -1;
  s_key[tid] = NO_KEY;
  const int g = lane / SQ, q = lane % SQ;
  const int r0 = blk * RB;

  // one visit, one warp: tasks of PER_TASK listed rays, range q each
  // (lanes q, q + 4, ...), drawn from the visit's counter
  auto test = [&](const Chunk& ch, int idx, int n_live, int* next, int vis) {
    if (tid == 0) s_vidx[vis] = idx;
    const int n_task = (n_live + PER_TASK - 1) / PER_TASK;
    for (;;) {
      int task = 0;
      if (lane == 0) task = atomicAdd(next, 1);
      task = __shfl_sync(FULL, task, 0);
      if (task >= n_task) break;
      // cut: best at the group boundary, then the range's nearest hit so
      // far (held in cut once bl names its lane)
      float ro[RPT][D], rd[RPT][D], cut[RPT];
      int rr[RPT], rsk[RPT], bl[RPT];
      bool live[RPT];
#pragma unroll
      for (int c = 0; c < RPT; ++c) {
        const int li = task * PER_TASK + c * GW + g;
        live[c] = li < n_live;
        rr[c] = live[c] ? s_list[li] : 0;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          if (!SHARED) ro[c][k] = oT[(size_t)k * R + r0 + rr[c]];
          rd[c][k] = dT[(size_t)k * R + r0 + rr[c]];
        }
        rsk[c] = skip[r0 + rr[c]];
        cut[c] = s_best[rr[c]];
        bl[c] = CK;
      }
      for (int j = 0; j < SR; ++j) {
        const int l = SQ * j + q;
        const int id = ch.id[l];
        bool go[RPT];
        float t[RPT];
#pragma unroll
        for (int c = 0; c < RPT; ++c) go[c] = live[c] && id != rsk[c];
        pair_test_warp<D, RPT, SHARED, !SHARED>(ch, l, ro, rd, cut, go, t);
#pragma unroll
        for (int c = 0; c < RPT; ++c) {
          if (go[c]) {                 // t < the range's nearest so far
            cut[c] = t[c];
            bl[c] = l;
          }
        }
      }
#pragma unroll
      for (int c = 0; c < RPT; ++c) {
        float bt = bl[c] < CK ? cut[c] : INFINITY;
        ray_min(bt, bl[c]);
        if (q == 0 && bl[c] < CK)
          atomicMin(&s_key[rr[c]],
                    ((unsigned long long)__float_as_uint(bt) << 32) |
                        (unsigned)(vis << 8 | bl[c]));
      }
    }
  };

  // the group's nearest hit below best, if any, becomes the ray's best
  auto fold = [&] {
    const unsigned long long key = s_key[tid];
    if (key != NO_KEY) {
      s_best[tid] = __uint_as_float((unsigned)(key >> 32));
      s_bid[tid] = s_vidx[(key >> 8) & 0xff] * CK + (int)(key & 0xff);
      s_key[tid] = NO_KEY;
    }
  };
  // the bound is the block's largest best; a ray is live while a hit can
  // still lower its best (best > 0, so not NaN)
  auto state = [&] {
    const float b = s_best[tid];
    return RayState{b, b > 0.f};
  };

  const int nvis = stream_walk<D, false>(
      o, dv, inv, klo_t, khi_t, ncp, gt, ci, ids, nullptr, pr, order, n_eff,
      emin, n_slots, s_list, state, test, fold);
  out_t[r] = s_best[tid];
  out_slot[r] = s_bid[tid];
  if (tid == 0) visits[blk] = nvis;
}

template <int D, bool SHARED>
int launch_stream(int grid, cudaStream_t s, const float* oT, const float* dT,
                  const int* skip, const float* init_t, const int* order,
                  int n_eff, const int* blive, const float* klo_t,
                  const float* khi_t, int ncp, const float* gt,
                  const float* ci, const int* ids, int pr, int R,
                  float* out_t, int* out_slot, int* visits, float* emin) {
  auto kernel = nearest_stream_kernel<D, SHARED>;
  int n_slots = 0, smem = 0;
  const cudaError_t err =
      stream_ring_config<D, false>(kernel, &n_slots, &smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, RB, smem, s>>>(oT, dT, skip, init_t, order, n_eff, blive,
                                klo_t, khi_t, ncp, gt, ci, ids, pr, R, out_t,
                                out_slot, visits, emin, n_slots);
  return (int)cudaGetLastError();
}

int launch_stream_d(const float* oT, const float* dT, const int* skip,
                    const float* init_t, const int* order, int n_eff,
                    const int* blive, const float* klo_t, const float* khi_t,
                    int ncp, const float* gt, const float* ci, const int* ids,
                    int pr, int R, int d, int shared, float* out_t,
                    int* out_slot, int* visits, float* emin, void* stream) {
  const int grid = R / RB;
  if (R % RB || grid == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define NTR_LAUNCH(DD, SH)                                                   \
  launch_stream<DD, SH>(grid, s, oT, dT, skip, init_t, order, n_eff, blive,  \
                        klo_t, khi_t, ncp, gt, ci, ids, pr, R, out_t,        \
                        out_slot, visits, emin)
#define NTR_CASE(DD)                                                         \
  case DD:                                                                   \
    return shared ? NTR_LAUNCH(DD, true) : NTR_LAUNCH(DD, false);
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
#undef NTR_LAUNCH
}

}  // namespace

extern "C" {

// Launch the walk (kernels 2.1 and 2.5: a pool of any size) on `stream`.
// Rays are lane-major (d, R) with 3 <= d <= 8 and R a multiple of 512; gt
// (nc, pr, 128), ci (nc, 8, 128), ids (nc, 8, 128) i32, all 16-byte
// aligned; klo_t/khi_t (8, ncp) in visit order; emin scratch holds
// (R / 512) * n_eff floats.  Returns cudaGetLastError() after the launch.
int ntr_nearest_hit(const float* oT, const float* dT, const int* skip,
                    const float* init_t, const int* order, int n_eff,
                    const int* blive, const float* klo_t, const float* khi_t,
                    int ncp, const float* gt, const float* ci, const int* ids,
                    int pr, int R, int d, int shared, float* out_t,
                    int* out_slot, int* visits, float* emin, void* stream) {
  return launch_stream_d(oT, dT, skip, init_t, order, n_eff, blive, klo_t,
                         khi_t, ncp, gt, ci, ids, pr, R, d, shared, out_t,
                         out_slot, visits, emin, stream);
}

// Kernels 2.1 and 2.5 at dimension d (shared: the primary rays' variant)
// as they launch: info[0..4] = registers a thread, local (spill) bytes a
// thread, blocks per SM, ring slots, shared bytes a block.
int ntr_nearest_hit_info(int d, int shared, int* info) {
#define NTR_CASE(DD)                                                         \
  case DD:                                                                   \
    return (int)(shared ? stream_kernel_info<DD, false>(                     \
                              nearest_stream_kernel<DD, true>, info)         \
                        : stream_kernel_info<DD, false>(                     \
                              nearest_stream_kernel<DD, false>, info));
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

const char* ntr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
