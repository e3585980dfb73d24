// Any-hit occlusion walk over a chunked triangle pool, for Hopper (sm_90a):
// is there an opaque hit with 0 < t < ldist along each shadow ray?
//
// Replaces two TPU kernels of ntracer_tpu/engine/resident_kernels.py with
// one body, `occluded_stream_kernel`: `occluded` (kernel 2.2, pallas_call
// body `_occlusion_kernel` -> `_occlusion_walk`, candidate scan
// `_candidate_walk`), the walk of pools under the line, and `occluded_hbm`
// (kernel 2.6, body `_occl_hbm_kernel` -> `_occl_hbm_live`), the walk of
// pools over it (resident_kernels.STREAM_POOL_BYTES).  One C entry,
// `ntr_occluded`, launches the body on a pool of any size; the plain
// PyTorch twin is `occluded_ref` in
// ntracer_tpu_torch/engine/resident_kernels.py, and kernel and twin agree
// on `blocked` and on `visits`, ray for ray and block for block.
//
// What it computes.  One CUDA block walks one 512-ray block; a ray with
// ldist <= 0 is inactive.  A block without an active ray writes blocked =
// 0, visits = 0 and returns.  Otherwise every ray's slab entry into every
// chunk's box is taken and the block keeps the minimum per chunk position
// (`emin`, global scratch), as the nearest-hit walk does.  The walk's bound
// is the largest ldist among the block's rays that are not blocked yet; it
// picks the next four positions with emin below the bound, with the bound
// from before the previous group's updates (the TPU kernel's grouped rule,
// so visit counts are the twin's), and visits them: each undecided ray is
// tested against the chunk's 128 slots until a valid hit with t < ldist.
// `blocked` is a monotone OR over visits, so the order in which a visit's
// rays are tested changes nothing.
//
// What bounds it.  Pair-test arithmetic: a visit is up to 512 x 128 tests
// of 2*d*d multiply-adds (shadow rays have their own origins, so the
// origin dots are not shared) and one IEEE division.  A pool under the
// line (20 KB a chunk at d = 6) sits in L2.  The design is stream_walk.cuh's
// loop, and spends nothing on decided rays: each visited chunk is copied
// into a ring of shared-memory slots by TMA while the previous one is
// tested, the undecided rays of a group are compacted, each ray's 128
// slots are split into four ranges of 32 on neighbouring lanes (any-hit is
// order-free: the ranges' hits are ORed with two shuffles), a lane holds
// rays_a_lane<D>() rays so one shared load serves several tests, the pair
// test is one straight line with warp-uniform skips (pair_test_warp), a
// visit's tasks are drawn by whichever warp is free, slots are released
// per warp through mbarriers, two blocks share an SM, the entry pass
// stages the chunk boxes in shared memory, and a dead block costs one load
// per ray.
//
// Build: nvcc --fmad=false, IEEE division (see engine/_build.py).

#include "stream_walk.cuh"

namespace {

using namespace ntr;

// Kernels 2.2 and 2.6: the streaming occlusion walk (stream_walk.cuh).
template <int D>
__global__ void __launch_bounds__(RB, STREAM_BLOCKS) occluded_stream_kernel(
    const float* __restrict__ oT, const float* __restrict__ dT,
    const int* __restrict__ skip, const float* __restrict__ ldist,
    const int* __restrict__ order, int n_eff, const int* __restrict__ blive,
    const float* __restrict__ klo_t, const float* __restrict__ khi_t,
    int ncp, const float* __restrict__ gt, const float* __restrict__ ci,
    const int* __restrict__ ids, int pr, int R,
    unsigned char* __restrict__ out_blocked, int* __restrict__ visits,
    float* __restrict__ emin_all, int n_slots) {
  constexpr int RPT = rays_a_lane<D>();
  constexpr int PER_TASK = GW * RPT;
  __shared__ int s_blk[RB];            // blocked flag of each ray
  __shared__ int s_list[RB];           // the group's undecided rays

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.x;
  const int r = blk * RB + tid;
  if (!blive[blk]) {                   // no ray of the block is active
    out_blocked[r] = 0;
    if (tid == 0) visits[blk] = 0;
    return;
  }

  float o[D], dv[D], inv[D];
  load_ray<D>(oT, dT, R, r, o, dv, inv);
  const float ld = ldist[r];
  float* emin = emin_all + (size_t)blk * n_eff;
  s_blk[tid] = 0;
  const int g = lane / SQ, q = lane % SQ;
  const int r0 = blk * RB;

  // one visit, one warp: tasks of PER_TASK listed rays, range q each,
  // drawn from the visit's counter (any-hit: a ray's visits are
  // order-free)
  auto test = [&](const Chunk& ch, int, int n_live, int* next, int) {
    const int n_task = (n_live + PER_TASK - 1) / PER_TASK;
    for (;;) {
      int task = 0;
      if (lane == 0) task = atomicAdd(next, 1);
      task = __shfl_sync(0xffffffffu, task, 0);
      if (task >= n_task) break;
      float ro[RPT][D], rd[RPT][D], rl[RPT];
      int rr[RPT], rsk[RPT];
      bool live[RPT], hit[RPT];
#pragma unroll
      for (int c = 0; c < RPT; ++c) {
        const int li = task * PER_TASK + c * GW + g;
        rr[c] = li < n_live ? s_list[li] : 0;
        live[c] = li < n_live && !s_blk[rr[c]];
        hit[c] = false;
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
        const int l = SQ * j + q;      // any-hit: order-free
        const int id = ch.id[l];
        bool go[RPT];
        float t[RPT];
#pragma unroll
        for (int c = 0; c < RPT; ++c)
          go[c] = live[c] && !hit[c] && id != rsk[c];
        pair_test_warp<D, RPT, false, true>(ch, l, ro, rd, rl, go, t);
#pragma unroll
        for (int c = 0; c < RPT; ++c) hit[c] = hit[c] || go[c];
      }
      // a ray blocked in any of its four ranges is blocked
#pragma unroll
      for (int c = 0; c < RPT; ++c) {
        int h = hit[c];
        h |= __shfl_xor_sync(0xffffffffu, h, 1);
        h |= __shfl_xor_sync(0xffffffffu, h, 2);
        if (q == 0 && live[c] && h) s_blk[rr[c]] = 1;
      }
    }
  };

  // the bound is the largest ldist of the rays not blocked yet; a ray is
  // live while it is undecided
  auto state = [&] {
    const bool b = s_blk[tid] != 0;
    return RayState{b ? 0.f : ld, !b && ld > 0.f};
  };
  const int nvis = stream_walk<D, false>(
      o, dv, inv, klo_t, khi_t, ncp, gt, ci, ids, nullptr, pr, order, n_eff,
      emin, n_slots, s_list, state, test, [] {});
  out_blocked[r] = s_blk[tid] ? 1 : 0;
  if (tid == 0) visits[blk] = nvis;
}

int launch_stream_d(const float* oT, const float* dT, const int* skip,
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
    auto kernel = occluded_stream_kernel<DD>;                                \
    const cudaError_t err =                                                  \
        stream_ring_config<DD, false>(kernel, &n_slots, &smem);              \
    if (err != cudaSuccess) return (int)err;                                 \
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

// Launch the occlusion walk (kernels 2.2 and 2.6: a pool of any size) on
// `stream`.  Rays are lane-major (d, R) with 3 <= d <= 8 and R a multiple
// of 512; ldist (R,), <= 0 for inactive rays; gt (nc, pr, 128), ci (nc, 8,
// 128), ids (nc, 8, 128) i32, all 16-byte aligned; klo_t/khi_t (8, ncp) in
// visit order; blocked (R,) bytes (0 or 1); emin scratch holds (R / 512) *
// n_eff floats.  Returns cudaGetLastError() after the launch.
int ntr_occluded(const float* oT, const float* dT, const int* skip,
                 const float* ldist, const int* order, int n_eff,
                 const int* blive, const float* klo_t, const float* khi_t,
                 int ncp, const float* gt, const float* ci, const int* ids,
                 int pr, int R, int d, unsigned char* blocked, int* visits,
                 float* emin, void* stream) {
  return launch_stream_d(oT, dT, skip, ldist, order, n_eff, blive, klo_t,
                         khi_t, ncp, gt, ci, ids, pr, R, d, blocked, visits,
                         emin, stream);
}

// Kernels 2.2 and 2.6 at dimension d as they launch: info[0..4] =
// registers a thread, local (spill) bytes a thread, blocks per SM, ring
// slots, shared bytes a block.
int ntr_occluded_info(int d, int* info) {
#define NTR_CASE(DD)                                                         \
  case DD:                                                                   \
    return (int)stream_kernel_info<DD, false>(occluded_stream_kernel<DD>,     \
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
