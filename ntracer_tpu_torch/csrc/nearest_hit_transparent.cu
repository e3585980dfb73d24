// Front-to-back walk over a chunked triangle pool with transparent slots,
// for Hopper (sm_90a): the nearest opaque hit of each ray and its K nearest
// transparent hits.
//
// Replaces two TPU kernels of ntracer_tpu/engine/resident_kernels.py with
// one body, `nearest_t_stream_kernel<D, SHARED, N>`:
// `nearest_hit_transparent` (kernel 2.3, pallas_call body
// `_nearest_t_kernel` -> `_nearest_t_live`), the walk of pools under the
// line, launched with N = 1, and `nearest_hit_transparent_hbm` (kernel
// 2.7, body `_nearest_t_hbm_kernel` -> `_nearest_t_hbm_live`), the walk of
// pools over it, launched with N = NCAND = 4.  The plain PyTorch twins are
// `nearest_hit_transparent_ref` and `nearest_hit_transparent_hbm_ref` in
// ntracer_tpu_torch/engine/resident_kernels.py; kernel and twin agree bit
// for bit on t, the winning slot, every one of the K slots position by
// position, and the visit counts.
//
// What it computes.  One CUDA block walks one 512-ray block.  The walk
// picks groups of N candidate chunks (the next positions whose entry
// minimum is below the block's largest best t), each next group with the
// bound from before the current one.  The two TPU kernels differ in N:
// 2.3 takes ONE candidate a step, so visit k + 1 is picked with the bound
// after visit k - 1, while 2.7 takes groups of four.  A stale bound visits
// more chunks, whose far glass hits take slots and move the slot of later
// near hits, and the stable sort downstream composes exactly tied surfaces
// in slot order: so each entry keeps its TPU kernel's N, and 2.7 agrees
// with 2.3 on t and the opaque slot only.  In a visit each ray is tested
// against the chunk's 128 slots in lane order.  Opaque slots (opacity >= 1)
// compete for the nearest hit: strict <, lowest lane on a tie.
// Transparent hits go into the chunk's list kept sorted by t (a later lane
// goes behind an equal t), which holds its 8 nearest; its first K entries
// are then offered in turn to the ray's K slots, each replacing the FIRST
// largest slot if it is nearer (all slots start at +inf, so slot 0 fills
// first).  Slots are not trimmed by the opaque hit here; the trace's
// finish does that.
//
// What bounds it.  Pair-test arithmetic: a visit is 512 x 128 pair tests
// of d*d multiply-adds and one IEEE division; the list insertion and the
// K*K slot scan are a few compares beside them, on the rare held pairs.
// The design is stream_walk.cuh's loop (TMA ring, compacted live rays,
// four slot ranges a ray, the straight-line pair test with a cut, per-warp
// slot release, the staged entry pass).  A ray's state -- best, its slot,
// the K slots and their largest -- lives in shared memory and is updated
// in place by the warp that tests the ray: the K slots' rule depends on
// the order of the offers, and the chunk lists of a group's visits would
// not fit beside the ring (512 x 4 x 8 x 8 B = 128 KiB).  A nearest walk
// never decides a ray, so the live set is fixed for the whole walk.  With
// N = 1 a block-wide group boundary separates any two visits of a ray, so
// a visit's tasks are drawn from a counter by whichever warp is free; with
// N = 4 they are dealt statically (warp w takes tasks w, w + 16, ...), so
// a ray's visits of a group run in walk order in one lane group.  The ring
// of N = 1 holds two slots (the chunk under test and the next one, the
// only one the walk knows), so the next chunk's copy runs during a visit's
// tests, and its group boundaries only reduce the bound (the live set
// holds).  What keeps it exact:
//   * the cuts.  An opaque pair matters only below the ray's best, a glass
//     pair only below the largest of its K slots: both only fall, every
//     update is strict <, and the chunk's glass list is offered nearest
//     first, so an entry at or beyond the largest slot is never taken, nor
//     is anything behind it;
//   * the order.  A range marks its slots that hold below their cut in one
//     bit mask; only where a warp holds one (rare: a ray meets a surface
//     in few of its visits; scripts/ring_wait_probe.py counts the cycles
//     of this path) do the ray's first lane gather its four masks and the
//     warp retest the held slots in lane order (pair_test_warp again, so t
//     is the same): opaque ones for the first lane of the minimum (strict
//     <), glass ones inserted behind every entry <= t (a later lane sorts
//     behind an equal t), and the chunk's nearest K are offered to the
//     slots.
//
// Build: nvcc --fmad=false, IEEE division (see engine/_build.py).

#include "stream_walk.cuh"

namespace {

using namespace ntr;

constexpr int KMAX = 8;          // transparent slots a ray can hold

// Blocks an SM of kernels 2.3 and 2.7: two (64 registers a thread) while
// the ring's two slots fit beside the K slots' 32 KiB; at d = 8 they do
// not, so one block holds its ring and the registers that two blocks would
// share.
template <int D>
__host__ __device__ constexpr int t_stream_blocks() {
  return D <= 7 ? STREAM_BLOCKS : 1;
}

// Kernels 2.3 (N = 1) and 2.7 (N = NCAND): the streaming K-slot walk
// (stream_walk.cuh) in groups of N candidates.
template <int D, bool SHARED, int N>
__global__ void __launch_bounds__(RB, t_stream_blocks<D>())
    nearest_t_stream_kernel(
    const float* __restrict__ oT, const float* __restrict__ dT,
    const int* __restrict__ skip, const float* __restrict__ init_t,
    const int* __restrict__ order, int n_eff, const int* __restrict__ blive,
    const float* __restrict__ klo_t, const float* __restrict__ khi_t,
    int ncp, const float* __restrict__ gt, const float* __restrict__ ci,
    const int* __restrict__ ids, const float* __restrict__ opa, int pr, int R,
    int K, float* __restrict__ out_t, int* __restrict__ out_slot,
    float* __restrict__ out_tt, int* __restrict__ out_tslot,
    int* __restrict__ visits, float* __restrict__ emin_all, int n_slots) {
  constexpr int RPT = rays_a_lane<D>();
  constexpr int PER_TASK = GW * RPT;
  __shared__ float s_best[RB];         // each ray's nearest opaque hit
  __shared__ int s_bid[RB];            // and its slot id
  __shared__ float s_tt[KMAX][RB];     // the K slots; -inf beyond K
  __shared__ int s_ts[KMAX][RB];
  __shared__ float s_tmax[RB];         // the largest of the K slots
  __shared__ int s_list[RB];           // the walk's live rays

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.x;
  const int r = blk * RB + tid;
  const float it = init_t[r];
  if (!blive[blk]) {                   // every ray of the block is dead
    out_t[r] = it;
    out_slot[r] = -1;
    for (int k = 0; k < K; ++k) {
      out_tt[(size_t)k * R + r] = INFINITY;
      out_tslot[(size_t)k * R + r] = -1;
    }
    if (tid == 0) visits[blk] = 0;
    return;
  }

  float o[D], dv[D], inv[D];
  load_ray<D>(oT, dT, R, r, o, dv, inv);
  float* emin = emin_all + (size_t)blk * n_eff;
  s_best[tid] = it;
  s_bid[tid] = -1;
  for (int i = 0; i < KMAX; ++i) {
    s_tt[i][tid] = i < K ? INFINITY : -INFINITY;
    s_ts[i][tid] = -1;
  }
  s_tmax[tid] = INFINITY;
  // a ray with a coordinate that is not finite hits nothing (the shared
  // rows stand for the origin of primary rays): every other ray of a live
  // block collects glass hits, whatever its best
  const bool can_hit = finite_ray<D>(dv) && (SHARED || finite_ray<D>(o));
  const int g = lane / SQ, q = lane % SQ;
  const int r0 = blk * RB;

  // a warp's next task of a visit: in groups of one, drawn from the
  // visit's counter (a block-wide boundary separates any two visits of a
  // ray, so whichever warp takes its task updates its state in walk
  // order); in groups of NCAND, dealt statically (warp, warp + NW, ...: the
  // live set is fixed, so a ray's visits of a group run in walk order in
  // one lane group)
  auto take = [&](int* next, int prev) {
    if constexpr (N > 1) {
      return prev < 0 ? warp : prev + NW;
    } else {
      int task = 0;
      if (lane == 0) task = atomicAdd(next, 1);
      return __shfl_sync(FULL, task, 0);
    }
  };

  // one visit, one warp: tasks of PER_TASK listed rays, range q each
  // (lanes q, q + 4, ...)
  auto test = [&](const Chunk& ch, int idx, int n_live, int* next, int) {
    const int n_task = (n_live + PER_TASK - 1) / PER_TASK;
    for (int task = take(next, -1); task < n_task;
         task = take(next, task)) {
      // cb: best, cg: the largest K slot, both as the visit starts
      float ro[RPT][D], rd[RPT][D], cb[RPT], cg[RPT];
      int rr[RPT], rsk[RPT];
      unsigned hm[RPT];                // bit j: slot 4j + q holds below its
      bool live[RPT];                  // cut (opaque: cb, glass: cg)
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
        cb[c] = s_best[rr[c]];
        cg[c] = s_tmax[rr[c]];
        hm[c] = 0u;
      }
      for (int j = 0; j < SR; ++j) {
        const int l = SQ * j + q;
        const int id = ch.id[l];
        const bool opq = ch.opa[l] >= 1.f;
        bool go[RPT];
        float t[RPT], cut[RPT];
#pragma unroll
        for (int c = 0; c < RPT; ++c) {
          go[c] = live[c] && id != rsk[c];
          cut[c] = opq ? cb[c] : cg[c];
        }
        pair_test_warp<D, RPT, SHARED, !SHARED>(ch, l, ro, rd, cut, go, t);
#pragma unroll
        for (int c = 0; c < RPT; ++c) hm[c] |= go[c] ? 1u << j : 0u;
      }
      bool held = false;
#pragma unroll
      for (int c = 0; c < RPT; ++c) held = held || hm[c];
      if (!__any_sync(FULL, held)) continue;
      // A pair held (rare: a ray meets a surface a few times in hundreds
      // of visits).  The ray's first lane gathers its four ranges' masks
      // (slot 4j + p is bit j of range p's) and the warp retests the held
      // slots in lane order, the lowest first (pair_test_warp again, so t
      // is the same): opaque ones for the first lane of the minimum,
      // glass ones into the chunk's list, each behind every entry <= t.
      unsigned m[RPT][SQ];
#pragma unroll
      for (int c = 0; c < RPT; ++c)
#pragma unroll
        for (int p = 0; p < SQ; ++p) {
          m[c][p] = __shfl_sync(FULL, hm[c], (lane & ~(SQ - 1)) | p);
          if (q != 0) m[c][p] = 0u;
        }
      float bt[RPT];                   // the chunk's nearest opaque hit
      int bl[RPT];
      float ct[RPT][KMAX];             // the chunk's nearest glass hits,
      int cl[RPT][KMAX];               // ascending, and their lanes
#pragma unroll
      for (int c = 0; c < RPT; ++c) {
        bt[c] = INFINITY;
        bl[c] = CK;
#pragma unroll
        for (int i = 0; i < KMAX; ++i) {
          ct[c][i] = INFINITY;
          cl[c][i] = 0;
        }
      }
      for (;;) {
        unsigned mine = CK;
#pragma unroll
        for (int c = 0; c < RPT; ++c)
#pragma unroll
          for (int p = 0; p < SQ; ++p)
            if (m[c][p])
              mine = min(mine, (unsigned)(SQ * (__ffs(m[c][p]) - 1) + p));
        const int l = (int)__reduce_min_sync(FULL, mine);
        if (l >= CK) break;
        const bool opq = ch.opa[l] >= 1.f;
        bool go[RPT];
        float t[RPT], cut[RPT];
#pragma unroll
        for (int c = 0; c < RPT; ++c) {
          go[c] = false;
#pragma unroll
          for (int p = 0; p < SQ; ++p) {
            if (p == l % SQ) {
              go[c] = (m[c][p] >> (l / SQ)) & 1u;
              m[c][p] &= ~(1u << (l / SQ));
            }
          }
          cut[c] = opq ? cb[c] : cg[c];
        }
        pair_test_warp<D, RPT, SHARED, !SHARED>(ch, l, ro, rd, cut, go, t);
#pragma unroll
        for (int c = 0; c < RPT; ++c) {
          if (go[c] && opq && t[c] < bt[c]) {
            bt[c] = t[c];
            bl[c] = l;
          }
          if (go[c] && !opq) {
            // insert behind every entry <= t; the last entry falls off
            float x = t[c];
            int xl = l;
            bool moved = false;
#pragma unroll
            for (int i = 0; i < KMAX; ++i) {
              if (moved || x < ct[c][i]) {
                const float ft = ct[c][i];
                const int fl = cl[c][i];
                ct[c][i] = x;
                cl[c][i] = xl;
                x = ft;
                xl = fl;
                moved = true;
              }
            }
          }
        }
      }
#pragma unroll
      for (int c = 0; c < RPT; ++c) {
        if (q != 0 || !live[c]) continue;
        const int ray = rr[c];
        if (bl[c] < CK) {              // below best: the cut saw to it
          s_best[ray] = bt[c];
          s_bid[ray] = idx * CK + bl[c];
        }
        // offer the chunk's K nearest glass hits to the slots, nearest
        // first, each replacing the FIRST largest slot when it is nearer
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          if (j < K && ct[c][j] < INFINITY) {
            float bmax = s_tt[0][ray];
            int barg = 0;
            for (int i = 1; i < KMAX; ++i) {
              const float v = s_tt[i][ray];
              if (v > bmax) {
                bmax = v;
                barg = i;
              }
            }
            if (ct[c][j] < bmax) {
              s_tt[barg][ray] = ct[c][j];
              s_ts[barg][ray] = idx * CK + cl[c][j];
            }
          }
        }
        float mx = s_tt[0][ray];
        for (int i = 1; i < KMAX; ++i) mx = fmaxf(mx, s_tt[i][ray]);
        s_tmax[ray] = mx;
      }
    }
  };

  // the bound is the block's largest best; every ray that can hit anything
  // is live (glass is collected whatever the ray's best)
  auto state = [&] { return RayState{s_best[tid], can_hit}; };

  const int nvis = stream_walk<D, true, N>(
      o, dv, inv, klo_t, khi_t, ncp, gt, ci, ids, opa, pr, order, n_eff,
      emin, n_slots, s_list, state, test, [] {});
  out_t[r] = s_best[tid];
  out_slot[r] = s_bid[tid];
  for (int i = 0; i < K; ++i) {
    out_tt[(size_t)i * R + r] = s_tt[i][tid];
    out_tslot[(size_t)i * R + r] = s_ts[i][tid];
  }
  if (tid == 0) visits[blk] = nvis;
}

template <int D, bool SHARED, int N>
int launch_stream(int grid, cudaStream_t s, const float* oT, const float* dT,
                  const int* skip, const float* init_t, const int* order,
                  int n_eff, const int* blive, const float* klo_t,
                  const float* khi_t, int ncp, const float* gt,
                  const float* ci, const int* ids, const float* opa, int pr,
                  int R, int K, float* out_t, int* out_slot, float* out_tt,
                  int* out_tslot, int* visits, float* emin) {
  auto kernel = nearest_t_stream_kernel<D, SHARED, N>;
  int n_slots = 0, smem = 0;
  const cudaError_t err =
      stream_ring_config<D, true, N>(kernel, &n_slots, &smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, RB, smem, s>>>(oT, dT, skip, init_t, order, n_eff, blive,
                                klo_t, khi_t, ncp, gt, ci, ids, opa, pr, R, K,
                                out_t, out_slot, out_tt, out_tslot, visits,
                                emin, n_slots);
  return (int)cudaGetLastError();
}

template <int N>
int launch_d(const float* oT, const float* dT, const int* skip,
             const float* init_t, const int* order, int n_eff,
             const int* blive, const float* klo_t, const float* khi_t,
             int ncp, const float* gt, const float* ci, const int* ids,
             const float* opa, int pr, int R, int d, int shared, int K,
             float* out_t, int* out_slot, float* out_tt, int* out_tslot,
             int* visits, float* emin, void* stream) {
  const int grid = R / RB;
  if (R % RB || grid == 0 || K < 1 || K > KMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define NTR_LAUNCH(DD, SH)                                                   \
  launch_stream<DD, SH, N>(grid, s, oT, dT, skip, init_t, order, n_eff,      \
                           blive, klo_t, khi_t, ncp, gt, ci, ids, opa, pr,   \
                           R, K, out_t, out_slot, out_tt, out_tslot, visits, \
                           emin)
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

// The walk in groups of N at dimension d (shared: the primary rays'
// variant) as it launches: info as ntr_nearest_hit_info.
template <int N>
int info_d(int d, int shared, int* info) {
#define NTR_CASE(DD)                                                         \
  case DD:                                                                   \
    return (int)(shared ? stream_kernel_info<DD, true, N>(                   \
                              nearest_t_stream_kernel<DD, true, N>, info)    \
                        : stream_kernel_info<DD, true, N>(                   \
                              nearest_t_stream_kernel<DD, false, N>, info));
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

}  // namespace

extern "C" {

// Launch the transparent walk (kernel 2.3, one candidate a step) on
// `stream`.  Arguments as ntr_nearest_hit, plus opa (nc, 8, 128) f32 (row
// 0 = the slots' opacities; 16-byte aligned like gt, ci and ids) and K in
// 1..8; out_tt / out_tslot are (K, R), lane-major.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a K the
// kernel cannot hold.
int ntr_nearest_t(const float* oT, const float* dT, const int* skip,
                  const float* init_t, const int* order, int n_eff,
                  const int* blive, const float* klo_t, const float* khi_t,
                  int ncp, const float* gt, const float* ci, const int* ids,
                  const float* opa, int pr, int R, int d, int shared, int K,
                  float* out_t, int* out_slot, float* out_tt, int* out_tslot,
                  int* visits, float* emin, void* stream) {
  return launch_d<1>(oT, dT, skip, init_t, order, n_eff, blive, klo_t, khi_t,
                     ncp, gt, ci, ids, opa, pr, R, d, shared, K, out_t,
                     out_slot, out_tt, out_tslot, visits, emin, stream);
}

// The walk for a pool over the line (kernel 2.7, groups of four):
// arguments and outputs as ntr_nearest_t.
int ntr_nearest_t_hbm(const float* oT, const float* dT, const int* skip,
                      const float* init_t, const int* order, int n_eff,
                      const int* blive, const float* klo_t,
                      const float* khi_t, int ncp, const float* gt,
                      const float* ci, const int* ids, const float* opa,
                      int pr, int R, int d, int shared, int K, float* out_t,
                      int* out_slot, float* out_tt, int* out_tslot,
                      int* visits, float* emin, void* stream) {
  return launch_d<NCAND>(oT, dT, skip, init_t, order, n_eff, blive, klo_t,
                         khi_t, ncp, gt, ci, ids, opa, pr, R, d, shared, K,
                         out_t, out_slot, out_tt, out_tslot, visits, emin,
                         stream);
}

// Kernel 2.3 at dimension d (shared: the primary rays' variant) as it
// launches: info as ntr_nearest_hit_info.
int ntr_nearest_t_info(int d, int shared, int* info) {
  return info_d<1>(d, shared, info);
}

// Kernel 2.7 likewise.
int ntr_nearest_t_hbm_info(int d, int shared, int* info) {
  return info_d<NCAND>(d, shared, info);
}

}  // extern "C"
