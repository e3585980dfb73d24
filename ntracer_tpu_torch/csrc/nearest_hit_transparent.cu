// Front-to-back walk over a chunked triangle pool with transparent slots,
// for Hopper (sm_90a): the nearest opaque hit of each ray and its K nearest
// transparent hits.
//
// Replaces the TPU kernel ntracer_tpu/engine/resident_kernels.py
// `nearest_hit_transparent` (pallas_call body `_nearest_t_kernel` ->
// `_nearest_t_live`).  Its plain PyTorch twin is
// `nearest_hit_transparent_ref` in
// ntracer_tpu_torch/engine/resident_kernels.py; the two agree bit for bit on
// t, the winning slot, every one of the K slots position by position, and
// the visit counts.  The entry pass, the candidate scan, chunk staging and
// the pair test are pair_test.cuh's, shared with the other walks.
//
// What it computes.  One CUDA block walks one 512-ray block, one thread per
// ray.  The walk picks ONE candidate chunk a step (the next position whose
// entry minimum is below the block's largest best t), and picks the next
// one before it visits the current one, so the bound is the one from before
// this visit -- the TPU kernel's rule.  The grouped rule of the opaque walks
// is not used here: a different visit set would interleave far hits into
// the slots and permute which slot a later near hit lands in, and the
// stable sort downstream composes exactly tied surfaces in slot order.
// A visit stages the chunk (plane rows, offset rows, id row, opacity row) in
// shared memory; each thread tests its ray against the 128 slots in lane
// order.  Opaque slots (opacity >= 1) compete for the nearest hit: strict <,
// lowest lane on a tie.  Transparent hits go into a per-visit list kept
// sorted by t (a later lane goes behind an equal t), which holds the chunk's
// 8 nearest; after the lane loop its first K entries are offered in turn to
// the ray's K slots, each replacing the FIRST largest slot if it is nearer
// (all slots start at +inf, so slot 0 fills first).  Slots are not trimmed
// by the opaque hit here; the trace's finish does that.
//
// What bounds it.  Pair-test arithmetic, as for the opaque walk: a visit is
// 512 x 128 pair tests of d*d multiply-adds and one IEEE division; the list
// insertion and the K*K slot scan are a few compares beside them.  Slots and
// list live in registers (every loop over them is unrolled with constant
// indices; K is a run-time count up to KMAX, unused slots hold -inf so they
// are never the largest), so one instantiation serves every K.  One
// candidate a step costs two block syncs more per visit than the grouped
// walk; a dead block costs one load and K + 2 stores per ray.
//
// STREAM: kernel 2.7, which replaces `nearest_hit_transparent_hbm`
// (pallas_call body `_nearest_t_hbm_kernel` -> `_nearest_t_hbm_live`) for
// pools over the line.  The TPU kernel walks there in groups of four, the
// next group picked with the bound from before the current one, and so
// does this variant (chunk_ring.cuh streams the visited chunks into
// shared-memory slots).  Its test of a chunk is the one above, so against
// `nearest_hit_transparent_hbm_ref` it agrees bit for bit as the resident
// variant does against its twin; against the resident variant it agrees on
// t and the opaque slot, while a stale bound may visit more chunks, whose
// far glass hits take slots and move later hits' slot positions.
//
// Build: nvcc --fmad=false, IEEE division (see engine/_build.py).

#include "chunk_ring.cuh"

namespace {

using namespace ntr;

constexpr int KMAX = 8;          // transparent slots a ray can hold

template <int D, bool SHARED, bool STREAM>
__global__ void __launch_bounds__(RB) nearest_t_kernel(
    const float* __restrict__ oT, const float* __restrict__ dT,
    const int* __restrict__ skip, const float* __restrict__ init_t,
    const int* __restrict__ order, int n_eff, const int* __restrict__ blive,
    const float* __restrict__ klo_t, const float* __restrict__ khi_t,
    int ncp, const float* __restrict__ gt, const float* __restrict__ ci,
    const int* __restrict__ ids, const float* __restrict__ opa, int pr, int R,
    int K, float* __restrict__ out_t, int* __restrict__ out_slot,
    float* __restrict__ out_tt, int* __restrict__ out_tslot,
    int* __restrict__ visits, float* __restrict__ emin_all, int n_slots) {
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
    for (int k = 0; k < K; ++k) {
      out_tt[(size_t)k * R + r] = INFINITY;
      out_tslot[(size_t)k * R + r] = -1;
    }
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
  float tt[KMAX];                      // the K slots; -inf beyond K
  int ts[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    tt[i] = i < K ? INFINITY : -INFINITY;
    ts[i] = -1;
  }

  auto bound = [&]() { return block_max(best, s_red); };
  auto test = [&](int idx, const Chunk& ch) {
    float cbest = INFINITY;
    int carg = 0;
    float ct[KMAX];                    // this chunk's nearest transparent
    int cl[KMAX];                      // hits, ascending, and their lanes
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      ct[i] = INFINITY;
      cl[i] = 0;
    }
    for (int l = 0; l < CK; ++l) {
      float t;
      const bool valid =
          pair_test<D, SHARED>(ch.g, ch.c, l, o, dv, t) && (ch.id[l] != sk);
      if (!valid) continue;
      if (ch.opa[l] >= 1.f) {
        if (t < cbest) {
          cbest = t;
          carg = l;
        }
      } else {
        // insert behind every entry <= t; the last entry falls off
        float x = t;
        int xl = l;
        bool moved = false;
#pragma unroll
        for (int i = 0; i < KMAX; ++i) {
          if (moved || x < ct[i]) {
            const float ft = ct[i];
            const int fl = cl[i];
            ct[i] = x;
            cl[i] = xl;
            x = ft;
            xl = fl;
            moved = true;
          }
        }
      }
    }
    if (cbest < best) {
      best = cbest;
      best_id = idx * CK + carg;
    }
    // offer the chunk's K nearest to the slots, nearest first
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < K && ct[j] < INFINITY) {
        float bmax = tt[0];
        int barg = 0;
#pragma unroll
        for (int i = 1; i < KMAX; ++i) {
          if (tt[i] > bmax) {          // strict: the first largest slot
            bmax = tt[i];
            barg = i;
          }
        }
        if (ct[j] < bmax) {
#pragma unroll
          for (int i = 0; i < KMAX; ++i) {
            if (i == barg) {
              tt[i] = ct[j];
              ts[i] = idx * CK + cl[j];
            }
          }
        }
      }
    }
  };

  // 2. the walk: resident, one candidate a step, the next one picked with
  // the bound from before this visit; streaming, the TPU kernel's groups
  int nvis;
  if constexpr (STREAM)
    nvis = stream_walk<D, true>(gt, ci, ids, opa, pr, order, n_eff, emin,
                                n_slots, s_cand, bound, test);
  else
    nvis = resident_walk<D, 1, true>(gt, ci, ids, opa, pr, order, n_eff,
                                     emin, s_cand, bound, test);

  out_t[r] = best;
  out_slot[r] = best_id;
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    if (i < K) {
      out_tt[(size_t)i * R + r] = tt[i];
      out_tslot[(size_t)i * R + r] = ts[i];
    }
  }
  if (tid == 0) visits[blk] = nvis;
}

template <int D, bool SHARED, bool STREAM>
int launch(int grid, cudaStream_t s, const float* oT, const float* dT,
           const int* skip, const float* init_t, const int* order, int n_eff,
           const int* blive, const float* klo_t, const float* khi_t, int ncp,
           const float* gt, const float* ci, const int* ids, const float* opa,
           int pr, int R, int K, float* out_t, int* out_slot, float* out_tt,
           int* out_tslot, int* visits, float* emin) {
  auto kernel = nearest_t_kernel<D, SHARED, STREAM>;
  int n_slots = 0, smem = 0;
  if (STREAM) {
    const cudaError_t err = ring_config<D, true>(kernel, &n_slots, &smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, RB, smem, s>>>(oT, dT, skip, init_t, order, n_eff, blive,
                                klo_t, khi_t, ncp, gt, ci, ids, opa, pr, R, K,
                                out_t, out_slot, out_tt, out_tslot, visits,
                                emin, n_slots);
  return (int)cudaGetLastError();
}

template <bool STREAM>
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
#define NTR_CASE(DD)                                                         \
  case DD:                                                                   \
    return shared ? launch<DD, true, STREAM>(                                \
                        grid, s, oT, dT, skip, init_t, order, n_eff, blive,  \
                        klo_t, khi_t, ncp, gt, ci, ids, opa, pr, R, K,       \
                        out_t, out_slot, out_tt, out_tslot, visits, emin)    \
                  : launch<DD, false, STREAM>(                               \
                        grid, s, oT, dT, skip, init_t, order, n_eff, blive,  \
                        klo_t, khi_t, ncp, gt, ci, ids, opa, pr, R, K,       \
                        out_t, out_slot, out_tt, out_tslot, visits, emin);
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

// Launch the transparent walk on `stream`.  Arguments as ntr_nearest_hit,
// plus opa (nc, 8, 128) f32 (row 0 = the slots' opacities) and K in 1..8;
// out_tt / out_tslot are (K, R), lane-major.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a K the kernel cannot hold.
int ntr_nearest_t(const float* oT, const float* dT, const int* skip,
                  const float* init_t, const int* order, int n_eff,
                  const int* blive, const float* klo_t, const float* khi_t,
                  int ncp, const float* gt, const float* ci, const int* ids,
                  const float* opa, int pr, int R, int d, int shared, int K,
                  float* out_t, int* out_slot, float* out_tt, int* out_tslot,
                  int* visits, float* emin, void* stream) {
  return launch_d<false>(oT, dT, skip, init_t, order, n_eff, blive, klo_t,
                         khi_t, ncp, gt, ci, ids, opa, pr, R, d, shared, K,
                         out_t, out_slot, out_tt, out_tslot, visits, emin,
                         stream);
}

// The streaming walk (kernel 2.7, groups of four): arguments and outputs as
// ntr_nearest_t; gt, ci, ids and opa must be 16-byte aligned.
int ntr_nearest_t_hbm(const float* oT, const float* dT, const int* skip,
                      const float* init_t, const int* order, int n_eff,
                      const int* blive, const float* klo_t,
                      const float* khi_t, int ncp, const float* gt,
                      const float* ci, const int* ids, const float* opa,
                      int pr, int R, int d, int shared, int K, float* out_t,
                      int* out_slot, float* out_tt, int* out_tslot,
                      int* visits, float* emin, void* stream) {
  return launch_d<true>(oT, dT, skip, init_t, order, n_eff, blive, klo_t,
                        khi_t, ncp, gt, ci, ids, opa, pr, R, d, shared, K,
                        out_t, out_slot, out_tt, out_tslot, visits, emin,
                        stream);
}

}  // extern "C"
