// Pieces shared by the chunk walks (nearest_hit.cu, occluded.cu,
// nearest_hit_transparent.cu, occluded_transparent.cu), so the kernels
// cannot drift apart: the constants, NaN-propagating min/max, the slab
// entry of a ray into a chunk box, the block's entry minima, the candidate
// scan, chunk staging, the resident walk's loop and the ray x slot pair
// test.  The streaming walk's loop is chunk_ring.cuh's.
//
// One CUDA block walks one 512-ray block, one thread per ray.  Everything
// here rounds every operation (build with --fmad=false and IEEE division,
// see engine/_build.py), as the plain PyTorch twins in
// ntracer_tpu_torch/engine/resident_kernels.py do (`_entry_all`,
// `_find_cands`, `_chunk_hits_vals`).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ntr {

constexpr int RB = 512;          // rays per block
constexpr int CK = 128;          // slots per chunk
constexpr int CP = 8;            // padded coordinate rows of ci/ids
constexpr int NW = RB / 32;      // warps per block
constexpr int NCAND = 4;         // candidates picked per grouped walk step
constexpr int SENT = 1 << 30;    // "no candidate"
constexpr float FUZZ = 1.1920928955078125e-06f;   // float32(eps * 10)
constexpr float BIG = 3e37f;

// min/max that return NaN when either side is NaN (as jnp/torch do)
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// Entry distance of a ray into chunk position k's box (klo_t/khi_t are
// (8, ncp), in visit order); INFINITY when the box is missed.
template <int D>
__device__ __forceinline__ float slab_entry(const float (&o)[D],
                                            const float (&dv)[D],
                                            const float (&inv)[D],
                                            const float* __restrict__ klo_t,
                                            const float* __restrict__ khi_t,
                                            int ncp, int k) {
  float tn = -BIG, tf = BIG;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    const float lo = klo_t[c * ncp + k];
    const float hi = khi_t[c * ncp + k];
    const bool par = dv[c] == 0.f;
    const float a = (lo - o[c]) * inv[c];
    const float b = (hi - o[c]) * inv[c];
    const bool ins = (o[c] >= lo) && (o[c] <= hi);
    const float t0 = par ? (ins ? -BIG : BIG) : nan_min(a, b);
    const float t1 = par ? (ins ? BIG : -BIG) : nan_max(a, b);
    tn = nan_max(tn, t0);
    tf = nan_min(tf, t1);
  }
  const float entry = nan_max(tn, 0.f);
  return (tf >= entry && tf >= 0.f) ? entry : INFINITY;
}

// Load thread r's ray from the lane-major (D, R) arrays.
template <int D>
__device__ __forceinline__ void load_ray(const float* __restrict__ oT,
                                         const float* __restrict__ dT, int R,
                                         int r, float (&o)[D], float (&dv)[D],
                                         float (&inv)[D]) {
#pragma unroll
  for (int c = 0; c < D; ++c) {
    o[c] = oT[(size_t)c * R + r];
    dv[c] = dT[(size_t)c * R + r];
    inv[c] = dv[c] == 0.f ? 0.f : 1.f / dv[c];
  }
}

// Min-over-rays slab entry of every chunk position, 32 at a time, into the
// block's `emin` (global scratch, n_eff floats).  `s_wmin` holds NW * 32
// floats.  Ends with a block sync.
template <int D>
__device__ __forceinline__ void entry_minima(
    const float (&o)[D], const float (&dv)[D], const float (&inv)[D],
    const float* __restrict__ klo_t, const float* __restrict__ khi_t, int ncp,
    int n_eff, float* __restrict__ emin, float* s_wmin) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k0 = 0; k0 < n_eff; k0 += 32) {
    float mine = INFINITY;
    for (int kk = 0; kk < 32; ++kk) {
      const int k = k0 + kk;
      float e = k < n_eff ? slab_entry<D>(o, dv, inv, klo_t, khi_t, ncp, k)
                          : INFINITY;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        e = fminf(e, __shfl_xor_sync(0xffffffffu, e, off));
      if (lane == kk) mine = e;
    }
    s_wmin[warp * 32 + lane] = mine;
    __syncthreads();
    if (tid < 32 && k0 + tid < n_eff) {
      float m = s_wmin[tid];
      for (int w = 1; w < NW; ++w) m = fminf(m, s_wmin[w * 32 + tid]);
      emin[k0 + tid] = m;
    }
    __syncthreads();
  }
}

// Maximum of `v` over the block (NaN if any thread holds NaN).  `s_red`
// holds NW floats.
__device__ __forceinline__ float block_max(float v, float* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  float m = s_red[0];
  for (int w = 1; w < NW; ++w) m = nan_max(m, s_red[w]);
  __syncthreads();
  return m;
}

// The next N positions >= k0 with emin < bound, ascending, SENT fills
// (warp 0 scans 32 positions a step).  `s_cand` holds N <= 32 ints.
template <int N>
__device__ __forceinline__ void find_cands(int k0, float bound, int n_eff,
                                           const float* __restrict__ emin,
                                           int* s_cand, int (&cand)[N]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == 0) {
    int got = 0;
    for (int base = k0; base < n_eff && got < N; base += 32) {
      const int p = base + lane;
      const bool ok = p < n_eff && emin[p] < bound;
      unsigned m = __ballot_sync(0xffffffffu, ok);
      while (m && got < N) {
        if (lane == got) s_cand[got] = base + __ffs(m) - 1;
        ++got;
        m &= m - 1;
      }
    }
    if (lane >= got && lane < N) s_cand[lane] = SENT;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) cand[j] = s_cand[j];
  __syncthreads();
}

// Stage chunk `idx` in shared memory: D*D plane rows, D offset rows (ci, or
// the shared-origin rows) and the pool id row.  Ends with a block sync.
template <int D>
__device__ __forceinline__ void stage_chunk(const float* __restrict__ gt,
                                            const float* __restrict__ ci,
                                            const int* __restrict__ ids,
                                            int pr, int idx, float* s_g,
                                            float* s_c, int* s_id) {
  const int tid = threadIdx.x;
  const float* g = gt + (size_t)idx * pr * CK;
  const float* c = ci + (size_t)idx * CP * CK;
  for (int i = tid; i < D * D * CK; i += RB) s_g[i] = g[i];
  for (int i = tid; i < D * CK; i += RB) s_c[i] = c[i];
  if (tid < CK) s_id[tid] = ids[(size_t)idx * CP * CK + tid];
  __syncthreads();
}

// Stage chunk `idx`'s opacity row (row 0 of opa (nc, 8, 128)).  No sync of
// its own: call it before stage_chunk, whose closing sync covers it.
__device__ __forceinline__ void stage_opacity(const float* __restrict__ opa,
                                              int idx, float* s_opa) {
  if (threadIdx.x < CK)
    s_opa[threadIdx.x] = opa[(size_t)idx * CP * CK + threadIdx.x];
}

// One chunk in shared memory, as a walk's test reads it: D*D plane rows,
// D offset rows, the pool id row and (transparent walks) the opacity row,
// CK entries each.
struct Chunk {
  const float* g;
  const float* c;
  const int* id;
  const float* opa;
};

// The resident walk's loop: groups of N candidate positions, the next group
// picked with the bound from before this group's tests (`bound()`, a block
// reduction every thread calls), each visit staged in shared memory and
// handed to `test(idx, chunk)`, a block sync after each test.  Returns the
// number of visits.  OPA stages the opacity row too.
template <int D, int N, bool OPA, class Bound, class Test>
__device__ __forceinline__ int resident_walk(
    const float* __restrict__ gt, const float* __restrict__ ci,
    const int* __restrict__ ids, const float* __restrict__ opa, int pr,
    const int* __restrict__ order, int n_eff, const float* __restrict__ emin,
    int* s_cand, Bound bound, Test test) {
  __shared__ float s_g[D * D * CK];    // plane rows of the visited chunk
  __shared__ float s_c[D * CK];        // offset rows (ci, or sh if shared)
  __shared__ int s_id[CK];             // pool id row
  __shared__ float s_opa[OPA ? CK : 1];
  int cur[N], nxt[N];
  int nvis = 0;
  find_cands<N>(0, bound(), n_eff, emin, s_cand, cur);
  while (cur[0] != SENT) {
    // the next group is picked with the bound from before this group
    const int kn = cur[N - 1] == SENT ? n_eff : cur[N - 1] + 1;
    find_cands<N>(kn, bound(), n_eff, emin, s_cand, nxt);
    for (int j = 0; j < N; ++j) {
      if (cur[j] != SENT) {
        const int idx = order[cur[j]];
        if (OPA) stage_opacity(opa, idx, s_opa);
        stage_chunk<D>(gt, ci, ids, pr, idx, s_g, s_c, s_id);
        test(idx, Chunk{s_g, s_c, s_id, s_opa});
        __syncthreads();
        ++nvis;
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) cur[j] = nxt[j];
  }
  return nvis;
}

// Ray x slot pair test against the staged chunk (tracer.hpp:411-440): the
// hit distance `t` and whether the hit is valid (the id test is the
// caller's).  Plane dots accumulate coordinate by coordinate.  SHARED: the
// offset rows already carry the origin dots (primary rays).
template <int D, bool SHARED>
__device__ __forceinline__ bool pair_test(const float* s_g, const float* s_c,
                                          int l, const float (&o)[D],
                                          const float (&dv)[D], float& t) {
  float o0 = 0.f, dn = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float gv = s_g[k * CK + l];
    if (!SHARED) o0 = o0 + o[k] * gv;
    dn = dn + dv[k] * gv;
  }
  t = SHARED ? s_c[l] / dn : (s_c[l] - o0) / dn;
  bool valid = (dn != 0.f) && (t > 0.f);
  float tot = 0.f;
#pragma unroll
  for (int i = 1; i < D; ++i) {
    float oi = 0.f, di = 0.f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float gv = s_g[(i * D + k) * CK + l];
      if (!SHARED) oi = oi + o[k] * gv;
      di = di + dv[k] * gv;
    }
    const float a = SHARED ? s_c[i * CK + l] - t * di
                           : (s_c[i * CK + l] - oi) - t * di;
    valid = valid && (a >= -FUZZ) && (a <= 1.f + FUZZ);
    tot = tot + a;
  }
  return valid && (tot <= 1.f + FUZZ);
}

}  // namespace ntr
