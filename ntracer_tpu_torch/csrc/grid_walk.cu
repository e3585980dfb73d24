// Grid walks over a flat triangle pool for scenes of more than 8
// dimensions, for Hopper (sm_90a): the nearest opaque hit of each ray, and
// whether a shadow ray meets an opaque triangle with 0 < t < ldist.
//
// Replaces the TPU kernels ntracer_tpu/engine/pallas_kernels.py
// `nearest_hit` (pallas_call body `_nearest_kernel`) and `occluded`
// (pallas_call body `_occlusion_kernel`).  Their plain PyTorch twins are
// `nearest_hit_ref` and `occluded_ref` in
// ntracer_tpu_torch/engine/grid_kernels.py; kernel and twin agree bit for
// bit on t, ids, `blocked` and the tiles each block ran.
//
// What it computes.  The TPU kernel's grid of (512 rays x 512 triangles)
// tiles: one CUDA block walks one 512-ray block (a 32x16-pixel tile of the
// frame), one thread per ray, over the pool's 512-triangle tiles in
// flatten order.  Before a tile, with the carry from before it, the block
// votes (__syncthreads_or): the tile runs when its flag k_any holds and
// some ray of the block enters the tile's box before its best t (occluded:
// before its ldist, on a ray not blocked yet).  In a tile that runs, a
// thread tests its ray against the 512 triangles in lane order and keeps a
// hit only on strict <, so it ends with the nearest hit and the lowest lane
// of a tie, as the TPU kernel's per-tile argmin followed by its strict <
// update does.  The occlusion walk stops testing a ray at its first hit:
// `blocked` is a monotone OR.  d is taken at run time, up to MAXD = 16
// (the ray's coordinates live in registers).
//
// What bounds it.  Pair-test arithmetic: each tile that runs is 512 x 512
// pair tests of d*d multiply-adds for the direction dots (twice that when
// the origin dots are not shared) and one IEEE division; at d = 10 that is
// some 250 operations a pair.  The pool is small (1,024 triangles at d = 10
// is 450 KB) and sits in L2.  The design stages the plane rows of 32
// triangles at a time in shared memory (a tile's rows are 200 KB at d = 10,
// 512 KB at d = 16) and every thread reads the same address (broadcast),
// keeps the ray in registers, and lets a block skip a tile by its vote.
// It runs every tile of every live block (no front-to-back order, as the
// TPU kernel); vector loads of the rows, several rays a thread and a
// chunked pool at large d are later work.
//
// Build: nvcc --fmad=false, IEEE division (see engine/_build.py).  No a*b+c
// is contracted, so every operation rounds as in the twin.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int RB = 512;           // rays per block
constexpr int TB = 512;           // triangles per tile
constexpr int SUB = 32;           // triangles staged in shared memory at once
constexpr int MAXD = 16;          // largest d
constexpr float FUZZ = 1.1920928955078125e-06f;   // float32(eps * 10)
constexpr float BIG = 3e37f;

// min/max that return NaN when either side is NaN (as jnp/torch do)
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

struct Ray {
  float o[MAXD], dv[MAXD], inv[MAXD];
};

// Load thread r's ray from the lane-major (d, R) arrays.
__device__ __forceinline__ void load_ray(const float* __restrict__ oT,
                                         const float* __restrict__ dT, int R,
                                         int d, int r, Ray& ray) {
#pragma unroll
  for (int c = 0; c < MAXD; ++c) {
    ray.o[c] = ray.dv[c] = ray.inv[c] = 0.f;
    if (c < d) {
      ray.o[c] = oT[(size_t)c * R + r];
      ray.dv[c] = dT[(size_t)c * R + r];
      ray.inv[c] = ray.dv[c] == 0.f ? 0.f : 1.f / ray.dv[c];
    }
  }
}

// Entry distance of the ray into tile j's box (k_lo/k_hi are (nj, 1, d));
// INFINITY when the box is missed.
__device__ __forceinline__ float tile_entry(const Ray& ray, int d,
                                            const float* __restrict__ lo,
                                            const float* __restrict__ hi) {
  float tn = -BIG, tf = BIG;
#pragma unroll
  for (int c = 0; c < MAXD; ++c) {
    if (c < d) {
      const float l = lo[c], h = hi[c];
      const bool par = ray.dv[c] == 0.f;
      const float a = (l - ray.o[c]) * ray.inv[c];
      const float b = (h - ray.o[c]) * ray.inv[c];
      const bool ins = (ray.o[c] >= l) && (ray.o[c] <= h);
      const float t0 = par ? (ins ? -BIG : BIG) : nan_min(a, b);
      const float t1 = par ? (ins ? BIG : -BIG) : nan_max(a, b);
      tn = nan_max(tn, t0);
      tf = nan_min(tf, t1);
    }
  }
  const float entry = nan_max(tn, 0.f);
  return (tf >= entry && tf >= 0.f) ? entry : INFINITY;
}

// Stage the rows of triangles [t0, t0 + SUB) in shared memory: s_g[row *
// SUB + l] for the d*d plane rows, s_c[p * SUB + l] for the d offset rows.
// Syncs before (earlier readers are done) and after.
__device__ __forceinline__ void stage(const float* __restrict__ gt,
                                      const float* __restrict__ ci, int T,
                                      int d, int t0, float* s_g, float* s_c) {
  const int tid = threadIdx.x;
  __syncthreads();
  for (int i = tid; i < d * d * SUB; i += RB)
    s_g[i] = gt[(size_t)(i / SUB) * T + t0 + i % SUB];
  for (int i = tid; i < d * SUB; i += RB)
    s_c[i] = ci[(size_t)(i / SUB) * T + t0 + i % SUB];
  __syncthreads();
}

// Ray x triangle pair test (tracer.hpp:411-440) against staged triangle l:
// the hit distance `t` and whether the hit is valid (the id and distance
// tests are the caller's).  Plane dots accumulate coordinate by coordinate
// from 0.  SHARED: the offset rows already carry the origin dots.
template <bool SHARED>
__device__ __forceinline__ bool pair_test(const float* s_g, const float* s_c,
                                          int l, const Ray& ray, int d,
                                          float& t) {
  float o0 = 0.f, dn = 0.f;
#pragma unroll
  for (int k = 0; k < MAXD; ++k) {
    if (k < d) {
      const float gv = s_g[k * SUB + l];
      if (!SHARED) o0 = o0 + ray.o[k] * gv;
      dn = dn + ray.dv[k] * gv;
    }
  }
  t = SHARED ? s_c[l] / dn : (s_c[l] - o0) / dn;
  bool valid = (dn != 0.f) && (t > 0.f);
  float tot = 0.f;
  for (int i = 1; i < d; ++i) {
    float oi = 0.f, di = 0.f;
    const float* g = s_g + i * d * SUB + l;
#pragma unroll
    for (int k = 0; k < MAXD; ++k) {
      if (k < d) {
        const float gv = g[k * SUB];
        if (!SHARED) oi = oi + ray.o[k] * gv;
        di = di + ray.dv[k] * gv;
      }
    }
    const float a = SHARED ? s_c[i * SUB + l] - t * di
                           : (s_c[i * SUB + l] - oi) - t * di;
    valid = valid && (a >= -FUZZ) && (a <= 1.f + FUZZ);
    tot = tot + a;
  }
  return valid && (tot <= 1.f + FUZZ);
}

template <bool SHARED>
__global__ void __launch_bounds__(RB) grid_nearest_kernel(
    const float* __restrict__ oT, const float* __restrict__ dT,
    const int* __restrict__ skip, const float* __restrict__ init_t,
    const float* __restrict__ gt, const float* __restrict__ ci,
    const float* __restrict__ k_lo, const float* __restrict__ k_hi,
    const float* __restrict__ k_any, int T, int R, int d,
    float* __restrict__ out_t, int* __restrict__ out_id,
    int* __restrict__ tiles) {
  __shared__ float s_g[MAXD * MAXD * SUB];   // plane rows of SUB triangles
  __shared__ float s_c[MAXD * SUB];          // their offset (or shared) rows

  const int r = blockIdx.x * RB + threadIdx.x;
  Ray ray;
  load_ray(oT, dT, R, d, r, ray);
  const int sk = skip[r];
  float best = init_t[r];
  int best_id = -1;
  int ntiles = 0;
  for (int j = 0; j < T / TB; ++j) {
    // the block's vote, with the carry from before this tile
    const float e = tile_entry(ray, d, k_lo + (size_t)j * d,
                               k_hi + (size_t)j * d);
    if (!__syncthreads_or(e < best) || !(k_any[j] != 0.f)) continue;
    ++ntiles;
    for (int t0 = j * TB; t0 < (j + 1) * TB; t0 += SUB) {
      stage(gt, ci, T, d, t0, s_g, s_c);
      for (int l = 0; l < SUB; ++l) {
        float t;
        if (pair_test<SHARED>(s_g, s_c, l, ray, d, t) && (t0 + l != sk) &&
            t < best) {
          best = t;
          best_id = t0 + l;
        }
      }
    }
  }
  out_t[r] = best;
  out_id[r] = best_id;
  if (threadIdx.x == 0) tiles[blockIdx.x] = ntiles;
}

__global__ void __launch_bounds__(RB) grid_occluded_kernel(
    const float* __restrict__ oT, const float* __restrict__ dT,
    const int* __restrict__ skip, const float* __restrict__ ldist,
    const float* __restrict__ gt, const float* __restrict__ ci,
    const float* __restrict__ k_lo, const float* __restrict__ k_hi,
    const float* __restrict__ k_any, int T, int R, int d,
    unsigned char* __restrict__ out_blocked, int* __restrict__ tiles) {
  __shared__ float s_g[MAXD * MAXD * SUB];
  __shared__ float s_c[MAXD * SUB];

  const int r = blockIdx.x * RB + threadIdx.x;
  Ray ray;
  load_ray(oT, dT, R, d, r, ray);
  const int sk = skip[r];
  const float ld = ldist[r];
  bool blocked = false;
  int ntiles = 0;
  for (int j = 0; j < T / TB; ++j) {
    const float e = tile_entry(ray, d, k_lo + (size_t)j * d,
                               k_hi + (size_t)j * d);
    if (!__syncthreads_or(!blocked && e < ld) || !(k_any[j] != 0.f))
      continue;
    ++ntiles;
    for (int t0 = j * TB; t0 < (j + 1) * TB; t0 += SUB) {
      stage(gt, ci, T, d, t0, s_g, s_c);
      // no t < ld can hold for ld <= 0 (valid needs t > 0) or NaN
      if (!blocked && ld > 0.f) {
        for (int l = 0; l < SUB; ++l) {
          float t;
          if (pair_test<false>(s_g, s_c, l, ray, d, t) && t < ld &&
              (t0 + l != sk)) {
            blocked = true;
            break;
          }
        }
      }
    }
  }
  out_blocked[r] = blocked ? 1 : 0;
  if (threadIdx.x == 0) tiles[blockIdx.x] = ntiles;
}

int check(int T, int R, int d) {
  if (R % RB || R == 0 || T % TB || T == 0 || d < 3 || d > MAXD)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// Launch the nearest-hit grid walk on `stream`.  Rays are lane-major (d, R)
// with 3 <= d <= 16 and R a multiple of 512; skip (R,) i32; init_t (R,)
// the start distance; gt (d*d, T), ci (d, T) (the shared rows when
// `shared`), k_lo/k_hi (T/512, 1, d), k_any (T/512, 1, 1), T a multiple of
// 512; out_t (R,), out_id (R,) i32, tiles (R/512,) i32.  Returns
// cudaGetLastError() after the launch.
int ntr_grid_nearest_hit(const float* oT, const float* dT, const int* skip,
                         const float* init_t, const float* gt,
                         const float* ci, const float* k_lo,
                         const float* k_hi, const float* k_any, int T, int R,
                         int d, int shared, float* out_t, int* out_id,
                         int* tiles, void* stream) {
  const int bad = check(T, R, d);
  if (bad) return bad;
  cudaStream_t s = (cudaStream_t)stream;
  if (shared)
    grid_nearest_kernel<true><<<R / RB, RB, 0, s>>>(
        oT, dT, skip, init_t, gt, ci, k_lo, k_hi, k_any, T, R, d, out_t,
        out_id, tiles);
  else
    grid_nearest_kernel<false><<<R / RB, RB, 0, s>>>(
        oT, dT, skip, init_t, gt, ci, k_lo, k_hi, k_any, T, R, d, out_t,
        out_id, tiles);
  return (int)cudaGetLastError();
}

// Launch the occlusion grid walk on `stream`.  Arguments as
// ntr_grid_nearest_hit, with ldist (R,) (<= 0 for an inactive ray) in
// place of init_t and ci always the pool's offset rows; blocked (R,) bytes
// (0 or 1).
int ntr_grid_occluded(const float* oT, const float* dT, const int* skip,
                      const float* ldist, const float* gt, const float* ci,
                      const float* k_lo, const float* k_hi,
                      const float* k_any, int T, int R, int d,
                      unsigned char* blocked, int* tiles, void* stream) {
  const int bad = check(T, R, d);
  if (bad) return bad;
  grid_occluded_kernel<<<R / RB, RB, 0, (cudaStream_t)stream>>>(
      oT, dT, skip, ldist, gt, ci, k_lo, k_hi, k_any, T, R, d, blocked,
      tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
