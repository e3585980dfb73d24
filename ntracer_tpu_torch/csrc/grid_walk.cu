// Grid walks over a flat triangle pool for scenes of more than 8
// dimensions, for Hopper (sm_90a): the nearest opaque hit of each ray, and
// whether a shadow ray meets an opaque triangle with 0 < t < ldist.
//
// Replaces the TPU kernels ntracer_tpu/engine/pallas_kernels.py
// `nearest_hit` (pallas_call body `_nearest_kernel`; kernel 2.9) and
// `occluded` (pallas_call body `_occlusion_kernel`; kernel 2.10).  Their
// plain PyTorch twins are `nearest_hit_ref` and `occluded_ref` in
// ntracer_tpu_torch/engine/grid_kernels.py; kernel and twin agree bit for
// bit on t, ids, `blocked` and the tiles each block ran.
//
// What they compute.  The TPU kernel's grid of (512 rays x 512 triangles)
// tiles: one CUDA block walks one 512-ray block (a 32x16-pixel tile of the
// frame) over the pool's 512-triangle tiles in flatten order.  Before a
// tile, with the carry from before it, the block votes (__syncthreads_or):
// the tile runs when its flag k_any holds and some ray of the block enters
// the tile's box before its best t (occluded: before its ldist, on a ray
// not blocked yet).  In a tile that runs, a ray is tested against the 512
// triangles in lane order and keeps a hit only on strict <, so it ends with
// the nearest hit and the lowest lane of a tie, as the TPU kernel's
// per-tile argmin followed by its strict < update does.  The occlusion walk
// stops testing a ray at its first hit: `blocked` is a monotone OR.
//
// What bounds them.  Pair-test arithmetic: a tile that runs is 512 x 512
// pair tests, each d multiply-adds for the plane's direction dot (twice
// that when the origin dots are not shared), one IEEE division for the
// pairs whose t can be positive, and d more multiply-adds for each edge
// plane the pair reaches.  The pool is small (1,024 triangles at d = 10 is
// 450 KB) and sits in L2.
//
// Both kernels are built for that (`grid_nearest_kernel<D, SHARED, RPT>`
// for 2.9, `grid_occluded_kernel<D, RPT>` for 2.10; past d = 16 the wide
// bodies `wide_nearest_kernel<SHARED>` and `wide_occluded_kernel`, below):
//   * Templated on d (3..16), so every dot runs at the exact width; a ray's
//     direction (and, for rays that do not share one origin, its origin)
//     is all it keeps in registers through the triangle loop: the tile
//     vote reloads a shared origin and recomputes 1 / dv.
//   * RPT rays a thread (2.9: two for primary rays, one otherwise; 2.10:
//     one; a block is 512 / RPT threads): one broadcast float4 load of a
//     plane's values serves 4 x RPT multiply-adds.  The pool's plane rows
//     are re-laid triangle by triangle (`grid_kernels.plane_records`: (T,
//     d, pw), each plane padded to pw = 4 * ceil(d / 4) floats), so a
//     triangle's planes are consecutive float4s.
//   * One straight-line pair test with warp-uniform skips (grid_pair, as
//     stream_walk.cuh's pair_test_warp): after plane 0 (the division, t
//     against the ray's best or ldist) and after each edge, a warp none of
//     whose rays can still hit the triangle goes on to the next one.
//     Before the division every pair tests the signs of the numerator and
//     the denominator, and a warp none of whose rays can have t > 0 skips
//     the division.  In 2.10 a ray that is blocked, or whose ldist is <= 0
//     or NaN, tests nothing, and a warp of such rays skips the rest of the
//     tile.
//   * Sub-tiles of GS = 32 triangles stream through a ring of shared-memory
//     slots by TMA bulk copies (chunk_ring.cuh; the loop is grid_tiles):
//     one copy of the sub-tile's plane records and d copies of its offset
//     rows (`ci`, or the shared rows), counted on the slot's "full"
//     mbarrier; each warp releases a slot on its "empty" mbarrier after its
//     tests, and thread 0 refills it.  The block syncs once a tile, in the
//     vote.
//
// Build: nvcc --fmad=false, IEEE division (see engine/_build.py).  No a*b+c
// is contracted, so every operation rounds as in the twin.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "chunk_ring.cuh"

namespace {

constexpr int RB = 512;           // rays per block
constexpr int TB = 512;           // triangles per tile
constexpr float FUZZ = 1.1920928955078125e-06f;   // float32(eps * 10)
constexpr float BIG = 3e37f;
constexpr unsigned FULL = 0xffffffffu;

// min/max that return NaN when either side is NaN (as jnp/torch do)
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// ---------------------------------------------------------------------------
// Kernel 2.9: the nearest-hit grid walk, and what 2.10 shares with it
// ---------------------------------------------------------------------------

constexpr int GS = 32;            // triangles a ring slot holds
constexpr int GNS = TB / GS;      // sub-tiles a tile
constexpr int GRING_MAX = 4;      // ring slots at most

// Floats of one plane in a triangle's record: d padded to a float4.
template <int D>
__host__ __device__ constexpr int plane_width() {
  return (D + 3) / 4 * 4;
}

// Floats of one ring slot: GS records of D planes, then D offset rows of
// GS values.
template <int D>
__host__ __device__ constexpr int grid_slot_floats() {
  return GS * D * plane_width<D>() + D * GS;
}

// Rays a thread of 2.9: two for primary rays (the shared rows carry the origin
// dots, so a ray keeps only its direction), one for rays of their own
// origin.  Four and two ran slower on the 10-orthoplex's primary and
// bounce wavefronts on the H100 (PERF.md section 6): more rays a warp
// leave it fewer triangles to skip.
template <bool SHARED>
__host__ __device__ constexpr int grid_rays() {
  return SHARED ? 2 : 1;
}

// Entry distance into a tile's box (lo/hi: its d bounds) of a ray whose
// reciprocals are computed here (0 on a parallel axis); INFINITY when the
// box is missed.  The twin's slab entry (resident_kernels._entry_all),
// operation for operation.
template <int D>
__device__ __forceinline__ float tile_entry_d(const float (&o)[D],
                                              const float (&dv)[D],
                                              const float* __restrict__ lo,
                                              const float* __restrict__ hi) {
  float tn = -BIG, tf = BIG;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    const float l = lo[c], h = hi[c];
    const bool par = dv[c] == 0.f;
    const float inv = par ? 0.f : 1.f / dv[c];
    const float a = (l - o[c]) * inv;
    const float b = (h - o[c]) * inv;
    const bool ins = (o[c] >= l) && (o[c] <= h);
    const float t0 = par ? (ins ? -BIG : BIG) : nan_min(a, b);
    const float t1 = par ? (ins ? BIG : -BIG) : nan_max(a, b);
    tn = nan_max(tn, t0);
    tf = nan_min(tf, t1);
  }
  const float entry = nan_max(tn, 0.f);
  return (tf >= entry && tf >= 0.f) ? entry : INFINITY;
}

// The origin and direction dots of RPT rays with one plane (`g`, its
// plane_width<D>() floats as float4s), coordinate by coordinate; a sum
// starts at its first product (0 + x = x but for the sign of a zero, and
// see grid_pair for why that sign never matters).  SHARED: no origin dot.
template <int D, bool SHARED, int RPT, int OD>
__device__ __forceinline__ void plane_dots(const float4* g,
                                           const float (&o)[RPT][OD],
                                           const float (&dv)[RPT][D],
                                           float (&od)[RPT],
                                           float (&dd)[RPT]) {
#pragma unroll
  for (int m = 0; m < plane_width<D>() / 4; ++m) {
    const float4 g4 = g[m];
    const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * m + e;
      if (k < D) {
#pragma unroll
        for (int c = 0; c < RPT; ++c) {
          if constexpr (!SHARED)
            od[c] = k == 0 ? o[c][0] * gv[e] : od[c] + o[c][k] * gv[e];
          dd[c] = k == 0 ? dv[c][0] * gv[e] : dd[c] + dv[c][k] * gv[e];
        }
      }
    }
  }
}

// The pair test (tracer.hpp:411-440) of RPT rays of a thread against
// triangle l of ring slot `b` (pool id `id`), every lane of the warp at
// once: one straight line that both grid walks run.  Ray c takes part
// where want(c) holds and `id` is not its skip id sk[c]; where the
// triangle is a valid hit with 0 < t < cut[c] -- the twin's valid && t <
// cut, with every value that decides it rounded as the twin rounds it --
// hit(c, t) runs, in ray order.  The kernels differ only in `want`, the
// cut and `hit`: 2.9 cuts at its best and keeps (t, id) on strict <, 2.10
// takes its live rays, cuts at ldist and ORs `blocked`.  Returns whether
// the warp ran every stage (false: no hit).
//   * Sums start at their first product rather than at +0: they differ
//     only in the sign of a zero sum.  A zero dn fails either way; a zero
//     numerator gives t = +-0, which fails t > 0 either way (SHARED sums no
//     numerator at all); a zero edge dot changes only the sign of a zero
//     `a` or total, which compare alike.  So t is the twin's wherever the
//     pair can count.
//   * The pre-test: the numerator and dn must be nonzero, of one sign and
//     not NaN for (dn != 0) && (t > 0); a warp none of whose rays passes
//     that skips the division.  Rays that fail before the division divide
//     by 1 (t unused), off the division's slow path.
//   * Each later stage runs only while a ray of the warp can still pass it
//     (__any_sync: every lane calls this with the same l).  `valid` is an
//     AND and the edge total matters only where the pair is valid, so the
//     skips change no bit.
template <int D, bool SHARED, int RPT, int OD, class Want, class Hit>
__device__ __forceinline__ bool grid_pair(const float* __restrict__ b, int l,
                                          int id, const float (&o)[RPT][OD],
                                          const float (&dv)[RPT][D],
                                          const int (&sk)[RPT],
                                          const float (&cut)[RPT], Want want,
                                          Hit hit) {
  constexpr int PW = plane_width<D>();
  const float4* rec = reinterpret_cast<const float4*>(b + l * D * PW);
  const float* sc = b + GS * D * PW + l;       // offset row p at sc[p * GS]
  float od[RPT], dd[RPT];
  plane_dots<D, SHARED>(rec, o, dv, od, dd);
  const float c0 = sc[0];
  float num[RPT], tot[RPT], t[RPT];
  bool go[RPT];
  bool any = false;
#pragma unroll
  for (int c = 0; c < RPT; ++c) {
    num[c] = SHARED ? c0 : c0 - od[c];
    // bitwise, so the compiler keeps it one line of predicates
    const bool pos = (num[c] > 0.f) & (dd[c] > 0.f);
    const bool neg = (num[c] < 0.f) & (dd[c] < 0.f);
    go[c] = (id != sk[c]) & want(c) & (pos | neg);
    any = any || go[c];
  }
  if (!__any_sync(FULL, any)) return false;
  any = false;
#pragma unroll
  for (int c = 0; c < RPT; ++c) {
    t[c] = num[c] / (go[c] ? dd[c] : 1.f);
    go[c] = go[c] && t[c] > 0.f && t[c] < cut[c];
    any = any || go[c];
  }
  if (!__any_sync(FULL, any)) return false;
  // edge 1, then the rest in a loop: few pairs get past edge 1
  {
    plane_dots<D, SHARED>(rec + PW / 4, o, dv, od, dd);
    const float cv = sc[GS];
    any = false;
#pragma unroll
    for (int c = 0; c < RPT; ++c) {
      const float a = SHARED ? cv - t[c] * dd[c] : (cv - od[c]) - t[c] * dd[c];
      go[c] = go[c] && (a >= -FUZZ) && (a <= 1.f + FUZZ);
      tot[c] = a;
      any = any || go[c];
    }
    if (!__any_sync(FULL, any)) return false;
  }
#pragma unroll 1
  for (int i = 2; i < D; ++i) {
    plane_dots<D, SHARED>(rec + i * (PW / 4), o, dv, od, dd);
    const float cv = sc[i * GS];
    any = false;
#pragma unroll
    for (int c = 0; c < RPT; ++c) {
      const float a = SHARED ? cv - t[c] * dd[c] : (cv - od[c]) - t[c] * dd[c];
      go[c] = go[c] && (a >= -FUZZ) && (a <= 1.f + FUZZ);
      tot[c] = tot[c] + a;
      any = any || go[c];
    }
    if (!__any_sync(FULL, any)) return false;
  }
#pragma unroll
  for (int c = 0; c < RPT; ++c)
    if (go[c] && tot[c] <= 1.f + FUZZ) hit(c, t[c]);
  return true;
}

// The tile loop of both grid walks.  Every thread calls it; thread `tid`
// owns the block's rays tid * RPT .. tid * RPT + RPT - 1.
//   * Before tile j the block votes with the carry from before it: `vote(j)`
//     says whether some ray of the thread wants the tile (enters its box
//     before its best, or before its ldist on a ray not blocked yet); the
//     tile runs when some thread wants it and its flag k_any holds.
//   * A tile that runs streams its GNS sub-tiles of GS triangles through
//     the `n_slots` ring slots (the dynamic shared memory): thread 0 starts
//     one copy of a sub-tile's plane records and D copies of its offset
//     rows, counted on the slot's "full" mbarrier, once every warp has
//     released the slot's last sub-tile on its "empty" one (a slot is
//     refilled `lag` sub-tiles after its last test began).
//   * Every warp waits on each sub-tile's "full" barrier, runs
//     `test(slot, id0)` (id0: the sub-tile's first pool id) and releases
//     the slot: a warp that has nothing left to test still waits for the
//     copies before it releases the slot, or thread 0 could re-arm a slot
//     whose copies are still landing.
// The block syncs once a tile, in the vote.  Returns the tiles run.
template <int D, int RPT, class Vote, class Test>
__device__ __forceinline__ int grid_tiles(const float* __restrict__ grec,
                                          const float* __restrict__ ci,
                                          const float* __restrict__ k_any,
                                          int T, int n_slots, Vote vote,
                                          Test test) {
  constexpr int NWG = RB / RPT / 32;        // warps a block
  constexpr int PW = plane_width<D>();
  constexpr int SLOT = grid_slot_floats<D>();
  extern __shared__ __align__(128) float s_ring[];
  __shared__ uint64_t s_full[GRING_MAX];
  __shared__ uint64_t s_empty[GRING_MAX];
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < n_slots) {
    ntr::mbar_init(&s_full[tid]);
    ntr::mbar_init_count(&s_empty[tid], NWG);
  }
  ntr::mbar_fence_init();              // the vote's sync orders it first
  const int lag = n_slots > 2 ? 2 : 1;
  int q = 0;                           // sub-tiles started so far
  int ntiles = 0;
  for (int j = 0; j < T / TB; ++j) {
    if (!__syncthreads_or(vote(j)) || !(k_any[j] != 0.f)) continue;
    ++ntiles;
    const int q_end = q + GNS;
    int q_fill = q;
    // thread 0: start the copies of sub-tiles up to `limit`, each into its
    // slot once every warp has released the slot's last sub-tile
    auto fill_ahead = [&](int limit) {
      while (q_fill <= limit && q_fill < q_end) {
        const int s = q_fill % n_slots, f = q_fill / n_slots;
        if (f > 0) ntr::mbar_wait(&s_empty[s], (unsigned)(f - 1) & 1u);
        const size_t t0 = (size_t)j * TB + (size_t)(q_fill - q) * GS;
        float* slot = s_ring + (size_t)s * SLOT;
        ntr::mbar_expect(&s_full[s], SLOT * 4u);
        ntr::bulk_copy(slot, grec + t0 * D * PW, GS * D * PW * 4u,
                       &s_full[s]);
#pragma unroll 1
        for (int p = 0; p < D; ++p)
          ntr::bulk_copy(slot + GS * D * PW + p * GS, ci + (size_t)p * T + t0,
                         GS * 4u, &s_full[s]);
        ++q_fill;
      }
    };
    for (int qq = q; qq < q_end; ++qq) {
      if (tid == 0) fill_ahead(qq + n_slots - lag);
      const int s = qq % n_slots;
      ntr::mbar_wait(&s_full[s], (unsigned)(qq / n_slots) & 1u);
      test(s_ring + (size_t)s * SLOT, j * TB + (qq - q) * GS);
      __syncwarp();
      if (lane == 0) ntr::mbar_arrive(&s_empty[s]);
    }
    q = q_end;
  }
  return ntiles;
}

// Kernel 2.9.  `grec` (T, D, plane_width<D>()) are the pool's plane
// records, `ci` (D, T) its offset rows (SHARED: the shared rows); the
// dynamic shared memory is `n_slots` ring slots of grid_slot_floats<D>()
// floats.
template <int D, bool SHARED, int RPT>
__global__ void __launch_bounds__(RB / RPT) grid_nearest_kernel(
    const float* __restrict__ oT, const float* __restrict__ dT,
    const int* __restrict__ skip, const float* __restrict__ init_t,
    const float* __restrict__ grec, const float* __restrict__ ci,
    const float* __restrict__ k_lo, const float* __restrict__ k_hi,
    const float* __restrict__ k_any, int T, int R, int n_slots,
    float* __restrict__ out_t, int* __restrict__ out_id,
    int* __restrict__ tiles) {
  constexpr int OD = SHARED ? 1 : D;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * RB + tid * RPT;

  float o[RPT][OD], dv[RPT][D], best[RPT];
  int sk[RPT], bid[RPT];
#pragma unroll
  for (int c = 0; c < RPT; ++c) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      dv[c][k] = dT[(size_t)k * R + r0 + c];
      if constexpr (!SHARED) o[c][k] = oT[(size_t)k * R + r0 + c];
    }
    if constexpr (SHARED) o[c][0] = 0.f;
    sk[c] = skip[r0 + c];
    best[c] = init_t[r0 + c];
    bid[c] = -1;
  }
  // the vote reloads a shared origin
  auto vote = [&](int j) {
    bool want = false;
#pragma unroll
    for (int c = 0; c < RPT; ++c) {
      float oo[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        if constexpr (SHARED)
          oo[k] = oT[(size_t)k * R + r0 + c];
        else
          oo[k] = o[c][k];
      }
      const float e = tile_entry_d<D>(oo, dv[c], k_lo + (size_t)j * D,
                                      k_hi + (size_t)j * D);
      want = want || e < best[c];
    }
    return want;
  };
  auto test = [&](const float* slot, int id0) {
#pragma unroll 1
    for (int l = 0; l < GS; ++l) {
      grid_pair<D, SHARED>(
          slot, l, id0 + l, o, dv, sk, best, [](int) { return true; },
          [&](int c, float t) {        // t < best: the strict < update
            best[c] = t;
            bid[c] = id0 + l;
          });
    }
  };
  const int ntiles = grid_tiles<D, RPT>(grec, ci, k_any, T, n_slots, vote,
                                        test);
#pragma unroll
  for (int c = 0; c < RPT; ++c) {
    out_t[r0 + c] = best[c];
    out_id[r0 + c] = bid[c];
  }
  if (tid == 0) tiles[blockIdx.x] = ntiles;
}

// Ring depth and dynamic shared memory of a grid kernel at D: as many
// blocks an SM as its registers allow (at most 8), and as many slots (2 to
// GRING_MAX) as let them share an SM's shared memory; fewer blocks where
// two slots do not fit.
template <int D, class Kernel>
cudaError_t grid_ring_config(Kernel kernel, int threads, int* n_slots,
                             int* smem_bytes, int* blocks) {
  int dev = 0, per_sm = 0, by_regs = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&by_regs, kernel,
                                                        threads, 0);
  if (err != cudaSuccess) return err;
  const int slot = grid_slot_floats<D>() * 4;
  const int fixed = 1024 + (int)fa.sharedSizeBytes;   // 1 KB per block
  int b = by_regs < 8 ? by_regs : 8;
  int s = 0;
  for (; b >= 1; --b) {
    s = (per_sm / b - fixed) / slot;
    if (s >= 2) break;
  }
  if (s > GRING_MAX) s = GRING_MAX;
  if (b < 1 || s < 2) return cudaErrorInvalidConfiguration;
  *n_slots = s;
  *smem_bytes = s * slot;
  *blocks = b;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *smem_bytes);
  if (err != cudaSuccess) return err;
  int pct = (100 * b * (*smem_bytes + fixed) + per_sm - 1) / per_sm;
  if (pct > 100) pct = 100;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, pct);
}

// A grid kernel as it launches, blocks of RB / rpt threads with `smem`
// bytes of dynamic shared memory: info[0..5] = registers a thread, local
// (spill) bytes a thread, blocks per SM, ring slots (`n_slots`), shared
// bytes a block, rays a thread.
template <class Kernel>
int launch_numbers(Kernel kernel, int rpt, int smem, int n_slots,
                   int* info) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  int active = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&active, kernel,
                                                        RB / rpt, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = fa.numRegs;
  info[1] = (int)fa.localSizeBytes;
  info[2] = active;
  info[3] = n_slots;
  info[4] = smem + (int)fa.sharedSizeBytes;
  info[5] = rpt;
  return 0;
}

// A templated grid kernel at D as it launches: launch_numbers.
template <int D, int RPT, class Kernel>
int grid_info(Kernel kernel, int* info) {
  int n_slots = 0, smem = 0, blocks = 0;
  const cudaError_t err =
      grid_ring_config<D>(kernel, RB / RPT, &n_slots, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  return launch_numbers(kernel, RPT, smem, n_slots, info);
}

template <int D, bool SHARED>
int launch_nearest(const float* oT, const float* dT, const int* skip,
                   const float* init_t, const float* grec, const float* ci,
                   const float* k_lo, const float* k_hi, const float* k_any,
                   int T, int R, float* out_t, int* out_id, int* tiles,
                   cudaStream_t stream) {
  constexpr int RPT = grid_rays<SHARED>();
  auto kernel = grid_nearest_kernel<D, SHARED, RPT>;
  int n_slots = 0, smem = 0, blocks = 0;
  const cudaError_t err =
      grid_ring_config<D>(kernel, RB / RPT, &n_slots, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<R / RB, RB / RPT, smem, stream>>>(oT, dT, skip, init_t, grec, ci,
                                             k_lo, k_hi, k_any, T, R,
                                             n_slots, out_t, out_id, tiles);
  return (int)cudaGetLastError();
}

template <int D, bool SHARED>
int nearest_info(int* info) {
  constexpr int RPT = grid_rays<SHARED>();
  return grid_info<D, RPT>(grid_nearest_kernel<D, SHARED, RPT>, info);
}

// ---------------------------------------------------------------------------
// Kernel 2.10: the occlusion grid walk
// ---------------------------------------------------------------------------

// Rays a thread of the occlusion walk: shadow rays leave their own hit
// points, so a ray keeps its origin and direction in registers.  Two a
// thread gained at most 5% on the orthoplex's shadow wavefronts and lost
// 13% where every ray ends blocked (PERF.md section 6).
constexpr int OCCL_RAYS = 1;

// Kernel 2.10: 2.9's design (the tile loop, the ring, grid_pair) with
// ldist as the cut and `blocked` a monotone OR.  A ray is live while it is
// not blocked and its ldist > 0 (an ldist <= 0 or NaN admits no t with
// 0 < t < ldist, and no tile entry below it): a dead ray takes no vote and
// no pair test, and a warp whose rays are all dead skips the rest of a
// tile's pair tests.  No bit changes: a blocked ray stays blocked.
template <int D, int RPT>
__global__ void __launch_bounds__(RB / RPT) grid_occluded_kernel(
    const float* __restrict__ oT, const float* __restrict__ dT,
    const int* __restrict__ skip, const float* __restrict__ ldist,
    const float* __restrict__ grec, const float* __restrict__ ci,
    const float* __restrict__ k_lo, const float* __restrict__ k_hi,
    const float* __restrict__ k_any, int T, int R, int n_slots,
    unsigned char* __restrict__ out_blocked, int* __restrict__ tiles) {
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * RB + tid * RPT;

  float o[RPT][D], dv[RPT][D], ld[RPT];
  int sk[RPT];
  bool live[RPT], blocked[RPT];
#pragma unroll
  for (int c = 0; c < RPT; ++c) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      o[c][k] = oT[(size_t)k * R + r0 + c];
      dv[c][k] = dT[(size_t)k * R + r0 + c];
    }
    sk[c] = skip[r0 + c];
    ld[c] = ldist[r0 + c];
    live[c] = ld[c] > 0.f;
    blocked[c] = false;
  }
  auto vote = [&](int j) {
    bool want = false;
#pragma unroll
    for (int c = 0; c < RPT; ++c) {
      if (live[c])
        want = want || tile_entry_d<D>(o[c], dv[c], k_lo + (size_t)j * D,
                                       k_hi + (size_t)j * D) < ld[c];
    }
    return want;
  };
  auto warp_live = [&] {
    bool any = false;
#pragma unroll
    for (int c = 0; c < RPT; ++c) any = any || live[c];
    return __any_sync(FULL, any);
  };
  auto test = [&](const float* slot, int id0) {
    if (!warp_live()) return;
#pragma unroll 1
    for (int l = 0; l < GS; ++l) {
      if (!grid_pair<D, false>(
              slot, l, id0 + l, o, dv, sk, ld,
              [&](int c) { return live[c]; },
              [&](int c, float) {      // 0 < t < ldist: blocked for good
                blocked[c] = true;
                live[c] = false;
              }))
        continue;
      if (!warp_live()) return;
    }
  };
  const int ntiles = grid_tiles<D, RPT>(grec, ci, k_any, T, n_slots, vote,
                                        test);
#pragma unroll
  for (int c = 0; c < RPT; ++c) out_blocked[r0 + c] = blocked[c] ? 1 : 0;
  if (tid == 0) tiles[blockIdx.x] = ntiles;
}

template <int D>
int launch_occluded(const float* oT, const float* dT, const int* skip,
                    const float* ldist, const float* grec, const float* ci,
                    const float* k_lo, const float* k_hi, const float* k_any,
                    int T, int R, unsigned char* blocked, int* tiles,
                    cudaStream_t stream) {
  auto kernel = grid_occluded_kernel<D, OCCL_RAYS>;
  int n_slots = 0, smem = 0, blocks = 0;
  const cudaError_t err = grid_ring_config<D>(kernel, RB / OCCL_RAYS,
                                              &n_slots, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<R / RB, RB / OCCL_RAYS, smem, stream>>>(
      oT, dT, skip, ldist, grec, ci, k_lo, k_hi, k_any, T, R, n_slots,
      blocked, tiles);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernels 2.9 and 2.10 past d = 16: the wide bodies
// ---------------------------------------------------------------------------
//
// Past d = 16 a ray's coordinates no longer fit in registers beside the pair
// test's (2.9's templated body already runs one block an SM at d = 16), and
// a ring slot (grid_slot_floats: GS * d * pw + d * GS floats) outgrows two
// slots a block at d = 32.  So each walk has one body that takes d at run
// time, `wide_nearest_kernel<SHARED>` (2.9) and `wide_occluded_kernel`
// (2.10):
//   * One ray a thread (a block is 512 threads).  Its direction and, unless
//     the shared rows carry its origin dots, its origin are staged in shared
//     memory, lane-major (coordinate k of thread tid's ray at k * RB + tid:
//     a warp reads 32 consecutive words), each thread its own column, so no
//     sync.  A block holds `wide_smem` bytes: 68 KB at d = 17, 128 KB at
//     d = 32 (half that with the shared rows).  Where a block cannot hold
//     them (d > 56 on an H100, d > 113 with the shared rows) the launch is
//     refused with cudaErrorInvalidConfiguration.
//   * No ring: the plane records and offset rows are read straight from
//     global memory by warp-uniform loads (a plane's values as float4s),
//     which L2 and L1 serve.  A pool of these d is small: the 20-D path's
//     221 simplices are one tile, 800 KB of records.
//   * The templated bodies' vote, tile loop and pair test (tile_entry_d,
//     grid_tiles, grid_pair) with a loop over d where they unroll D,
//     operation for operation: the bits are theirs and the twins'.
// What bounds them is what bounds the templated bodies, the pair tests,
// with each multiply-add of a dot waiting on a load of the ray's coordinate
// from shared memory.

// The least d the wide bodies take; the templates of NTR_GRID_DS take
// 3 .. WIDE_D - 1.  wide_dots unrolls the 16 coordinates every wide ray has.
constexpr int WIDE_D = 17;
static_assert(WIDE_D > 16, "wide_dots unrolls 16 coordinates");

// A staged column: coordinate k of a ray's vector at p[k * RB] in shared
// memory.
struct StagedCol {
  const float* p;
  __device__ __forceinline__ float operator[](int k) const {
    return p[k * RB];
  }
};

// A ray's column of a lane-major (d, R) input: coordinate k at p[k * R].
struct InputCol {
  const float* p;
  int R;
  __device__ __forceinline__ float operator[](int k) const {
    return p[(size_t)k * R];
  }
};

// Shared bytes a block of a wide body holds: `columns` vectors of d floats
// for each of its 512 rays.
__host__ __device__ constexpr int wide_smem(int d, int columns) {
  return columns * d * RB * 4;
}

// Stage ray r's vector of the lane-major (d, R) input `x` in column `c` of
// the block's shared memory `s` (thread tid's own: no other thread reads
// it).
__device__ __forceinline__ StagedCol wide_stage(const float* __restrict__ x,
                                                float* s, int c, int d, int R,
                                                int r) {
  float* col = s + c * d * RB + threadIdx.x;
#pragma unroll 4
  for (int k = 0; k < d; ++k) col[k * RB] = x[(size_t)k * R + r];
  return {col};
}

// tile_entry_d at a run-time d: the entry distance of a ray (origin `o`,
// direction `dv`) into a tile's box (lo/hi: its d bounds).
template <class O>
__device__ __forceinline__ float wide_entry(int d, O o, StagedCol dv,
                                            const float* __restrict__ lo,
                                            const float* __restrict__ hi) {
  float tn = -BIG, tf = BIG;
#pragma unroll 1
  for (int c = 0; c < d; ++c) {
    const float l = lo[c], h = hi[c], oc = o[c], dc = dv[c];
    const bool par = dc == 0.f;
    const float inv = par ? 0.f : 1.f / dc;
    const float a = (l - oc) * inv;
    const float b = (h - oc) * inv;
    const bool ins = (oc >= l) && (oc <= h);
    const float t0 = par ? (ins ? -BIG : BIG) : nan_min(a, b);
    const float t1 = par ? (ins ? BIG : -BIG) : nan_max(a, b);
    tn = nan_max(tn, t0);
    tf = nan_min(tf, t1);
  }
  const float entry = nan_max(tn, 0.f);
  return (tf >= entry && tf >= 0.f) ? entry : INFINITY;
}

// plane_dots of one wide ray with one plane (`g`, its (d + 3) / 4 float4s):
// each sum from its first product, coordinate by coordinate, the first 16
// unrolled and the rest up to d (never over the padding: a zero product
// could turn a -0 sum into +0).  SHARED: no origin dot.
template <bool SHARED>
__device__ __forceinline__ void wide_dots(const float4* __restrict__ g, int d,
                                          StagedCol o, StagedCol dv,
                                          float& od, float& dd) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float4 g4 = g[m];
    const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * m + e;
      if constexpr (!SHARED) od = k == 0 ? o[0] * gv[e] : od + o[k] * gv[e];
      dd = k == 0 ? dv[0] * gv[e] : dd + dv[k] * gv[e];
    }
  }
#pragma unroll 1
  for (int m = 4; 4 * m < d; ++m) {
    const float4 g4 = g[m];
    const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * m + e;
      if (k < d) {
        if constexpr (!SHARED) od = od + o[k] * gv[e];
        dd = dd + dv[k] * gv[e];
      }
    }
  }
}

// grid_pair for the one wide ray of a thread against pool triangle `id`
// (its plane records at `rec`, pw4 float4s a plane; its offset rows, or
// the shared rows, at cp[p * T]): the same stages, the same warp-uniform
// skips, the same rounding.  Returns whether the warp ran every stage.
template <bool SHARED, class Hit>
__device__ __forceinline__ bool wide_pair(const float4* __restrict__ rec,
                                          int pw4,
                                          const float* __restrict__ cp,
                                          int T, int id, int d, StagedCol o,
                                          StagedCol dv, int sk, float cut,
                                          bool want, Hit hit) {
  float od = 0.f, dd;
  wide_dots<SHARED>(rec, d, o, dv, od, dd);
  const float c0 = cp[0];
  const float num = SHARED ? c0 : c0 - od;
  const bool pos = (num > 0.f) & (dd > 0.f);
  const bool neg = (num < 0.f) & (dd < 0.f);
  bool go = (id != sk) & want & (pos | neg);
  if (!__any_sync(FULL, go)) return false;
  const float t = num / (go ? dd : 1.f);
  go = go && t > 0.f && t < cut;
  if (!__any_sync(FULL, go)) return false;
  float tot = 0.f;
#pragma unroll 1
  for (int i = 1; i < d; ++i) {
    wide_dots<SHARED>(rec + i * pw4, d, o, dv, od, dd);
    const float cv = cp[(size_t)i * T];
    const float a = SHARED ? cv - t * dd : (cv - od) - t * dd;
    go = go && (a >= -FUZZ) && (a <= 1.f + FUZZ);
    tot = i == 1 ? a : tot + a;
    if (!__any_sync(FULL, go)) return false;
  }
  if (go && tot <= 1.f + FUZZ) hit(t);
  return true;
}

// grid_tiles without the ring: before tile j the block votes with the carry
// from before it, and a tile that runs is `test(j)`, its 512 triangles in
// lane order.  Returns the tiles run.
template <class Vote, class Test>
__device__ __forceinline__ int wide_tiles(const float* __restrict__ k_any,
                                          int T, Vote vote, Test test) {
  int ntiles = 0;
  for (int j = 0; j < T / TB; ++j) {
    if (!__syncthreads_or(vote(j)) || !(k_any[j] != 0.f)) continue;
    ++ntiles;
    test(j);
  }
  return ntiles;
}

// Kernel 2.9 past d = 16: grid_nearest_kernel's arguments, with d at run
// time and wide_smem(d, SHARED ? 1 : 2) bytes of dynamic shared memory.
template <bool SHARED>
__global__ void __launch_bounds__(RB) wide_nearest_kernel(
    const float* __restrict__ oT, const float* __restrict__ dT,
    const int* __restrict__ skip, const float* __restrict__ init_t,
    const float* __restrict__ grec, const float* __restrict__ ci,
    const float* __restrict__ k_lo, const float* __restrict__ k_hi,
    const float* __restrict__ k_any, int T, int R, int d,
    float* __restrict__ out_t, int* __restrict__ out_id,
    int* __restrict__ tiles) {
  extern __shared__ float s_cols[];
  const int r = blockIdx.x * RB + threadIdx.x;
  const int pw4 = (d + 3) / 4;
  const StagedCol dv = wide_stage(dT, s_cols, 0, d, R, r);
  StagedCol o = dv;                    // no origin dots with the shared rows
  if constexpr (!SHARED) o = wide_stage(oT, s_cols, 1, d, R, r);
  const int sk = skip[r];
  float best = init_t[r];
  int bid = -1;
  // the vote reads a shared origin in place
  auto vote = [&](int j) {
    const float* lo = k_lo + (size_t)j * d;
    const float* hi = k_hi + (size_t)j * d;
    if constexpr (SHARED)
      return wide_entry(d, InputCol{oT + r, R}, dv, lo, hi) < best;
    else
      return wide_entry(d, o, dv, lo, hi) < best;
  };
  auto test = [&](int j) {
#pragma unroll 1
    for (int l = 0; l < TB; ++l) {
      const int id = j * TB + l;
      wide_pair<SHARED>(
          reinterpret_cast<const float4*>(grec) + (size_t)id * d * pw4, pw4,
          ci + id, T, id, d, o, dv, sk, best, true,
          [&](float t) {               // t < best: the strict < update
            best = t;
            bid = id;
          });
    }
  };
  const int ntiles = wide_tiles(k_any, T, vote, test);
  out_t[r] = best;
  out_id[r] = bid;
  if (threadIdx.x == 0) tiles[blockIdx.x] = ntiles;
}

// Kernel 2.10 past d = 16: grid_occluded_kernel's rule (a dead ray takes no
// vote and no pair test, a warp of dead rays skips the rest of a tile) on
// the wide body, wide_smem(d, 2) bytes of dynamic shared memory.
__global__ void __launch_bounds__(RB) wide_occluded_kernel(
    const float* __restrict__ oT, const float* __restrict__ dT,
    const int* __restrict__ skip, const float* __restrict__ ldist,
    const float* __restrict__ grec, const float* __restrict__ ci,
    const float* __restrict__ k_lo, const float* __restrict__ k_hi,
    const float* __restrict__ k_any, int T, int R, int d,
    unsigned char* __restrict__ out_blocked, int* __restrict__ tiles) {
  extern __shared__ float s_cols[];
  const int r = blockIdx.x * RB + threadIdx.x;
  const int pw4 = (d + 3) / 4;
  const StagedCol dv = wide_stage(dT, s_cols, 0, d, R, r);
  const StagedCol o = wide_stage(oT, s_cols, 1, d, R, r);
  const int sk = skip[r];
  const float ld = ldist[r];
  bool live = ld > 0.f, blocked = false;
  auto vote = [&](int j) {
    return live && wide_entry(d, o, dv, k_lo + (size_t)j * d,
                              k_hi + (size_t)j * d) < ld;
  };
  auto test = [&](int j) {
    if (!__any_sync(FULL, live)) return;
#pragma unroll 1
    for (int l = 0; l < TB; ++l) {
      const int id = j * TB + l;
      if (!wide_pair<false>(
              reinterpret_cast<const float4*>(grec) + (size_t)id * d * pw4,
              pw4, ci + id, T, id, d, o, dv, sk, ld, live,
              [&](float) {             // 0 < t < ldist: blocked for good
                blocked = true;
                live = false;
              }))
        continue;
      if (!__any_sync(FULL, live)) return;
    }
  };
  const int ntiles = wide_tiles(k_any, T, vote, test);
  out_blocked[r] = blocked ? 1 : 0;
  if (threadIdx.x == 0) tiles[blockIdx.x] = ntiles;
}

// Let a wide body take `smem` bytes of dynamic shared memory a block:
// cudaErrorInvalidConfiguration where a block cannot hold them.
template <class Kernel>
cudaError_t wide_config(Kernel kernel, int smem) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  if (smem + (int)fa.sharedSizeBytes > optin)
    return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <bool SHARED>
int launch_wide_nearest(const float* oT, const float* dT, const int* skip,
                        const float* init_t, const float* grec,
                        const float* ci, const float* k_lo, const float* k_hi,
                        const float* k_any, int T, int R, int d, float* out_t,
                        int* out_id, int* tiles, cudaStream_t stream) {
  auto kernel = wide_nearest_kernel<SHARED>;
  const int smem = wide_smem(d, SHARED ? 1 : 2);
  const cudaError_t err = wide_config(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<R / RB, RB, smem, stream>>>(oT, dT, skip, init_t, grec, ci, k_lo,
                                       k_hi, k_any, T, R, d, out_t, out_id,
                                       tiles);
  return (int)cudaGetLastError();
}

int launch_wide_occluded(const float* oT, const float* dT, const int* skip,
                         const float* ldist, const float* grec,
                         const float* ci, const float* k_lo,
                         const float* k_hi, const float* k_any, int T, int R,
                         int d, unsigned char* blocked, int* tiles,
                         cudaStream_t stream) {
  const int smem = wide_smem(d, 2);
  const cudaError_t err = wide_config(wide_occluded_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  wide_occluded_kernel<<<R / RB, RB, smem, stream>>>(
      oT, dT, skip, ldist, grec, ci, k_lo, k_hi, k_any, T, R, d, blocked,
      tiles);
  return (int)cudaGetLastError();
}

// A wide body as it launches: info as grid_info's (no ring: 0 slots, one
// ray a thread).
template <class Kernel>
int wide_info(Kernel kernel, int smem, int* info) {
  const cudaError_t err = wide_config(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  return launch_numbers(kernel, 1, smem, 0, info);
}

int check(int T, int R) {
  if (R % RB || R == 0 || T % TB || T == 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// the d of the templated bodies: 3 .. 16 (a ray's registers); the wide
// bodies take every d from WIDE_D = 17 up
#define NTR_GRID_DS(X)                                                      \
  X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15)    \
  X(16)

extern "C" {

// Launch the nearest-hit grid walk (kernel 2.9) on `stream`.  Rays are
// lane-major (d, R) with d >= 3 and R a multiple of 512; skip (R,)
// i32; init_t (R,) the start distance; grec (T, d, pw) the plane records
// (grid_kernels.plane_records, pw = 4 * ceil(d / 4)), ci (d, T) (the
// shared rows when `shared`), both 16-byte aligned; k_lo/k_hi (T/512, 1,
// d), k_any (T/512, 1, 1), T a multiple of 512; out_t (R,), out_id (R,)
// i32, tiles (R/512,) i32.  d < WIDE_D takes the body templated on d, a
// larger d the wide body.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidConfiguration, no launch, where a block cannot stage the
// wide body's rays).
int ntr_grid_nearest_hit(const float* oT, const float* dT, const int* skip,
                         const float* init_t, const float* grec,
                         const float* ci, const float* k_lo,
                         const float* k_hi, const float* k_any, int T, int R,
                         int d, int shared, float* out_t, int* out_id,
                         int* tiles, void* stream) {
  const int bad = check(T, R);
  if (bad) return bad;
  cudaStream_t s = (cudaStream_t)stream;
#define NTR_CASE(DD)                                                        \
  case DD:                                                                  \
    return shared ? launch_nearest<DD, true>(oT, dT, skip, init_t, grec, ci, \
                                             k_lo, k_hi, k_any, T, R, out_t, \
                                             out_id, tiles, s)               \
                  : launch_nearest<DD, false>(oT, dT, skip, init_t, grec,    \
                                              ci, k_lo, k_hi, k_any, T, R,   \
                                              out_t, out_id, tiles, s);
  switch (d) {
    NTR_GRID_DS(NTR_CASE)
    default:
      if (d < WIDE_D) return (int)cudaErrorInvalidValue;
      return shared ? launch_wide_nearest<true>(oT, dT, skip, init_t, grec,
                                                ci, k_lo, k_hi, k_any, T, R,
                                                d, out_t, out_id, tiles, s)
                    : launch_wide_nearest<false>(oT, dT, skip, init_t, grec,
                                                 ci, k_lo, k_hi, k_any, T, R,
                                                 d, out_t, out_id, tiles, s);
  }
#undef NTR_CASE
}

// Kernel 2.9 at dimension d (shared: the primary rays' variant) as it
// launches: info[0..5] = registers a thread, local (spill) bytes a thread,
// blocks per SM, ring slots, shared bytes a block, rays a thread.
int ntr_grid_nearest_hit_info(int d, int shared, int* info) {
#define NTR_CASE(DD)                                                        \
  case DD:                                                                  \
    return shared ? nearest_info<DD, true>(info)                            \
                  : nearest_info<DD, false>(info);
  switch (d) {
    NTR_GRID_DS(NTR_CASE)
    default:
      if (d < WIDE_D) return (int)cudaErrorInvalidValue;
      return shared ? wide_info(wide_nearest_kernel<true>, wide_smem(d, 1),
                                info)
                    : wide_info(wide_nearest_kernel<false>, wide_smem(d, 2),
                                info);
  }
#undef NTR_CASE
}

// Launch the occlusion grid walk (kernel 2.10) on `stream`.  Arguments as
// ntr_grid_nearest_hit, with ldist (R,) (<= 0 for an inactive ray) in
// place of init_t and ci always the pool's offset rows; blocked (R,) bytes
// (0 or 1).
int ntr_grid_occluded(const float* oT, const float* dT, const int* skip,
                      const float* ldist, const float* grec, const float* ci,
                      const float* k_lo, const float* k_hi,
                      const float* k_any, int T, int R, int d,
                      unsigned char* blocked, int* tiles, void* stream) {
  const int bad = check(T, R);
  if (bad) return bad;
  cudaStream_t s = (cudaStream_t)stream;
#define NTR_CASE(DD)                                                        \
  case DD:                                                                  \
    return launch_occluded<DD>(oT, dT, skip, ldist, grec, ci, k_lo, k_hi,   \
                               k_any, T, R, blocked, tiles, s);
  switch (d) {
    NTR_GRID_DS(NTR_CASE)
    default:
      if (d < WIDE_D) return (int)cudaErrorInvalidValue;
      return launch_wide_occluded(oT, dT, skip, ldist, grec, ci, k_lo, k_hi,
                                  k_any, T, R, d, blocked, tiles, s);
  }
#undef NTR_CASE
}

// Kernel 2.10 at dimension d as it launches: info as
// ntr_grid_nearest_hit_info.
int ntr_grid_occluded_info(int d, int* info) {
#define NTR_CASE(DD)                                                        \
  case DD:                                                                  \
    return grid_info<DD, OCCL_RAYS>(grid_occluded_kernel<DD, OCCL_RAYS>,    \
                                    info);
  switch (d) {
    NTR_GRID_DS(NTR_CASE)
    default:
      if (d < WIDE_D) return (int)cudaErrorInvalidValue;
      return wide_info(wide_occluded_kernel, wide_smem(d, 2), info);
  }
#undef NTR_CASE
}

}  // extern "C"
