// The streaming walks' loop for Hopper, shared by the STREAM variants of
// the four walk sources: kernels 2.5 (nearest_hit.cu), 2.6 (occluded.cu),
// 2.7 (nearest_hit_transparent.cu) and 2.8 (occluded_transparent.cu, whose
// body kernel 2.4 launches too, on pools under the line).  The resident
// walks 2.1-2.3 keep pair_test.cuh's loop; this one visits exactly what
// they visit, and spends its work on the rays that are still live.
//
// One CUDA block of 512 threads serves one 512-ray block; thread r owns ray
// r for the entry pass, the bound and the outputs.  A visit's work is dealt
// out differently:
//
//   * At each group boundary (where the walk needs the block's bound
//     anyway) the block compacts the indices of its live rays into
//     `s_list` (a ballot, a warp prefix and one scan over the warp
//     counts).  The walk says which rays are live: an undecided shadow ray
//     (not blocked, ldist > 0), a ray whose nearest hit can still fall
//     (best > 0), a ray that can still collect glass.  The list holds
//     through the group's visits.
//   * A ray's 128 slots are split into SQ = 4 ranges of SR = 32.  Lane
//     4 * g + q of a warp takes range q of its g-th ray; a warp task holds
//     GW * RPT rays, RPT a lane, so one shared load of a plane row serves
//     RPT pair tests.  Range q is the lanes q, q + 4, ... (the walks whose
//     rule is order-free or merges (t, lane) pairs exactly), or in 2.8 the
//     positions 32q .. 32q + 31 of the bit-reversed lane order (range_lane:
//     one level-5 subtree of its product tree).  Either way the four
//     ranges read four consecutive slots at each step (no bank conflict).
//   * The ring's slots are released per warp, not per block: each slot has
//     a "full" mbarrier (the TMA copies' bytes) and an "empty" one that
//     every warp arrives on after its tests.  The elected producer (thread
//     0) waits on "empty" before it refills a slot.  A visit's tasks are a
//     counter that every warp draws from until they run out (2.5, 2.6,
//     2.8), or are dealt statically, warp w taking tasks w, w + NW, ...
//     (2.7: a ray's visits then run in walk order in one lane group).  The
//     walk's only block-wide syncs are the three of each group boundary.
//   * Results that need walk order across visits wait for the group
//     boundary (`fold`) or are kept in visit order by the static deal.
//
// The visit set is the resident walk's: the block's entry minima over all
// 512 rays, groups of NCAND candidates, each next group picked with the
// bound from before this group's tests (NaN-propagating), chunk q of the
// visit order in ring slot q % S.

#pragma once

#include "chunk_ring.cuh"

namespace ntr {

constexpr int SQ = 4;               // slot ranges a ray is split into
constexpr int SR = CK / SQ;         // slots a range: a level-5 subtree
constexpr int GW = 32 / SQ;         // rays of a warp task per lane row
constexpr int EB = 128;             // chunk positions per entry-pass batch
constexpr int EW = 16;              // positions a lane takes per round
constexpr unsigned FULL = 0xffffffffu;

// Lane of position j (0..31) of range q in the bit-reversed order.
__device__ __forceinline__ int range_lane(int q, int j) {
  return (int)((__brev((unsigned)j) >> 27) << 2) | ((q & 1) << 1) | (q >> 1);
}

// slab_entry for a ray whose origin and direction reciprocals are finite
// (a parallel axis has inv = 0): a = (lo - o) * inv is then never NaN (a
// finite difference times a finite reciprocal), so nan_min/nan_max are
// fminf/fmaxf and the result is slab_entry's, bit for bit.
template <int D>
__device__ __forceinline__ float slab_entry_clean(
    const float (&o)[D], const float (&dv)[D], const float (&inv)[D],
    const float* __restrict__ klo_t, const float* __restrict__ khi_t, int ncp,
    int k) {
  float tn = -BIG, tf = BIG;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    const float lo = klo_t[c * ncp + k], hi = khi_t[c * ncp + k];
    const float a = (lo - o[c]) * inv[c];
    const float b = (hi - o[c]) * inv[c];
    const bool par = dv[c] == 0.f;
    const bool ins = (o[c] >= lo) && (o[c] <= hi);
    tn = fmaxf(tn, par ? (ins ? -BIG : BIG) : fminf(a, b));
    tf = fminf(tf, par ? (ins ? BIG : -BIG) : fmaxf(a, b));
  }
  const float entry = fmaxf(tn, 0.f);
  return (tf >= entry && tf >= 0.f) ? entry : INFINITY;
}

// Min-over-rays slab entry of every chunk position into `emin` (n_eff
// floats), the block's 512 rays one a thread, EB positions a batch.  The
// batch's boxes are staged in `scratch` first (one coalesced pass; every
// lane then reads a box row with a broadcast shared load).  Each lane takes
// EW positions for its ray, then a transpose-min over the warp (8 + 4 + 2 +
// 1 + 1 shuffles) leaves lanes 2p and 2p + 1 the warp's minimum of
// position p, and one block step takes the minimum over warps.  fminf is
// exact and order-free, so `emin` equals entry_minima's bit for bit.  A
// warp whose rays are all clean (slab_entry_clean) takes the short form,
// and a batch runs only the rounds that hold a position below n_eff (a
// pool of 27 chunks: two of eight).
// `scratch` holds (NW + 2 * D) * EB floats.
template <int D>
__device__ __forceinline__ void entry_minima_t(
    const float (&o)[D], const float (&dv)[D], const float (&inv)[D],
    const float* __restrict__ klo_t, const float* __restrict__ khi_t, int ncp,
    int n_eff, float* __restrict__ emin, float* scratch) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  bool clean = true;
#pragma unroll
  for (int c = 0; c < D; ++c)
    clean = clean && fabsf(o[c]) < INFINITY && fabsf(inv[c]) < INFINITY;
  const bool fast = __all_sync(0xffffffffu, clean);
  float* s_lo = scratch + NW * EB;     // the batch's boxes, (D, EB) each
  float* s_hi = s_lo + D * EB;
  for (int k0 = 0; k0 < n_eff; k0 += EB) {
    for (int i = tid; i < D * EB; i += RB) {
      const int k = k0 + i % EB;
      s_lo[i] = k < n_eff ? klo_t[(i / EB) * ncp + k] : 0.f;
      s_hi[i] = k < n_eff ? khi_t[(i / EB) * ncp + k] : 0.f;
    }
    __syncthreads();
    for (int k1 = 0; k1 < EB && k0 + k1 < n_eff; k1 += EW) {
      float v[EW];
      if (fast && k0 + k1 + EW <= n_eff) {
#pragma unroll
        for (int i = 0; i < EW; ++i)
          v[i] = slab_entry_clean<D>(o, dv, inv, s_lo, s_hi, EB, k1 + i);
      } else {
#pragma unroll
        for (int i = 0; i < EW; ++i) {
          const int k = k0 + k1 + i;
          v[i] = k < n_eff ? slab_entry<D>(o, dv, inv, s_lo, s_hi, EB, k1 + i)
                           : INFINITY;
        }
      }
      // halve the values a lane holds at each step: lanes that differ in
      // bit b of the lane keep the two halves of what they held
#pragma unroll
      for (int w = EW / 2, off = 16; w >= 1; w >>= 1, off >>= 1) {
        const bool hi = lane & off;
#pragma unroll
        for (int i = 0; i < w; ++i) {
          const float send = hi ? v[i] : v[i + w];
          const float keep = hi ? v[i + w] : v[i];
          v[i] = fminf(keep, __shfl_xor_sync(0xffffffffu, send, off));
        }
      }
      // v[0] now covers lanes {l, l ^ 16, l ^ 8, l ^ 4, l ^ 2 ...}: the
      // last step joins l and l ^ 1
      v[0] = fminf(v[0], __shfl_xor_sync(0xffffffffu, v[0], 1));
      if (!(lane & 1)) scratch[warp * EB + k1 + (lane >> 1)] = v[0];
    }
    __syncthreads();
    if (tid < EB && k0 + tid < n_eff) {
      float m = scratch[tid];
      for (int w = 1; w < NW; ++w) m = fminf(m, scratch[w * EB + tid]);
      emin[k0 + tid] = m;
    }
    __syncthreads();
  }
}

// The next N positions >= k0 with emin < bound, ascending, SENT fills: the
// calling warp's lanes all get the list (find_cands without its syncs).
template <int N>
__device__ __forceinline__ void warp_cands(int k0, float bound, int n_eff,
                                           const float* __restrict__ emin,
                                           int (&cand)[N]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < N; ++j) cand[j] = SENT;
  int got = 0;
  for (int base = k0; base < n_eff && got < N; base += 32) {
    const int p = base + lane;
    const bool ok = p < n_eff && emin[p] < bound;
    unsigned m = __ballot_sync(0xffffffffu, ok);
    while (m && got < N) {
      const int pos = base + __ffs(m) - 1;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j == got) cand[j] = pos;
      ++got;
      m &= m - 1;
    }
  }
}

// Blocks an SM of the streaming kernels (__launch_bounds__(RB,
// STREAM_BLOCKS): 64 registers a thread).  Three blocks would leave 40
// registers a thread, and the walks spill there.
constexpr int STREAM_BLOCKS = 2;

// Ring depth, dynamic shared memory and carveout of a streaming kernel: as
// many slots (at most RING_MAX) as let STREAM_BLOCKS blocks share an SM
// beside the kernel's static shared memory; where that leaves fewer than
// two slots (2.7 at d = 8, whose K slots take 32 KiB), one block an SM and
// its ring.
template <int D, bool OPA, class Kernel>
cudaError_t stream_ring_config(Kernel kernel, int* n_slots, int* smem_bytes) {
  int dev = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  const int slot = slot_floats<D, OPA>() * 4;
  const int reserved = 1024;          // the card keeps 1 KB per block
  const int fixed = reserved + (int)fa.sharedSizeBytes;
  int blocks = STREAM_BLOCKS;
  int s = (per_sm / blocks - fixed) / slot;
  if (s < 2) {
    blocks = 1;
    s = (per_sm - fixed) / slot;
  }
  if (s > RING_MAX) s = RING_MAX;
  if (s < 2) return cudaErrorInvalidConfiguration;
  *n_slots = s;
  *smem_bytes = s * slot;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *smem_bytes);
  if (err != cudaSuccess) return err;
  // room for the blocks' shared memory, the rest stays L1
  int pct = (100 * blocks * (*smem_bytes + fixed) + per_sm - 1) / per_sm;
  if (pct > 100) pct = 100;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, pct);
}

// Registers, local (spill) bytes a thread, blocks per SM, ring slots and
// shared bytes a block of a streaming kernel, as it launches.
template <int D, bool OPA, class Kernel>
cudaError_t stream_kernel_info(Kernel kernel, int* info) {
  int n_slots = 0, smem = 0;
  cudaError_t err = stream_ring_config<D, OPA>(kernel, &n_slots, &smem);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, RB,
                                                        smem);
  if (err != cudaSuccess) return err;
  info[0] = fa.numRegs;
  info[1] = (int)fa.localSizeBytes;
  info[2] = blocks;
  info[3] = n_slots;
  info[4] = smem + (int)fa.sharedSizeBytes;
  return cudaSuccess;
}

// Rays a lane of the streaming walks' warp tasks (2.5, 2.6 and 2.7; 2.8's
// range tree takes the second ray's registers): two while a ray's rows fit
// 64 registers a thread beside the second's.
template <int D>
__host__ __device__ constexpr int rays_a_lane() {
  return D <= 4 ? 2 : 1;
}

// What the loop asks of each ray at a group boundary, once the group's
// results are folded: its share of the block's bound (the bound is the
// NaN-propagating maximum over all 512 rays) and whether the next group's
// visits test it.
struct RayState {
  float bound;
  bool live;
};

// The streaming walk.  Every thread calls it with its own ray.
//   * `fold()` runs in every thread at each group boundary, once the
//     group's tests are done (where a walk folds per-visit results of its
//     own ray in visit order), and `state()` right after it (RayState of
//     the thread's own ray).
//   * `test(chunk, idx, n_live, next, j)` runs in every warp for every
//     visit (the group's j-th, pool chunk idx), after the slot's copies
//     landed; `s_list[0, n_live)` are the rays live at the group's
//     boundary, and `*next` is the visit's task counter (0 when the slot
//     was filled).
// The `n_slots` ring slots of slot_floats<D, OPA>() floats each are the
// dynamic shared memory, and hold the entry pass's scratch before the walk
// starts.  Returns the number of visits.
template <int D, bool OPA, class State, class Test, class Fold>
__device__ __forceinline__ int stream_walk(
    const float (&o)[D], const float (&dv)[D], const float (&inv)[D],
    const float* __restrict__ klo_t, const float* __restrict__ khi_t, int ncp,
    const float* __restrict__ gt, const float* __restrict__ ci,
    const int* __restrict__ ids, const float* __restrict__ opa, int pr,
    const int* __restrict__ order, int n_eff, float* __restrict__ emin,
    int n_slots, int* s_list, State state, Test test, Fold fold) {
  extern __shared__ __align__(128) float s_ring[];
  __shared__ uint64_t s_full[RING_MAX];
  __shared__ uint64_t s_empty[RING_MAX];
  __shared__ float s_wmax[NW];
  __shared__ int s_wcnt[NW];
  __shared__ int s_cand[2 * NCAND];
  __shared__ int s_next[RING_MAX];     // next task of each slot's visit
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  static_assert(2 * slot_floats<D, OPA>() >= (NW + 2 * D) * EB,
                "the entry pass's scratch fits in two ring slots");

  // 1. min-over-rays slab entry of every chunk position
  entry_minima_t<D>(o, dv, inv, klo_t, khi_t, ncp, n_eff, emin, s_ring);
  fence_proxy_async();                 // the scratch before the ring's fills
  if (tid < n_slots) {
    mbar_init(&s_full[tid]);
    mbar_init_count(&s_empty[tid], NW);
  }
  mbar_fence_init();

  int cur[NCAND], nxt[NCAND];
  int n_cur = 0, n_nxt = 0, n_live = 0;
  int base = 0;                        // visit number of cur[0]
  int q_fill = 0;                      // chunks whose copies are started
  // a slot is refilled `lag` visits after its last test began, so a slow
  // warp rarely holds the producer back
  const int lag = n_slots > 2 ? 2 : 1;

  // Block step at a group boundary: the bound, the compact list and the
  // next group (and, the first time, the current one).
  auto boundary = [&](bool first) {
    __syncthreads();                   // the group's tests are done
    fold();
    const RayState st = state();
    float v = st.bound;
#pragma unroll
    for (int off = 16; off; off >>= 1)
      v = nan_max(v, __shfl_xor_sync(FULL, v, off));
    const unsigned bal = __ballot_sync(FULL, st.live);
    if (lane == 0) {
      s_wmax[warp] = v;
      s_wcnt[warp] = __popc(bal);
    }
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < NW; ++w) {
      const int c = s_wcnt[w];
      before += w < warp ? c : 0;
      total += c;
    }
    if (st.live) s_list[before + __popc(bal & ((1u << lane) - 1u))] = tid;
    n_live = total;
    if (warp == 0) {
      float bound = s_wmax[0];
      for (int w = 1; w < NW; ++w) bound = nan_max(bound, s_wmax[w]);
      if (first) warp_cands<NCAND>(0, bound, n_eff, emin, cur);
      const int kn = cur[NCAND - 1] == SENT ? n_eff : cur[NCAND - 1] + 1;
      // the next group, with the bound from before this group's tests
      warp_cands<NCAND>(kn, bound, n_eff, emin, nxt);
      if (lane < NCAND) {
#pragma unroll
        for (int j = 0; j < NCAND; ++j)
          if (j == lane) {
            s_cand[j] = cur[j];
            s_cand[NCAND + j] = nxt[j];
          }
      }
    }
    __syncthreads();
    n_cur = n_nxt = 0;
#pragma unroll
    for (int j = 0; j < NCAND; ++j) {
      cur[j] = s_cand[j];
      nxt[j] = s_cand[NCAND + j];
      n_cur += cur[j] != SENT;
      n_nxt += nxt[j] != SENT;
    }
  };

  // thread 0: start the copies of the known chunks (cur, then nxt) up to
  // visit `limit`, each into its slot once every warp has released the
  // slot's last chunk
  auto fill_ahead = [&](int limit) {
    while (q_fill <= limit && q_fill < base + n_cur + n_nxt) {
      const int j = q_fill - base;
      const int pos = j < n_cur ? cur[j] : nxt[j - n_cur];
      const int s = q_fill % n_slots, fill = q_fill / n_slots;
      if (fill > 0) mbar_wait(&s_empty[s], (unsigned)(fill - 1) & 1u);
      s_next[s] = 0;
      ring_fill<D, OPA>(s_ring, &s_full[s], s, order[pos], gt, ci, ids, opa,
                        pr);
      ++q_fill;
    }
  };

  boundary(true);
  while (n_cur) {
    for (int j = 0; j < n_cur; ++j) {
      const int q = base + j;
      if (tid == 0) fill_ahead(q + n_slots - lag);
      const int s = q % n_slots;
      mbar_wait(&s_full[s], (unsigned)(q / n_slots) & 1u);
      test(ring_chunk<D, OPA>(s_ring, s), order[cur[j]], n_live, &s_next[s],
           j);
      __syncwarp();
      if (lane == 0) mbar_arrive(&s_empty[s]);
    }
    base += n_cur;
#pragma unroll
    for (int j = 0; j < NCAND; ++j) cur[j] = nxt[j];
    n_cur = n_nxt;
    n_nxt = 0;
    if (!n_cur) break;
    boundary(false);
  }
  __syncthreads();                     // the last group's tests are done
  fold();
  return base;
}

// The pair test of RPT rays against slot l of a chunk, for every lane of a
// warp at once: the Hopper form of pair_test (pair_test.cuh) that every
// streaming walk uses.  `go[c]` comes in true where ray c still wants this
// slot (live, slot id != its skip id) and leaves true where the slot is a
// valid hit with 0 < t < cut[c], t[c] its distance: the outcome of
// pair_test && t < cut, and pair_test's t, with every value that decides
// them rounded as pair_test rounds it.  SHARED: the offset rows carry the
// origin dots (primary rays), and `o` is not read.
//   * PRE: the numerator (SHARED: the row value s_c[l] itself; else
//     c - o.n) and `dn` must be nonzero, of one sign and not NaN for
//     pair_test's (dn != 0) && (t > 0): a zero dn fails the first, and a
//     zero numerator, a NaN or opposite signs give t = +-0, NaN or t < 0.
//     A warp none of whose rays passes that pre-test skips the division
//     and the edges.  Without PRE only dn != 0 is tested and the warp
//     always divides: the nearest-hit walks' primary rays, which look
//     into the scene from one camera, pass the pre-test on nearly every
//     pair, and there it cost more than the divisions it skipped.
//   * Each edge plane runs only while some ray of the warp can still pass
//     it: edge 1 alone rejects nearly every pair whose t is in range.
//   * Sums start at their first product, not at +0: the two differ only in
//     the sign of a zero sum.  A zero numerator gives t = +-0 and a zero
//     `dn` fails either way, so t is pair_test's wherever it can hold
//     (SHARED sums no numerator at all); a zero edge dot changes only the
//     sign of a zero `a` or total, which compare alike.
// The skips are warp-uniform (__any_sync), so the lanes' code stays one
// straight line and every lane must call it; a ray that failed the test
// before the division divides by 1 (its t is not used), which keeps the
// division off its slow path.
template <int D, int RPT, bool SHARED, bool PRE>
__device__ __forceinline__ void pair_test_warp(const Chunk& ch, int l,
                                               const float (&o)[RPT][D],
                                               const float (&dv)[RPT][D],
                                               const float (&cut)[RPT],
                                               bool (&go)[RPT],
                                               float (&t)[RPT]) {
  float o0[RPT], dn[RPT];
  {
    const float gv = ch.g[l];
#pragma unroll
    for (int c = 0; c < RPT; ++c) {
      if (!SHARED) o0[c] = o[c][0] * gv;
      dn[c] = dv[c][0] * gv;
    }
  }
#pragma unroll
  for (int k = 1; k < D; ++k) {
    const float gv = ch.g[k * CK + l];
#pragma unroll
    for (int c = 0; c < RPT; ++c) {
      if (!SHARED) o0[c] = o0[c] + o[c][k] * gv;
      dn[c] = dn[c] + dv[c][k] * gv;
    }
  }
  const float c0 = ch.c[l];
  float num[RPT], tot[RPT];
  bool any = false;
#pragma unroll
  for (int c = 0; c < RPT; ++c) {
    num[c] = SHARED ? c0 : c0 - o0[c];
    t[c] = 0.f;
    // bitwise, so the compiler keeps it one line of predicates
    const bool pos = (num[c] > 0.f) & (dn[c] > 0.f);
    const bool neg = (num[c] < 0.f) & (dn[c] < 0.f);
    go[c] = go[c] & (PRE ? pos | neg : dn[c] != 0.f);
    any = any || go[c];
  }
  if (PRE && !__any_sync(FULL, any)) return;
#pragma unroll
  for (int i = 1; i < D; ++i) {
    float oi[RPT], di[RPT];
    {
      const float gv = ch.g[(i * D) * CK + l];
#pragma unroll
      for (int c = 0; c < RPT; ++c) {
        if (!SHARED) oi[c] = o[c][0] * gv;
        di[c] = dv[c][0] * gv;
      }
    }
#pragma unroll
    for (int k = 1; k < D; ++k) {
      const float gv = ch.g[(i * D + k) * CK + l];
#pragma unroll
      for (int c = 0; c < RPT; ++c) {
        if (!SHARED) oi[c] = oi[c] + o[c][k] * gv;
        di[c] = di[c] + dv[c][k] * gv;
      }
    }
    const float cv = ch.c[i * CK + l];
    any = false;
#pragma unroll
    for (int c = 0; c < RPT; ++c) {
      if (i == 1) {
        t[c] = num[c] / (go[c] ? dn[c] : 1.f);
        go[c] = go[c] && t[c] > 0.f && t[c] < cut[c];
      }
      const float a = SHARED ? cv - t[c] * di[c] : (cv - oi[c]) - t[c] * di[c];
      go[c] = go[c] && (a >= -FUZZ) && (a <= 1.f + FUZZ);
      tot[c] = i == 1 ? a : tot[c] + a;
      any = any || go[c];
    }
    if (!__any_sync(FULL, any)) return;
  }
#pragma unroll
  for (int c = 0; c < RPT; ++c) go[c] = go[c] && (tot[c] <= 1.f + FUZZ);
}

// The lexicographic minimum of (t, l) over the four lanes of a ray (lanes
// 4g .. 4g + 3): every lane ends with it.  Lanes without a hit hold
// (INFINITY, CK).
__device__ __forceinline__ void ray_min(float& t, int& l) {
#pragma unroll
  for (int off = 1; off < SQ; off <<= 1) {
    const float ot = __shfl_xor_sync(FULL, t, off);
    const int ol = __shfl_xor_sync(FULL, l, off);
    if (ot < t || (ot == t && ol < l)) {
      t = ot;
      l = ol;
    }
  }
}

// Whether every coordinate of a ray is finite.  No pair test of another
// ray is valid, so a walk need not list it: an infinite or NaN origin
// makes every numerator infinite or NaN, so t is too (t < cut fails); an
// infinite or NaN direction makes every dn so, and t is +-0 or NaN.
template <int D>
__device__ __forceinline__ bool finite_ray(const float (&v)[D]) {
  bool f = true;
#pragma unroll
  for (int k = 0; k < D; ++k) f = f && fabsf(v[k]) < INFINITY;
  return f;
}

}  // namespace ntr
