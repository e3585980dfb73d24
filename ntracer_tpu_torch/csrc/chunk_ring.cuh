// The streaming walk's loop, for pools too large to keep near the cores:
// the Hopper counterpart of the TPU kernels' `_hbm_fetch`/`_hbm_wait`
// (ntracer_tpu/engine/resident_kernels.py), shared by the STREAM variants
// of the four walks (kernels 2.5-2.8).
//
// A ring of chunk slots lives in dynamic shared memory.  Each piece of a
// chunk is one contiguous, 16-byte aligned range in global memory --
// gt[idx, :D*D, :], ci[idx, :D, :] (or the shared rows), ids[idx, 0, :]
// and opa[idx, 0, :] -- so one elected thread fills a slot with one TMA
// bulk copy per piece (cp.async.bulk ... mbarrier::complete_tx::bytes),
// counted against one mbarrier per slot (arrive.expect_tx), and every
// thread waits on that barrier's phase (try_wait.parity) before it tests
// the slot.  One step of the walk:
//   1. warp 0 picks group g + 1 with the bound from before group g's tests
//      (find_cands, as the resident walk does);
//   2. the elected thread issues that group's copies into the free slots;
//   3. every thread waits for the slot of group g's next chunk;
//   4. the block tests it, and a block sync frees the slot for a refill.
// Chunks are numbered in visit order; chunk q lands in slot q % S and is
// the (q / S)-th fill of that slot, so its barrier phase has parity
// (q / S) & 1.  A copy is issued only into a slot whose previous chunk was
// tested and followed by a block sync.  With S = 8 slots (d <= 6) the whole
// next group is in flight while the current one is tested; at d = 7 and 8
// a slot is larger and S is 6 or 7, so the next group's first chunks are.
// The visit set and every output are the resident walk's: they do not
// depend on S or on when a copy lands.

#pragma once

#include <stdint.h>

#include "pair_test.cuh"

namespace ntr {

constexpr int RING_MAX = 2 * NCAND;   // two groups in flight

// Floats of one slot: D*D plane rows, D offset rows, the id row and, for
// the transparent walks, the opacity row, CK entries each.
template <int D, bool OPA>
__host__ __device__ constexpr int slot_floats() {
  return (D * D + D + 1 + (OPA ? 1 : 0)) * CK;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

// Make the barriers' initialization visible to the async (TMA) proxy.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The elected thread's arrival: the phase completes once `bytes` bytes of
// copies have landed.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Slot s of the ring as a walk's test reads it.
template <int D, bool OPA>
__device__ __forceinline__ Chunk ring_chunk(const float* ring, int s) {
  const float* b = ring + (size_t)s * slot_floats<D, OPA>();
  return Chunk{b, b + D * D * CK,
               reinterpret_cast<const int*>(b + (D * D + D) * CK),
               OPA ? b + (D * D + D + 1) * CK : nullptr};
}

// Fill slot s with chunk idx (the elected thread only).
template <int D, bool OPA>
__device__ __forceinline__ void ring_fill(
    float* ring, uint64_t* bar, int s, int idx, const float* __restrict__ gt,
    const float* __restrict__ ci, const int* __restrict__ ids,
    const float* __restrict__ opa, int pr) {
  float* b = ring + (size_t)s * slot_floats<D, OPA>();
  mbar_expect(bar, slot_floats<D, OPA>() * 4u);
  bulk_copy(b, gt + (size_t)idx * pr * CK, D * D * CK * 4u, bar);
  bulk_copy(b + D * D * CK, ci + (size_t)idx * CP * CK, D * CK * 4u, bar);
  bulk_copy(b + (D * D + D) * CK, ids + (size_t)idx * CP * CK, CK * 4u, bar);
  if (OPA)
    bulk_copy(b + (D * D + D + 1) * CK, opa + (size_t)idx * CP * CK, CK * 4u,
              bar);
}

// The streaming walk's loop: the resident walk's visits (groups of NCAND
// candidate positions, the next group picked with the bound from before
// this group's tests), each chunk tested from its ring slot by
// `test(idx, chunk)`, a block sync after each test.  `n_slots` (2..8)
// slots of slot_floats<D, OPA>() floats each are the dynamic shared
// memory.  Returns the number of visits.
template <int D, bool OPA, class Bound, class Test>
__device__ __forceinline__ int stream_walk(
    const float* __restrict__ gt, const float* __restrict__ ci,
    const int* __restrict__ ids, const float* __restrict__ opa, int pr,
    const int* __restrict__ order, int n_eff, const float* __restrict__ emin,
    int n_slots, int* s_cand, Bound bound, Test test) {
  extern __shared__ __align__(128) float s_ring[];
  __shared__ uint64_t s_bar[RING_MAX];
  const int tid = threadIdx.x;
  if (tid < n_slots) mbar_init(&s_bar[tid]);
  mbar_fence_init();
  __syncthreads();

  int q_test = 0;    // chunks tested so far (visit order)
  int q_issue = 0;   // chunks whose copies are issued
  // issue the chunks of `list` (visit numbers base, base + 1, ...) that are
  // not issued yet and whose slot is free
  auto issue = [&](const int (&list)[NCAND], int base, int n_list) {
#pragma unroll
    for (int j = 0; j < NCAND; ++j) {
      if (j < n_list && base + j == q_issue && q_issue < q_test + n_slots) {
        if (tid == 0) {
          const int s = q_issue % n_slots;
          ring_fill<D, OPA>(s_ring, &s_bar[s], s, order[list[j]], gt, ci,
                            ids, opa, pr);
        }
        ++q_issue;
      }
    }
  };
  auto count = [](const int (&list)[NCAND]) {
    int n = 0;
#pragma unroll
    for (int j = 0; j < NCAND; ++j) n += list[j] != SENT;
    return n;
  };

  int cur[NCAND], nxt[NCAND];
  find_cands<NCAND>(0, bound(), n_eff, emin, s_cand, cur);
  int n_cur = count(cur);
  int base = 0;      // visit number of cur[0]
  issue(cur, base, n_cur);
  while (n_cur) {
    // 1. the next group, with the bound from before this group's tests
    const int kn = cur[NCAND - 1] == SENT ? n_eff : cur[NCAND - 1] + 1;
    find_cands<NCAND>(kn, bound(), n_eff, emin, s_cand, nxt);
    const int n_nxt = count(nxt);
    for (int j = 0; j < n_cur; ++j) {
      // 2. copies into the slots freed so far
      issue(cur, base, n_cur);
      issue(nxt, base + n_cur, n_nxt);
      // 3. wait for this chunk's slot, 4. test it
      const int s = q_test % n_slots;
      mbar_wait(&s_bar[s], (unsigned)(q_test / n_slots) & 1u);
      test(order[cur[j]], ring_chunk<D, OPA>(s_ring, s));
      __syncthreads();               // slot s may be refilled after this
      ++q_test;
    }
    base += n_cur;
#pragma unroll
    for (int j = 0; j < NCAND; ++j) cur[j] = nxt[j];
    n_cur = n_nxt;
  }
  return base;
}

// Ring depth and dynamic shared memory of a streaming kernel: as many
// slots as the card lets one block hold beside the kernel's static shared
// memory, at most RING_MAX; sets the kernel's dynamic shared memory limit.
template <int D, bool OPA, class Kernel>
cudaError_t ring_config(Kernel kernel, int* n_slots, int* smem_bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  const int slot = slot_floats<D, OPA>() * 4;
  int s = (optin - (int)fa.sharedSizeBytes) / slot;
  if (s > RING_MAX) s = RING_MAX;
  if (s < 2) return cudaErrorInvalidConfiguration;
  *n_slots = s;
  *smem_bytes = s * slot;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *smem_bytes);
}

}  // namespace ntr
