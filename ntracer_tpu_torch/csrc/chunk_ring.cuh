// The TMA and mbarrier primitives of the streaming walks (kernels 2.5-2.8,
// the STREAM variants of the four walk sources, and 2.4), the Hopper
// counterpart of the TPU kernels' `_hbm_fetch`/`_hbm_wait`
// (ntracer_tpu/engine/resident_kernels.py).  The loop that drives them is
// stream_walk.cuh's; grid_walk.cu's kernel 2.9 fills its own ring of
// triangle sub-tiles with them.
//
// A ring of chunk slots lives in dynamic shared memory.  Each piece of a
// chunk is one contiguous, 16-byte aligned range in global memory --
// gt[idx, :D*D, :], ci[idx, :D, :] (or the shared rows), ids[idx, 0, :]
// and opa[idx, 0, :] -- so one elected thread fills a slot with one TMA
// bulk copy per piece (cp.async.bulk ... mbarrier::complete_tx::bytes),
// counted against the slot's "full" mbarrier (arrive.expect_tx), and every
// thread waits on that barrier's phase (try_wait.parity) before it tests
// the slot.

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

__device__ __forceinline__ void mbar_init_count(uint64_t* bar,
                                                unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
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

// Order this thread's generic-proxy writes to shared memory before the
// async proxy's (TMA) writes that follow.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
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

}  // namespace ntr
