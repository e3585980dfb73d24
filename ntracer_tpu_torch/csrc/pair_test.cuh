// The ground shared by the chunk walks (nearest_hit.cu, occluded.cu,
// nearest_hit_transparent.cu, occluded_transparent.cu, all on
// stream_walk.cuh's loop) and the ring of chunk_ring.cuh, so they cannot
// drift apart: the constants, NaN-propagating min/max, the slab entry of a
// ray into a chunk box, a ray's load and the view of one chunk.  The walk
// itself -- entry minima, candidate scan, the pair test -- is
// stream_walk.cuh's.
//
// One CUDA block walks one 512-ray block.  Everything here rounds every
// operation (build with --fmad=false and IEEE division, see
// engine/_build.py), as the plain PyTorch twins in
// ntracer_tpu_torch/engine/resident_kernels.py do (`_entry_all`).

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

// One chunk in shared memory, as a walk's test reads it: D*D plane rows,
// D offset rows, the pool id row and (transparent walks) the opacity row,
// CK entries each.
struct Chunk {
  const float* g;
  const float* c;
  const int* id;
  const float* opa;
};

}  // namespace ntr
