// The frame's post-walk glue in one kernel, for Hopper (sm_90a): from the
// nearest-hit walk's outputs to the frame's packed pixel bytes, for an
// opaque, unlit frame without bounces (`wavefront._glue_fused` says which
// frames).
//
// Replaces no Pallas kernel.  The JAX package left this chain to XLA's
// fusion (ntracer_tpu/engine/wavefront.py:1042 `aabb_distance_T`, :1065
// `shade_local_T`; ntracer_tpu/engine/packing.py:114
// `pack_device_stream`), and the port first ran it as whole-frame torch
// ops, one (d, R) or (R,) pass each: about d * (6 + 6 d) passes for the
// scene-box distance alone, so ~660 kernels at d = 10 over 2M rays.  Its
// plain PyTorch version is `wavefront._shade_pack_ref`, the chain itself;
// kernel and plain version agree byte for byte.
//
// What it computes, one thread a ray (as `_trace_walk`, `_trace_close`,
// `aabb_distance_T`, `shade_local_T`, `background_T`, the bounce loop's
// first step and `packing._pack_words` / `pack_device_stream` do):
//   * the hit: the walk's key (a slot of `res_slot_pack` for the chunk
//     walks, a pool-local id for the grid walk), its row (the face normal,
//     the material and, for a slot, the pool id) and the view-facing unit
//     normal;
//   * the scene-box distance: the first axis in order whose boundary plane
//     the ray meets inside the box, a negative distance clamped to 0 and
//     then axis i checked too; a ray that meets none is no hit;
//   * the camera light (ambient + material color x the clamped cosine, the
//     Blinn-Phong highlight with the power taken in double and rounded to
//     float), the reflectivity's share, the background gradient for a miss;
//   * the format's channels: the weighted sum left to right, the clamp,
//     the exact Fast2Sum lround of an integer channel (<= 23 bits) or the
//     float channel's bits, MSB-first 32-bit words, `reversed`; the pixel's
//     bytes go to its linear position in the frame (the ray's group and the
//     group's 32 x 16-pixel tile swizzle, `wavefront._ray_coords`), so the
//     stream needs no unswizzle pass.
// Every float32 operation is the chain's, in its order (sums left to
// right), under --fmad=false with IEEE division and square root.
//
// What bounds it.  Bytes: a ray reads its key (4 B) and its direction (4 d
// B), gathers one row of d + 2 floats and one material row from tables
// that sit in L2, and writes bpp bytes: ~50 B a ray at d = 10 in 16-bit
// RGB, ~0.1 GB for a 1920 x 1080 frame, ~0.03 ms at 3.35 TB/s.  The float
// work (~d * (4 d + 4) operations for the box, a few dozen for the rest)
// is under that at 33.45e12 instructions/s.  The design keeps to one pass:
// the ray's direction, origin and normal stay in registers (templated on d
// = 3..16, so every loop runs at the exact width), the origin is the
// frame's one camera origin (a broadcast load, not a (d, R) read), a missed
// ray skips the box and the shading, and the pixel's bytes go out in the
// widest aligned stores bpp allows, so a warp's 32 neighbouring pixels fill
// one contiguous run of bytes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// channels of a format: render.MAX_PIXELSIZE (16) bytes of 1-bit channels
constexpr int MAX_CHANNELS = 128;
constexpr int MAX_WORDS = 4;     // 32-bit words of a 16-byte pixel
constexpr int MAX_RUNS = 4;      // runs of equal groups: a frame's slabs

// The pixel format, copied by value into the launch (a __grid_constant__
// parameter: its channels are read in place, by a run-time index).
struct Format {
  int n;                         // channels
  int bpp;                       // bytes a pixel
  int reverse;                   // byte order flipped
  int bits[MAX_CHANNELS];
  int tfloat[MAX_CHANNELS];
  float f[MAX_CHANNELS][4];      // f_r, f_g, f_b, f_c
};

// The frame's ray groups as runs of equal groups: run q starts at ray
// first[q] and holds groups of count[q] rays, each in tile order when
// swz[q] (tiles of tile_w x tile_h pixels over rows w pixels wide).
struct Layout {
  int n_runs;
  int first[MAX_RUNS];
  int count[MAX_RUNS];
  int swz[MAX_RUNS];
  int w, tile_w, tile_h;
};

// The scene's rows and the frame's flags.
struct Scene {
  const float* rows;             // res_slot_pack (d + 2) or tri_pack (d + 1)
  int row_w, n_rows, grid;       // grid: the key is a pool-local id
  const int* tri_base;
  const float* bstart;           // the scene box
  const float* bend;
  const float* mat;              // mat_pack
  int mat_w;
  const float* ambient;
  const float* bg1;
  const float* bg2;
  const float* bg3;
  int bg_axis, camera_light, max_reflect_depth;
};

// torch.clamp's rule: NaN stays NaN
__device__ __forceinline__ float clamp_min0(float v) {
  return isnan(v) ? v : fmaxf(v, 0.f);
}

__device__ __forceinline__ float clamp01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.f), 1.f);
}

// word q of w |= v, with q known only at run time (w stays in registers)
__device__ __forceinline__ void or_word(long long (&w)[MAX_WORDS], int q,
                                        long long v) {
#pragma unroll
  for (int i = 0; i < MAX_WORDS; ++i)
    if (i == q) w[i] |= v;
}

__device__ __forceinline__ long long get_word(const long long (&w)[MAX_WORDS],
                                              int q) {
  long long v = 0;
#pragma unroll
  for (int i = 0; i < MAX_WORDS; ++i)
    if (i == q) v = w[i];
  return v;
}

// Byte jj of the packed pixel as it lies in memory (`pack_device_stream`:
// MSB-first words, `reverse` flips the pixel's bytes).
__device__ __forceinline__ unsigned byte_at(const long long (&w)[MAX_WORDS],
                                            const Format& fmt, int jj) {
  const int j = fmt.reverse ? fmt.bpp - 1 - jj : jj;
  return (unsigned)((get_word(w, j >> 2) >> (8 * (3 - (j & 3)))) & 0xFF);
}

// The linear pixel of ray r: its group and, in a swizzled group, its
// place in the group's rows (`_ray_coords`' unswizzle).
__device__ __forceinline__ long long linear_pixel(int r, const Layout& lay) {
  int q = 0;
  while (q + 1 < lay.n_runs && r >= lay.first[q + 1]) ++q;
  const int count = lay.count[q];
  const int start = lay.first[q] + (r - lay.first[q]) / count * count;
  if (!lay.swz[q]) return r;
  const int j = r - start;
  const int tpr = lay.w / lay.tile_w;
  const int per_tile = lay.tile_w * lay.tile_h;
  const int tile = j / per_tile;
  const int within = j % per_tile;
  const int x = (tile % tpr) * lay.tile_w + within % lay.tile_w;
  const int y = (tile / tpr) * lay.tile_h + within / lay.tile_w;
  return (long long)start + (long long)y * lay.w + x;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    shade_pack_kernel(const int* __restrict__ key,
                      const float* __restrict__ origin,
                      const float* __restrict__ dT, int R, const Scene s,
                      const __grid_constant__ Format fmt,
                      const __grid_constant__ Layout lay,
                      unsigned char* __restrict__ out) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= R) return;

  float dv[D], o[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    dv[i] = dT[(size_t)i * R + r];
    o[i] = origin[i];
  }

  // the hit rows (`_trace_walk`) and `_trace_close`'s hit
  const int k = key[r];
  const int tb = *s.tri_base;
  int pid, ri;
  if (s.grid) {
    pid = k >= 0 ? k + tb : -1;
    ri = min(max(pid - tb, 0), s.n_rows - 1);
  } else {
    ri = max(k, 0);
  }
  const float* row = s.rows + (size_t)ri * s.row_w;
  if (!s.grid) pid = k >= 0 ? (int)row[D + 1] + tb : -1;
  bool hit = pid >= 0;

  // `aabb_distance_T`: the first axis in order that is ok; hit &= dist >= 0
  if (hit) {
    float dist = -1.f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float oo = dv[i] > 0.f ? s.bstart[i] : s.bend[i];
      const float di = (oo - o[i]) / dv[i];
      const bool neg = di < 0.f;
      const float de = neg ? 0.f : di;
      bool ok = dv[i] != 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const float v = dv[j] * de + o[j];
        const bool inside = (v < s.bend[j]) & (v > s.bstart[j]);
        ok = ok & (j == i ? (!neg | inside) : inside);
      }
      if (ok) {
        dist = de;
        break;
      }
    }
    hit = dist >= 0.f;
  }

  float color[3];
  if (hit) {
    // the view-facing unit normal and the cosine toward the camera
    float fn[D];
#pragma unroll
    for (int i = 0; i < D; ++i) fn[i] = row[i];
    float denom = fn[0] * dv[0];
    float ss = fn[0] * fn[0];
#pragma unroll
    for (int i = 1; i < D; ++i) {
      denom = denom + fn[i] * dv[i];
      ss = ss + fn[i] * fn[i];
    }
    const float len = sqrtf(ss);
    const float sg = denom > 0.f ? -1.f : 1.f;
    float dot = dv[0] * ((fn[0] / len) * sg);
#pragma unroll
    for (int i = 1; i < D; ++i) dot = dot + dv[i] * ((fn[i] / len) * sg);
    const float sine = -dot;

    // `shade_local_T` without point or global lights
    const float* m = s.mat + (size_t)(int)row[D] * s.mat_w;
    float light = 0.f;
    float spec[3] = {0.f, 0.f, 0.f};
    float spec_a = 0.f;
    if (s.camera_light) {
      const float cl = clamp_min0(sine);
      light = 0.f + cl;
      // the highlight, where the chain's mask takes it
      if ((sine > 0.f) & (m[8] != 0.f)) {
        const float base = (float)pow((double)cl, (double)m[9]) * m[8];
        const float keep = 1.f - spec_a;
        const float new_a = spec_a + base * keep;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          spec[c] = (spec[c] + m[3 + c] * (base * keep)) * new_a;
        spec_a = new_a;
      }
    }
    const float refl = m[7];
    const float refl_eff =
        (refl != 0.f) & (0 < s.max_reflect_depth) ? refl : 0.f;
    const float share = (1.f - spec_a) * (1.f - refl_eff);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      color[c] = spec[c] + share * (s.ambient[c] + m[c] * light);
  } else {
    // `background_T`
    const float it = dT[(size_t)s.bg_axis * R + r];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float pos = s.bg1[c] * it + s.bg2[c] * (1.f - it);
      const float neg = s.bg3[c] * (-it) + s.bg2[c] * (1.f + it);
      color[c] = it >= 0.f ? pos : neg;
    }
  }
  // the bounce loop's one step: out = 0 + weight * color, weight 1
#pragma unroll
  for (int c = 0; c < 3; ++c) color[c] = 0.f + 1.f * color[c];

  // `_pack_words`
  long long w[MAX_WORDS] = {0, 0, 0, 0};
  int off = 0;
  for (int ch = 0; ch < fmt.n; ++ch) {
    const int bits = fmt.bits[ch];
    const float val = clamp01(((color[0] * fmt.f[ch][0] +
                                color[1] * fmt.f[ch][1]) +
                               color[2] * fmt.f[ch][2]) +
                              fmt.f[ch][3]);
    long long ival;
    if (fmt.tfloat[ch]) {
      ival = (long long)__float_as_uint(val);
    } else {
      // exact lround(double(val) * (2^b - 1)), as `_pack_words` takes it
      const float p_hi = val * (float)(1 << bits);
      const float p = p_hi - val;
      const float err = (p_hi - p) - val;
      const float q = p + 0.5f;
      float i0 = floorf(q);
      const float frac = (q - i0) + err;
      i0 = (i0 + (frac >= 1.f ? 1.f : 0.f)) - (frac < 0.f ? 1.f : 0.f);
      ival = (long long)i0;
    }
    const int o_w = off >> 5;
    const int rm = off & 31;
    const int sh = 32 - rm - bits;
    or_word(w, o_w,
            sh >= 0 ? (long long)((unsigned long long)ival << sh)
                    : ival >> -sh);
    if (rm + bits > 32)
      or_word(w, o_w + 1,
              (long long)((unsigned long long)ival << (64 - rm - bits)) &
                  0xFFFFFFFFll);
    off += bits;
  }

  // the pixel's bytes at its linear place, in the widest aligned stores
  unsigned char* px = out + linear_pixel(r, lay) * fmt.bpp;
  if ((fmt.bpp & 3) == 0) {
    for (int jj = 0; jj < fmt.bpp; jj += 4)
      *(unsigned*)(px + jj) = byte_at(w, fmt, jj) |
                              byte_at(w, fmt, jj + 1) << 8 |
                              byte_at(w, fmt, jj + 2) << 16 |
                              byte_at(w, fmt, jj + 3) << 24;
  } else if ((fmt.bpp & 1) == 0) {
    for (int jj = 0; jj < fmt.bpp; jj += 2)
      *(unsigned short*)(px + jj) =
          (unsigned short)(byte_at(w, fmt, jj) | byte_at(w, fmt, jj + 1) << 8);
  } else {
    for (int jj = 0; jj < fmt.bpp; ++jj)
      px[jj] = (unsigned char)byte_at(w, fmt, jj);
  }
}

template <int D>
int launch(const int* key, const float* origin, const float* dT, int R,
           const Scene& s, const Format& fmt, const Layout& lay,
           unsigned char* out, cudaStream_t stream) {
  shade_pack_kernel<D><<<(R + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      key, origin, dT, R, s, fmt, lay, out);
  return (int)cudaGetLastError();
}

}  // namespace

#define NTR_SHADE_DS(X)                                                     \
  X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15)    \
  X(16)

extern "C" {

// Launch the post-walk glue on `stream` for R primary rays of one origin
// (d,), directions dT (d, R), 3 <= d <= 16.  key (R,) i32: the walk's slot
// (grid 0; rows the (n_rows, d + 2) res_slot_pack) or pool-local id (grid
// 1; rows the (n_rows, d + 1) tri_pack), -1 on a miss; tri_base one i32;
// bstart, bend (d,) the scene box; mat (n, mat_w) mat_pack; ambient, bg1,
// bg2, bg3 3 floats each, all on the device.  From host memory, copied into
// the launch: chan_int (n_channels, 2) = (bits, tfloat), chan_f
// (n_channels, 4) = (f_r, f_g, f_b, f_c), runs (n_runs, 4) = (first ray,
// rays a group, groups, swizzled).  out: R * bpp bytes, each pixel's at
// its linear place.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for what the kernel does not take.
int ntr_shade_pack(const int* key, int grid, const float* rows, int row_w,
                   int n_rows, const int* tri_base, const float* origin,
                   const float* dT, int R, int d, const float* bstart,
                   const float* bend, const float* mat, int mat_w,
                   const float* ambient, const float* bg1, const float* bg2,
                   const float* bg3, int bg_axis, int camera_light,
                   int max_reflect_depth, const int* chan_int,
                   const float* chan_f, int n_channels, int bpp, int reverse,
                   const int* runs, int n_runs, int w, int tile_w, int tile_h,
                   unsigned char* out, void* stream) {
  if (R <= 0 || n_channels < 1 || n_channels > MAX_CHANNELS || bpp < 1 ||
      bpp > 4 * MAX_WORDS || n_runs < 1 || n_runs > MAX_RUNS ||
      bg_axis < 0 || bg_axis >= d || n_rows < 1 || row_w < d + 1 + !grid ||
      mat_w < 10)
    return (int)cudaErrorInvalidValue;
  Scene s = {rows, row_w, n_rows, grid, tri_base, bstart, bend, mat, mat_w,
             ambient, bg1, bg2, bg3, bg_axis, camera_light,
             max_reflect_depth};
  Format fmt;
  fmt.n = n_channels;
  fmt.bpp = bpp;
  fmt.reverse = reverse;
  int bits = 0;
  for (int c = 0; c < n_channels; ++c) {
    fmt.bits[c] = chan_int[2 * c];
    fmt.tfloat[c] = chan_int[2 * c + 1];
    if (fmt.bits[c] < 1 || fmt.bits[c] > (fmt.tfloat[c] ? 32 : 23))
      return (int)cudaErrorInvalidValue;
    bits += fmt.bits[c];
    for (int i = 0; i < 4; ++i) fmt.f[c][i] = chan_f[4 * c + i];
  }
  if (bits > 8 * bpp) return (int)cudaErrorInvalidValue;
  Layout lay;
  lay.n_runs = n_runs;
  lay.w = w;
  lay.tile_w = tile_w;
  lay.tile_h = tile_h;
  long long rays = 0;
  for (int q = 0; q < n_runs; ++q) {
    lay.first[q] = runs[4 * q];
    lay.count[q] = runs[4 * q + 1];
    lay.swz[q] = runs[4 * q + 3];
    if (lay.first[q] != rays || lay.count[q] < 1 || runs[4 * q + 2] < 1)
      return (int)cudaErrorInvalidValue;
    rays += (long long)lay.count[q] * runs[4 * q + 2];
  }
  if (rays != R) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define NTR_CASE(DD)                                                        \
  case DD:                                                                  \
    return launch<DD>(key, origin, dT, R, s, fmt, lay, out, st);
  switch (d) {
    NTR_SHADE_DS(NTR_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NTR_CASE
}

}  // extern "C"
