// Image warp through an ST map for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package warps in XLA
// (mayamatchmovesolver_tpu/ops/warp.py::_bilinear_sample), and the port
// first ran the same gathers and lerps as some 33 eager PyTorch kernels a
// call over full-size intermediates.  This is ops/warp.py::warp_image on
// a CUDA device in one launch: for every destination pixel, read the
// source UV from the map, gather the four taps of the image around it
// and blend them.
//
// What bounds it on this card: the bytes.  A pixel reads its map texel,
// four image taps that its neighbours mostly share (each texel of a
// smooth map is read about once from device memory), and writes its
// output texel; a handful of operations against that.  At 1920x1080 RGBA
// float32 that is 3 x 33.2 MB, 0.030 ms at 3.35 TB/s; at 8640x5760 with an
// RGBA half image, 796 + 398 + 796 MB, 0.594 ms.  Tensor cores, TMA
// and shared memory have nothing to offer: the gathers are irregular but
// local, which is what the L1 and L2 are for.
//
// What the design does about it:
//   * One thread a destination pixel in 32x8 blocks, threadIdx.x along
//     the width: neighbouring threads read neighbouring map texels and,
//     through a smooth map, neighbouring image taps, so a warp's loads
//     coalesce and the taps a block shares hit in L1.
//   * The image's taps go through the read-only path (__ldg), as one
//     float4 each where the image is RGBA float32 with packed, 16-byte
//     aligned texels (RGBA half: 8 bytes, four halves, 8-byte aligned);
//     otherwise one load a channel at the image's strides.  The map's
//     channels 0 and 1 are read at its strides, as one float2 where they
//     are packed and 8-byte aligned.  The output is written once with
//     streaming stores (__stcs), one float4 a pixel where it can be.  The
//     host passes strides and pointers; the launch picks the path from
//     them.
//   * The arithmetic is the eager code's, rounding for rounding: every
//     product, difference and sum is rounded on its own (__fmul_rn,
//     __fsub_rn, __fadd_rn), so nvcc contracts nothing into an FMA.
//     Beyond the image's left and top edges the clamped taps jump at
//     every whole pixel, so a sample position one ulp off there can move
//     an output by a whole image value; with the eager positions, bit
//     for bit, the two agree exactly.  The indices are clamped, not the
//     weights, and the blend is two row lerps, then one column lerp.
//     A NaN UV gives a NaN output (its fraction is NaN; its indices
//     clamp to 0).
//   * A half image (an OpenEXR plate's pixels) is read as half and blended
//     in float, through a float32 map into a float32 output, as the eager
//     code promotes float16 with float32: each tap is widened exactly
//     (__half2float), then the same roundings.  Its own kernel,
//     warp_kernel<__half, PACKED>, leaves the float instantiations as
//     they were; its two paths are RGBA with a packed map, and strided.
// No --use_fast_math (it would contract and flush).

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLOCK_W = 32;
constexpr int BLOCK_H = 8;
constexpr int MAX_GRID_Y = 65535;

// The image's and the map's types: both float32, both float64, or a
// float16 image with a float32 map (and a float32 output).
enum Dtype { FLOAT32 = 0, FLOAT64 = 1, FLOAT16_IMAGE = 2 };

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float floor_of(float a) { return floorf(a); }
__device__ __forceinline__ double floor_of(double a) { return floor(a); }
// fmaxf and fmax return the number where one operand is NaN.
__device__ __forceinline__ float clamp_of(float a, float hi) {
  return fminf(fmaxf(a, 0.0f), hi);
}
__device__ __forceinline__ double clamp_of(double a, double hi) {
  return fmin(fmax(a, 0.0), hi);
}

// a * (1 - f) + b * f, with 1 - f given as g.
template <typename T>
__device__ __forceinline__ T lerp(T a, T b, T f, T g) {
  return add_rn(mul_rn(a, g), mul_rn(b, f));
}

__device__ __forceinline__ float4 lerp(float4 a, float4 b, float f,
                                       float g) {
  return make_float4(lerp(a.x, b.x, f, g), lerp(a.y, b.y, f, g),
                     lerp(a.z, b.z, f, g), lerp(a.w, b.w, f, g));
}

// The whole number `p` as an index clamped to [0, n - 1]; NaN gives 0.
// Clamping the float first is what the eager code's saturating cast to
// int64 and clamp give.
template <typename T>
__device__ __forceinline__ int clamp_index(T p, int n) {
  return (int)clamp_of(p, (T)(n - 1));
}

struct Strides {
  long long row, col, channel;  // in elements
};

// Where a destination pixel samples the image, from its map texel: the
// two columns and the two rows of its taps, clamped, the fractions toward
// the second of each (fx, fy) and one minus them (gx, gy).
template <typename T>
struct Taps {
  int xa, xb, ya, yb;
  T fx, gx, fy, gy;
};

// PAIR: the map's channels 0 and 1 are one packed, 8-byte aligned float2
// (T = float only); otherwise they lie `map_channel` elements apart.
template <typename T, bool PAIR>
__device__ __forceinline__ Taps<T> taps_at(const T* texel,
                                           long long map_channel,
                                           int height, int width) {
  T u, v;
  if constexpr (PAIR) {
    const float2 uv = __ldg(reinterpret_cast<const float2*>(texel));
    u = uv.x;
    v = uv.y;
  } else {
    u = __ldg(texel);
    v = __ldg(texel + map_channel);
  }
  // UV -> pixel position, centres at whole numbers, v up:
  // x = u * w - 0.5, y = (1 - v) * h - 0.5.
  const T x = sub_rn(mul_rn(u, (T)width), (T)0.5);
  const T y = sub_rn(mul_rn(sub_rn((T)1, v), (T)height), (T)0.5);
  const T x0 = floor_of(x), y0 = floor_of(y);
  Taps<T> t;
  t.fx = sub_rn(x, x0);
  t.fy = sub_rn(y, y0);
  t.gx = sub_rn((T)1, t.fx);
  t.gy = sub_rn((T)1, t.fy);
  t.xa = clamp_index(x0, width);
  t.ya = clamp_index(y0, height);
  t.xb = min(t.xa + 1, width - 1);
  t.yb = min(t.ya + 1, height - 1);
  return t;
}

// VEC4: the image is RGBA float32 with packed, 16-byte aligned texels,
// and the output is written as one float4 a pixel.  PAIR: as taps_at's.
// Both are for T = float only.
template <typename T, bool VEC4, bool PAIR>
__global__ void __launch_bounds__(BLOCK_W * BLOCK_H)
    warp_kernel(const T* __restrict__ image, int height, int width,
                int channels, Strides is, const T* __restrict__ map,
                int out_height, int out_width, Strides ms,
                T* __restrict__ out) {
  const int col = blockIdx.x * BLOCK_W + threadIdx.x;
  const int row = blockIdx.y * BLOCK_H + threadIdx.y;
  if (col >= out_width || row >= out_height) return;

  const Taps<T> t = taps_at<T, PAIR>(map + row * ms.row + col * ms.col,
                                     ms.channel, height, width);
  const size_t pixel = (size_t)row * out_width + col;
  if constexpr (VEC4) {
    const float4* upper =
        reinterpret_cast<const float4*>(image + t.ya * is.row);
    const float4* lower =
        reinterpret_cast<const float4*>(image + t.yb * is.row);
    const float4 top =
        lerp(__ldg(upper + t.xa), __ldg(upper + t.xb), t.fx, t.gx);
    const float4 bottom =
        lerp(__ldg(lower + t.xa), __ldg(lower + t.xb), t.fx, t.gx);
    __stcs(reinterpret_cast<float4*>(out) + pixel,
           lerp(top, bottom, t.fy, t.gy));
  } else {
    const T* a = image + t.ya * is.row + t.xa * is.col;
    const T* b = image + t.ya * is.row + t.xb * is.col;
    const T* c = image + t.yb * is.row + t.xa * is.col;
    const T* d = image + t.yb * is.row + t.xb * is.col;
    T* dst = out + pixel * channels;
    for (int k = 0; k < channels; ++k) {
      const long long at = k * is.channel;
      const T top = lerp(__ldg(a + at), __ldg(b + at), t.fx, t.gx);
      const T bottom = lerp(__ldg(c + at), __ldg(d + at), t.fx, t.gx);
      __stcs(dst + k, lerp(top, bottom, t.fy, t.gy));
    }
  }
}

// The four halves of an 8-byte RGBA tap, each widened exactly to float
// (channel 0 in the low bits).
__device__ __forceinline__ float4 widen(uint2 bits) {
  return make_float4(
      __half2float(__ushort_as_half((unsigned short)(bits.x & 0xffffu))),
      __half2float(__ushort_as_half((unsigned short)(bits.x >> 16))),
      __half2float(__ushort_as_half((unsigned short)(bits.y & 0xffffu))),
      __half2float(__ushort_as_half((unsigned short)(bits.y >> 16))));
}

// A half image (I = __half) through a float32 map into a float32 output,
// blended as warp_kernel<float, ...> blends.  PACKED: the image is RGBA
// with packed, 8-byte aligned texels (one 8-byte load a tap), the map's
// UV a packed float2 and the output written as one float4 a pixel;
// otherwise a load a channel at the image's strides and the map's.
template <typename I, bool PACKED>
__global__ void __launch_bounds__(BLOCK_W * BLOCK_H)
    warp_kernel(const I* __restrict__ image, int height, int width,
                int channels, Strides is, const float* __restrict__ map,
                int out_height, int out_width, Strides ms,
                float* __restrict__ out) {
  const int col = blockIdx.x * BLOCK_W + threadIdx.x;
  const int row = blockIdx.y * BLOCK_H + threadIdx.y;
  if (col >= out_width || row >= out_height) return;

  const Taps<float> t = taps_at<float, PACKED>(
      map + row * ms.row + col * ms.col, ms.channel, height, width);
  const size_t pixel = (size_t)row * out_width + col;
  if constexpr (PACKED) {
    const uint2* upper =
        reinterpret_cast<const uint2*>(image + t.ya * is.row);
    const uint2* lower =
        reinterpret_cast<const uint2*>(image + t.yb * is.row);
    const float4 top = lerp(widen(__ldg(upper + t.xa)),
                            widen(__ldg(upper + t.xb)), t.fx, t.gx);
    const float4 bottom = lerp(widen(__ldg(lower + t.xa)),
                               widen(__ldg(lower + t.xb)), t.fx, t.gx);
    __stcs(reinterpret_cast<float4*>(out) + pixel,
           lerp(top, bottom, t.fy, t.gy));
  } else {
    const I* a = image + t.ya * is.row + t.xa * is.col;
    const I* b = image + t.ya * is.row + t.xb * is.col;
    const I* c = image + t.yb * is.row + t.xa * is.col;
    const I* d = image + t.yb * is.row + t.xb * is.col;
    float* dst = out + pixel * channels;
    for (int k = 0; k < channels; ++k) {
      const long long at = k * is.channel;
      const float top = lerp(__half2float(__ldg(a + at)),
                             __half2float(__ldg(b + at)), t.fx, t.gx);
      const float bottom = lerp(__half2float(__ldg(c + at)),
                                __half2float(__ldg(d + at)), t.fx, t.gx);
      __stcs(dst + k, lerp(top, bottom, t.fy, t.gy));
    }
  }
}

dim3 grid_of(int out_height, int out_width) {
  return dim3((out_width + BLOCK_W - 1) / BLOCK_W,
              (out_height + BLOCK_H - 1) / BLOCK_H);
}

template <typename T, bool VEC4, bool PAIR>
void launch_kernel(const void* image, int height, int width, int channels,
                   Strides is, const void* map, int out_height,
                   int out_width, Strides ms, void* out,
                   cudaStream_t stream) {
  warp_kernel<T, VEC4, PAIR>
      <<<grid_of(out_height, out_width), dim3(BLOCK_W, BLOCK_H), 0,
         stream>>>(static_cast<const T*>(image), height, width, channels,
                   is, static_cast<const T*>(map), out_height, out_width,
                   ms, static_cast<T*>(out));
}

template <bool PACKED>
void launch_half(const void* image, int height, int width, int channels,
                 Strides is, const void* map, int out_height, int out_width,
                 Strides ms, void* out, cudaStream_t stream) {
  warp_kernel<__half, PACKED>
      <<<grid_of(out_height, out_width), dim3(BLOCK_W, BLOCK_H), 0,
         stream>>>(static_cast<const __half*>(image), height, width,
                   channels, is, static_cast<const float*>(map), out_height,
                   out_width, ms, static_cast<float*>(out));
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream`, allocates
// nothing and does not synchronise.
//
// Resamples the (height, width, channels) image at `image` through the
// (out_height, out_width, >= 2) map at `map`, with the strides given in
// elements, into the contiguous (out_height, out_width, channels) output
// at `out`.  `dtype` gives their types: 0 all float32, 1 all float64,
// 2 a float16 image with a float32 map and output.  Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a null pointer, any other `dtype` or a size
// out of range.
extern "C" int mmsolver_warp(const void* image, int height, int width,
                             int channels, long long image_row,
                             long long image_col, long long image_channel,
                             const void* map, int out_height, int out_width,
                             long long map_row, long long map_col,
                             long long map_channel, void* out, int dtype,
                             void* stream) {
  if (image == nullptr || map == nullptr || out == nullptr || height <= 0 ||
      width <= 0 || channels <= 0 || out_height <= 0 || out_width <= 0 ||
      (out_height + BLOCK_H - 1) / BLOCK_H > MAX_GRID_Y ||
      (dtype != FLOAT32 && dtype != FLOAT64 && dtype != FLOAT16_IMAGE)) {
    return (int)cudaErrorInvalidValue;
  }
  const Strides is{image_row, image_col, image_channel};
  const Strides ms{map_row, map_col, map_channel};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == FLOAT64) {
    launch_kernel<double, false, false>(image, height, width, channels, is,
                                        map, out_height, out_width, ms, out,
                                        s);
    return (int)cudaGetLastError();
  }
  // RGBA texels packed along the row, and the map's UV a packed float2.
  const bool rgba = channels == 4 && image_channel == 1 && image_col == 4 &&
                    image_row % 4 == 0 && aligned(out, 16);
  const bool pair = map_channel == 1 && map_col % 2 == 0 &&
                    map_row % 2 == 0 && aligned(map, 8);
  if (dtype == FLOAT16_IMAGE) {
    if (rgba && pair && aligned(image, 8)) {
      launch_half<true>(image, height, width, channels, is, map, out_height,
                        out_width, ms, out, s);
    } else {
      launch_half<false>(image, height, width, channels, is, map,
                         out_height, out_width, ms, out, s);
    }
    return (int)cudaGetLastError();
  }
  const bool vec4 = rgba && aligned(image, 16);
  if (vec4 && pair) {
    launch_kernel<float, true, true>(image, height, width, channels, is, map,
                                     out_height, out_width, ms, out, s);
  } else if (vec4) {
    launch_kernel<float, true, false>(image, height, width, channels, is,
                                      map, out_height, out_width, ms, out, s);
  } else if (pair) {
    launch_kernel<float, false, true>(image, height, width, channels, is,
                                      map, out_height, out_width, ms, out, s);
  } else {
    launch_kernel<float, false, false>(image, height, width, channels, is,
                                       map, out_height, out_width, ms, out,
                                       s);
  }
  return (int)cudaGetLastError();
}
