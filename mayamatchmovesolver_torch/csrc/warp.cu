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
// float32 that is 3 x 33.2 MB, 0.030 ms at 3.35 TB/s.  Tensor cores, TMA
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
//     aligned texels; otherwise one load a channel at the image's
//     strides.  The map's channels 0 and 1 are read at its strides, as
//     one float2 where they are packed and 8-byte aligned.  The output
//     is written once with streaming stores (__stcs), one float4 a pixel
//     where it can be.  The host passes strides and pointers; the launch
//     picks the path from them.
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
// No --use_fast_math (it would contract and flush).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLOCK_W = 32;
constexpr int BLOCK_H = 8;
constexpr int MAX_GRID_Y = 65535;

enum Dtype { FLOAT32 = 0, FLOAT64 = 1 };

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

// VEC4: the image is RGBA float32 with packed, 16-byte aligned texels,
// and the output is written as one float4 a pixel.  PAIR: the map's
// channels 0 and 1 are one packed, 8-byte aligned float2.  Both are for
// T = float only.
template <typename T, bool VEC4, bool PAIR>
__global__ void __launch_bounds__(BLOCK_W * BLOCK_H)
    warp_kernel(const T* __restrict__ image, int height, int width,
                int channels, Strides is, const T* __restrict__ map,
                int out_height, int out_width, Strides ms,
                T* __restrict__ out) {
  const int col = blockIdx.x * BLOCK_W + threadIdx.x;
  const int row = blockIdx.y * BLOCK_H + threadIdx.y;
  if (col >= out_width || row >= out_height) return;

  const T* texel = map + row * ms.row + col * ms.col;
  T u, v;
  if constexpr (PAIR) {
    const float2 uv = __ldg(reinterpret_cast<const float2*>(texel));
    u = uv.x;
    v = uv.y;
  } else {
    u = __ldg(texel);
    v = __ldg(texel + ms.channel);
  }
  // UV -> pixel position, centres at whole numbers, v up:
  // x = u * w - 0.5, y = (1 - v) * h - 0.5.
  const T x = sub_rn(mul_rn(u, (T)width), (T)0.5);
  const T y = sub_rn(mul_rn(sub_rn((T)1, v), (T)height), (T)0.5);
  const T x0 = floor_of(x), y0 = floor_of(y);
  const T fx = sub_rn(x, x0), fy = sub_rn(y, y0);
  const T gx = sub_rn((T)1, fx), gy = sub_rn((T)1, fy);
  const int xa = clamp_index(x0, width), ya = clamp_index(y0, height);
  const int xb = min(xa + 1, width - 1), yb = min(ya + 1, height - 1);

  const size_t pixel = (size_t)row * out_width + col;
  if constexpr (VEC4) {
    const float4* upper =
        reinterpret_cast<const float4*>(image + ya * is.row);
    const float4* lower =
        reinterpret_cast<const float4*>(image + yb * is.row);
    const float4 top = lerp(__ldg(upper + xa), __ldg(upper + xb), fx, gx);
    const float4 bottom =
        lerp(__ldg(lower + xa), __ldg(lower + xb), fx, gx);
    __stcs(reinterpret_cast<float4*>(out) + pixel,
           lerp(top, bottom, fy, gy));
  } else {
    const T* a = image + ya * is.row + xa * is.col;
    const T* b = image + ya * is.row + xb * is.col;
    const T* c = image + yb * is.row + xa * is.col;
    const T* d = image + yb * is.row + xb * is.col;
    T* dst = out + pixel * channels;
    for (int k = 0; k < channels; ++k) {
      const long long at = k * is.channel;
      const T top = lerp(__ldg(a + at), __ldg(b + at), fx, gx);
      const T bottom = lerp(__ldg(c + at), __ldg(d + at), fx, gx);
      __stcs(dst + k, lerp(top, bottom, fy, gy));
    }
  }
}

template <typename T, bool VEC4, bool PAIR>
void launch_kernel(const void* image, int height, int width, int channels,
                   Strides is, const void* map, int out_height,
                   int out_width, Strides ms, void* out,
                   cudaStream_t stream) {
  dim3 block(BLOCK_W, BLOCK_H);
  dim3 grid((out_width + BLOCK_W - 1) / BLOCK_W,
            (out_height + BLOCK_H - 1) / BLOCK_H);
  warp_kernel<T, VEC4, PAIR><<<grid, block, 0, stream>>>(
      static_cast<const T*>(image), height, width, channels, is,
      static_cast<const T*>(map), out_height, out_width, ms,
      static_cast<T*>(out));
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream`, allocates
// nothing and does not synchronise.
//
// Resamples the (height, width, channels) image at `image` through the
// (out_height, out_width, >= 2) map at `map`, both of `dtype` (0 float32,
// 1 float64) with the strides given in elements, into the contiguous
// (out_height, out_width, channels) output at `out`.  Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a null pointer, an unknown dtype or a size
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
      (dtype != FLOAT32 && dtype != FLOAT64)) {
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
  const bool vec4 = channels == 4 && image_channel == 1 && image_col == 4 &&
                    image_row % 4 == 0 && aligned(image, 16) &&
                    aligned(out, 16);
  const bool pair = map_channel == 1 && map_col % 2 == 0 &&
                    map_row % 2 == 0 && aligned(map, 8);
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
