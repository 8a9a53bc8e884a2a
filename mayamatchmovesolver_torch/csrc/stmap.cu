// Lens ST-map kernels for Hopper (sm_90a).
//
// Replace mayamatchmovesolver_tpu/ops/stmap.py::_stmap_kernel, the Pallas
// TPU kernel.  For every output pixel they compute where that pixel
// samples the other image, for the four 3DE models, and write the RGBA
// float32 ST-map texel [S, T, B, A].  Two variants of one kernel:
//
//   mmsolver_stmap        the point comes from the pixel index and the
//                         texel [S, T, 0, 1] is written (reads nothing);
//   mmsolver_stmap_layer  the point is (S, T) of the thread's own texel
//                         of a previous layer's map, which is mapped in
//                         place; B and A carry through.  The reference
//                         leaves a lens stack's further layers to XLA;
//                         here they stay out of eager PyTorch.
//
// Every model's undistort is  post @ core(pre @ xy)  in diagonally
// normalised (dn) coordinates, with a polynomial `core` and constant 2x2
// matrices; distort inverts it as  inv(pre) @ core^-1(inv(post) @ xy),
// core^-1 by the ldpk fixed point p <- p + (t - core(p)), 1 + 20
// evaluations, no early exit.
//
// What bounds them on this card.  Distort: FP32 operations, 21 core
// evaluations a pixel on an SM's 128 FP32 lanes, each of which starts one
// operation a clock; the 16 bytes a pixel it writes take less than that
// at the card's peak rates, the 32 it moves from a map about as long, and
// the measured time follows the opcode count in both.  Undistort: the
// bytes, one 16-byte store a pixel and, from a map, one 16-byte load.
// Tensor cores, TMA and clusters have nothing to offer a
// kernel that multiplies no matrices.
//
// What the design does about it: only the arithmetic the map needs.
//   * The host (ops/stmap.py) folds everything around the core into two
//     affine maps in float64: source point (pixel index, or unit S and T)
//     -> core input, and core output -> unit texel.  Two FMAs a component,
//     no division in the kernel.
//   * Every core is  core(x, y) = (x, y) + h(x, y)  with h a polynomial
//     without a constant term (the anamorphic one as well: with
//     d = x2 - y2,  cos2*r2 = d  and  cos4*r4 = 2*d*d - r4,  so the
//     division by r2 and its guard fall away; at r2 = 0 h is 0, which is
//     what the guarded division gave).  The fixed point then folds to
//     p <- t - h(p), started at p = t:  t - (core(t) - t) = t - h(t)  is
//     the same step, so distort is 21 equal steps of FMA chains whose
//     last FMA is the update: 12 / 17 / 15 FP32 opcodes a step as
//     compiled (classic / radial / anamorphic).
//   * The iteration count is a compile-time constant
//     (-DMMSOLVER_DISTORT_ITERATIONS, from models/base.py), so the loop
//     unrolls: no counter, compare or branch.
//   * Coefficients arrive in the kernel's argument, so every FMA takes its
//     coefficient straight from the constant bank.
//   * One thread a pixel, 32x8 blocks with threadIdx.x along the width: a
//     warp's loads and stores are 512 contiguous bytes as one float4 a
//     thread; the ragged edge is masked here.  A thread keeps to one
//     pixel: at about 20 registers an SM holds 64 warps, which cover the
//     dependent FMA chain, and the SASS opcode count times the
//     pixels accounts for the time measured (PERF.md), so the lanes'
//     rate, not latency or the last wave, is what is left.
// No --use_fast_math: the result stays within 2e-5 of the plain PyTorch
// version.

#include <cuda_runtime.h>

#ifndef MMSOLVER_DISTORT_ITERATIONS
#error "build with -DMMSOLVER_DISTORT_ITERATIONS=<DISTORT_INVERSE_ITERATIONS of models/base.py>"
#endif

namespace {

enum Core { CLASSIC = 0, RADIAL_DEG4 = 1, ANAMORPHIC_DEG4 = 2 };

constexpr int BLOCK_W = 32;
constexpr int BLOCK_H = 8;
constexpr int MAX_COEFFS = 10;
constexpr int PARAM_COUNT = MAX_COEFFS + 12;

struct StmapParams {
  float c[MAX_COEFFS];  // core coefficients, model-specific order
  float a_in[4];        // row-major 2x2 and offset: source point -> core
  float b_in[2];
  float a_out[4];       // row-major 2x2 and offset: core -> unit texel
  float b_out[2];
};

// (ox, oy) = (ax, ay) + h(x, y), or with NEG (ax, ay) - h(x, y), where
// core(x, y) = (x, y) + h(x, y).  The sign rides on an FMA operand.
template <int CORE, bool NEG>
__device__ __forceinline__ void displace(const StmapParams& p, float x,
                                         float y, float ax, float ay,
                                         float* ox, float* oy) {
  const float* c = p.c;
  const float sx = NEG ? -x : x, sy = NEG ? -y : y;
  const float x2 = x * x, y2 = y * y;
  const float r2 = x2 + y2;
  if (CORE == CLASSIC) {
    // 3DE classic mixed model; c = {cxx, cxy, cyx, cyy, qx, qy}:
    // h = (x, y) * (c?x*x2 + c?y*y2 + q?*r4).
    const float r4 = r2 * r2;
    const float gx = fmaf(c[0], x2, fmaf(c[1], y2, c[4] * r4));
    const float gy = fmaf(c[2], x2, fmaf(c[3], y2, c[5] * r4));
    *ox = fmaf(sx, gx, ax);
    *oy = fmaf(sy, gy, ay);
  } else if (CORE == RADIAL_DEG4) {
    // 3DE4 radial degree 4 with decentering; c = {c2, u2, v2, c4, u4, v4}:
    // h = (x, y)*(c2*r2 + c4*r4) + (r2 + 2*x2, 2xy)*u + (2xy, r2 + 2*y2)*v
    // with u = u2 + u4*r2 and v = v2 + v4*r2.
    const float sxy = (sx + sx) * y;
    const float g = r2 * fmaf(c[3], r2, c[0]);
    const float u = fmaf(c[4], r2, c[1]);
    const float v = fmaf(c[5], r2, c[2]);
    const float wx = fmaf(2.0f, x2, r2), wy = fmaf(2.0f, y2, r2);
    *ox = fmaf(sxy, v, fmaf(NEG ? -wx : wx, u, fmaf(sx, g, ax)));
    *oy = fmaf(sxy, u, fmaf(NEG ? -wy : wy, v, fmaf(sy, g, ay)));
  } else {
    // 3DE4 anamorphic degree 4, division-free; c = {cx02, cy02, cx22,
    // cy22, cx04 - cx44, cy04 - cy44, cx24, cy24, 2*cx44, 2*cy44}:
    // h = (x, y) * (r2*(c02 + c04'*r2 + c24*d) + d*(c22 + c44'*d)),
    // d = x2 - y2.  At r2 = 0 it is 0.
    const float d = x2 - y2;
    const float gx = fmaf(r2, fmaf(c[4], r2, fmaf(c[6], d, c[0])),
                          d * fmaf(c[8], d, c[2]));
    const float gy = fmaf(r2, fmaf(c[5], r2, fmaf(c[7], d, c[1])),
                          d * fmaf(c[9], d, c[3]));
    *ox = fmaf(sx, gx, ax);
    *oy = fmaf(sy, gy, ay);
  }
}

template <int CORE, bool DISTORT, bool FROM_MAP>
__global__ void __launch_bounds__(BLOCK_W * BLOCK_H)
    stmap_kernel(float4* __restrict__ map, int width, int height,
                 const StmapParams p) {
  const int col = blockIdx.x * BLOCK_W + threadIdx.x;
  const int row = blockIdx.y * BLOCK_H + threadIdx.y;
  if (col >= width || row >= height) return;
  float4* texel = map + ((size_t)row * width + col);

  float u, v, blue = 0.0f, alpha = 1.0f;
  if (FROM_MAP) {
    const float4 m = *texel;
    u = m.x;
    v = m.y;
    blue = m.z;
    alpha = m.w;
  } else {
    u = (float)col;
    v = (float)row;
  }
  const float tx = fmaf(p.a_in[0], u, fmaf(p.a_in[1], v, p.b_in[0]));
  const float ty = fmaf(p.a_in[2], u, fmaf(p.a_in[3], v, p.b_in[1]));

  float qx = tx, qy = ty;
  if (DISTORT) {
    // p <- t - h(p) from p = t: the start and the iterations.
#pragma unroll
    for (int i = 0; i <= MMSOLVER_DISTORT_ITERATIONS; ++i) {
      float nx, ny;
      displace<CORE, true>(p, qx, qy, tx, ty, &nx, &ny);
      qx = nx;
      qy = ny;
    }
  } else {
    displace<CORE, false>(p, tx, ty, tx, ty, &qx, &qy);
  }
  const float s = fmaf(p.a_out[0], qx, fmaf(p.a_out[1], qy, p.b_out[0]));
  const float t = fmaf(p.a_out[2], qx, fmaf(p.a_out[3], qy, p.b_out[1]));
  *texel = make_float4(s, t, blue, alpha);
}

template <int CORE, bool FROM_MAP>
void launch_core(float4* map, int width, int height, bool distort,
                 const StmapParams& p, cudaStream_t stream) {
  dim3 block(BLOCK_W, BLOCK_H);
  dim3 grid((width + BLOCK_W - 1) / BLOCK_W,
            (height + BLOCK_H - 1) / BLOCK_H);
  if (distort) {
    stmap_kernel<CORE, true, FROM_MAP>
        <<<grid, block, 0, stream>>>(map, width, height, p);
  } else {
    stmap_kernel<CORE, false, FROM_MAP>
        <<<grid, block, 0, stream>>>(map, width, height, p);
  }
}

// `host_params` points to PARAM_COUNT host floats laid out as
// StmapParams.  Returns cudaGetLastError() after the launch (0 =
// launched), or cudaErrorInvalidValue for an unknown core, a bad size or
// a null pointer.
template <bool FROM_MAP>
int launch(void* map, int width, int height, int core_id, int distort,
           const float* host_params, void* stream) {
  if (map == nullptr || host_params == nullptr || width <= 0 ||
      height <= 0 || core_id < 0 || core_id > ANAMORPHIC_DEG4) {
    return (int)cudaErrorInvalidValue;
  }
  static_assert(sizeof(StmapParams) == PARAM_COUNT * sizeof(float),
                "StmapParams is PARAM_COUNT packed floats");
  StmapParams p;
  float* fields = reinterpret_cast<float*>(&p);
  for (int i = 0; i < PARAM_COUNT; ++i) fields[i] = host_params[i];

  float4* m = static_cast<float4*>(map);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (core_id) {
    case CLASSIC:
      launch_core<CLASSIC, FROM_MAP>(m, width, height, distort != 0, p, s);
      break;
    case RADIAL_DEG4:
      launch_core<RADIAL_DEG4, FROM_MAP>(m, width, height, distort != 0, p,
                                         s);
      break;
    default:
      launch_core<ANAMORPHIC_DEG4, FROM_MAP>(m, width, height, distort != 0,
                                             p, s);
      break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes.  Both launch on `stream`, allocate
// nothing and do not synchronise.

// Writes height*width float4 texels [S, T, 0, 1] to the device pointer
// `out`; the source point is the pixel index (col, row).
extern "C" int mmsolver_stmap(void* out, int width, int height, int core_id,
                              int distort, const float* host_params,
                              void* stream) {
  return launch<false>(out, width, height, core_id, distort, host_params,
                       stream);
}

// Maps the height*width float4 texels at the device pointer `map` in
// place; the source point is each texel's own (S, T).
extern "C" int mmsolver_stmap_layer(void* map, int width, int height,
                                    int core_id, int distort,
                                    const float* host_params, void* stream) {
  return launch<true>(map, width, height, core_id, distort, host_params,
                      stream);
}
