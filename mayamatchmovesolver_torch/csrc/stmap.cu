// Lens ST-map kernels for Hopper (sm_90a).
//
// Replace mayamatchmovesolver_tpu/ops/stmap.py::_stmap_kernel, the Pallas
// TPU kernel.  For every output pixel they compute where that pixel
// samples the other image, for the four 3DE models, and write the RGBA
// float32 ST-map texel [S, T, B, A].  Two variants of one kernel:
//
//   mmsolver_stmap        the first layer's point comes from the pixel
//                         index and the texel [S, T, 0, 1] is written
//                         (reads nothing); every further layer maps the
//                         map in place;
//   mmsolver_stmap_layer  every layer's point is (S, T) of the thread's
//                         own texel of a previous layer's map, which is
//                         mapped in place; B and A carry through.  The
//                         reference leaves a lens stack's further layers
//                         to XLA; here they stay out of eager PyTorch.
//
// Either maps an undistort stack of two or more layers in one launch of
// stmap_stack_kernel, which chains the layers in registers: from the
// pixel index (mmsolver_stmap) or from the map (mmsolver_stmap_layer).
//
// Both take the lens as its fields (ops/stmap.py::_field_records): each
// a device address (a lens held in tensors on the card) or a host double.
// One launch of pack_params_kernel folds them in float64 into PARAM_COUNT
// floats a layer in a device buffer, and each map launch that follows
// reads its layer's floats from there.  Nothing is read back to the host,
// so the host never waits for the card before a map.
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
// An undistort stack too: a layer needs 16 + 18 / 28 / 26 operations a
// pixel (an FMA as two), so two layers take a quarter of the time of
// their 16 bytes (eight anamorphic ones about equal it), and a
// launch a layer would write the map once and read and write it again
// for every further layer, 16 + 32 (layers - 1) bytes a pixel.
// Tensor cores, TMA and clusters have nothing to offer a
// kernel that multiplies no matrices.
//
// What the design does about it: only the arithmetic the map needs.
//   * pack_params_kernel folds everything around the core into two
//     affine maps in float64: source point (pixel index, or unit S and T)
//     -> core input, and core output -> unit texel.  Two FMAs a component,
//     no division in the map kernel.
//   * Every core is  core(x, y) = (x, y) + h(x, y)  with h a polynomial
//     without a constant term (the anamorphic one as well: with
//     d = x2 - y2,  cos2*r2 = d  and  cos4*r4 = 2*d*d - r4,  so the
//     division by r2 and its guard fall away; at r2 = 0 h is 0, which is
//     what the guarded division gave).  The fixed point then folds to
//     p <- t - h(p), started at p = t:  t - (core(t) - t) = t - h(t)  is
//     the same step, so distort is 21 equal steps of FMA chains whose
//     last FMA is the update: 12 / 13 / 15 FP32 opcodes a step as
//     compiled (classic / radial / anamorphic; the radial h grouped
//     around the one sum the x and y terms share, see displace).
//   * The iteration count is a compile-time constant
//     (-DMMSOLVER_DISTORT_ITERATIONS, from models/base.py), so the loop
//     unrolls: no counter, compare or branch.
//   * Each thread loads the coefficients once into registers, and a
//     distort thread maps DISTORT_PIXELS pixels (distort_texels).
//   * 32x8 blocks with threadIdx.x along the width: a warp's loads and
//     stores are 512 contiguous bytes as one float4 a thread; the ragged
//     edge is masked here.  An undistort thread maps one pixel; at 28-32
//     registers an SM holds enough warps to cover the dependent FMA
//     chain, and the SASS opcode count times the pixels accounts for the
//     time measured (PERF.md), so the lanes' rate or the bytes, not
//     latency or the last wave, is what is left.
//   * An undistort stack is one pass (stmap_stack_kernel): its points
//     between the layers stay in registers, so the stack moves the
//     bytes of one layer, 16 a pixel from the pixel index.  A thread
//     maps STACK_PIXELS pixels and loads each layer's floats once for
//     them where the loop reaches the layer (L1 hits after the first
//     warps); the layer's core is chosen by a switch that no warp
//     diverges on.  Distort stacks keep a launch a layer: their
//     fixed points are bound by operations, and two cores' coefficients
//     and fixed points at four pixels a thread want their own register
//     budget.
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
// Pixels a thread of a distort kernel maps (distort_texels).
constexpr int DISTORT_PIXELS = 4;
// Pixels a thread of the fused undistort stack kernel maps, each layer's
// floats loaded once for all of them: at one pixel a thread the loads and
// the layer loop held the two-layer stack to 76% of its byte bound at
// 8640x5760, at two to eight it reached 98% (PERF.md).
constexpr int STACK_PIXELS = 4;

struct StmapParams {
  float c[MAX_COEFFS];  // core coefficients, model-specific order
  float a_in[4];        // row-major 2x2 and offset: source point -> core
  float b_in[2];
  float a_out[4];       // row-major 2x2 and offset: core -> unit texel
  float b_out[2];
};
static_assert(sizeof(StmapParams) == PARAM_COUNT * sizeof(float),
              "StmapParams is PARAM_COUNT packed floats");

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
    // with u = u2 + u4*r2 and v = v2 + v4*r2, regrouped as
    // h = (x, y)*k + r2*(u, v),  k = r2*g + 2*s,  s = x*u + y*v,
    // g = c2 + c4*r2, and rr the r2 of one FFMA: 3 FMUL and 10 FFMA.
    const float rr = fmaf(x, x, y2);
    const float g = fmaf(c[3], rr, c[0]);
    const float u = fmaf(c[4], rr, c[1]);
    const float v = fmaf(c[5], rr, c[2]);
    const float s = fmaf(x, u, y * v);
    const float k = fmaf(2.0f, s, rr * g);
    const float srr = NEG ? -rr : rr;
    *ox = fmaf(sx, k, fmaf(srr, u, ax));
    *oy = fmaf(sy, k, fmaf(srr, v, ay));
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

// The affine frame around the core, two FMAs a component: the source
// point to the core's input, and the core's output to the unit texel.
__device__ __forceinline__ void frame_in(const StmapParams& p, float u,
                                         float v, float* tx, float* ty) {
  *tx = fmaf(p.a_in[0], u, fmaf(p.a_in[1], v, p.b_in[0]));
  *ty = fmaf(p.a_in[2], u, fmaf(p.a_in[3], v, p.b_in[1]));
}

__device__ __forceinline__ float4 frame_out(const StmapParams& p, float qx,
                                            float qy, float blue,
                                            float alpha) {
  const float s = fmaf(p.a_out[0], qx, fmaf(p.a_out[1], qy, p.b_out[0]));
  const float t = fmaf(p.a_out[2], qx, fmaf(p.a_out[3], qy, p.b_out[1]));
  return make_float4(s, t, blue, alpha);
}

// The texel of one thread: its source point, into the core, the core
// (distort: its fixed point), out to the unit texel.
template <int CORE, bool DISTORT, bool FROM_MAP>
__device__ __forceinline__ void map_texel(float4* __restrict__ map,
                                          int width, int height,
                                          const StmapParams& p) {
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
  float tx, ty;
  frame_in(p, u, v, &tx, &ty);

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
  *texel = frame_out(p, qx, qy, blue, alpha);
}

// Distort's texels for a thread that holds the parameters in registers:
// PIXELS pixels, BLOCK_W columns apart in a tile PIXELS * BLOCK_W wide,
// their fixed points stepped side by side.  Every FMA of the core reads
// three registers: at one pixel a thread the distort kernels, bound by
// their issue rate, ran 9-17% slower than with the coefficients in the
// constant bank; at four they run within 2% of that, at 31-48 registers
// (PERF.md).  Eight gained the radial core 4% at 8640x5760 and lost it
// 4-6% at 1920x1080.  A column past the ragged edge repeats the last
// one and is not written.
template <int CORE, bool FROM_MAP, int PIXELS>
__device__ __forceinline__ void distort_texels(float4* __restrict__ map,
                                               int width, int height,
                                               const StmapParams& p) {
  const int col = blockIdx.x * (PIXELS * BLOCK_W) + threadIdx.x;
  const int row = blockIdx.y * BLOCK_H + threadIdx.y;
  if (col >= width || row >= height) return;

  float4* texel[PIXELS];
  float tx[PIXELS], ty[PIXELS], blue[PIXELS], alpha[PIXELS];
#pragma unroll
  for (int k = 0; k < PIXELS; ++k) {
    const int c = k == 0 ? col : min(col + k * BLOCK_W, width - 1);
    texel[k] = map + ((size_t)row * width + c);
    float u, v;
    blue[k] = 0.0f;
    alpha[k] = 1.0f;
    if (FROM_MAP) {
      const float4 m = *texel[k];
      u = m.x;
      v = m.y;
      blue[k] = m.z;
      alpha[k] = m.w;
    } else {
      u = (float)c;
      v = (float)row;
    }
    frame_in(p, u, v, &tx[k], &ty[k]);
  }
  float qx[PIXELS], qy[PIXELS];
#pragma unroll
  for (int k = 0; k < PIXELS; ++k) {
    qx[k] = tx[k];
    qy[k] = ty[k];
  }
#pragma unroll
  for (int i = 0; i <= MMSOLVER_DISTORT_ITERATIONS; ++i) {
#pragma unroll
    for (int k = 0; k < PIXELS; ++k) {
      float nx, ny;
      displace<CORE, true>(p, qx[k], qy[k], tx[k], ty[k], &nx, &ny);
      qx[k] = nx;
      qy[k] = ny;
    }
  }
#pragma unroll
  for (int k = 0; k < PIXELS; ++k) {
    if (k == 0 || col + k * BLOCK_W < width) {
      *texel[k] = frame_out(p, qx[k], qy[k], blue[k], alpha[k]);
    }
  }
}

// The parameters in device memory, where pack_params_kernel wrote them:
// each thread loads the same 88 bytes once, as 8-byte loads through the
// read-only path (the first warps bring them into L1), into registers.
__device__ __forceinline__ void load_params(
    const StmapParams* __restrict__ params, StmapParams* p) {
  const float2* from = reinterpret_cast<const float2*>(params);
  float* to = reinterpret_cast<float*>(p);
#pragma unroll
  for (int i = 0; i < PARAM_COUNT / 2; ++i) {
    const float2 pair = __ldg(from + i);
    to[2 * i] = pair.x;
    to[2 * i + 1] = pair.y;
  }
}

template <int CORE, bool DISTORT, bool FROM_MAP>
__global__ void __launch_bounds__(BLOCK_W * BLOCK_H)
    stmap_kernel(float4* __restrict__ map, int width, int height,
                 const StmapParams* __restrict__ params) {
  StmapParams p;
  load_params(params, &p);
  if (DISTORT) {
    distort_texels<CORE, FROM_MAP, DISTORT_PIXELS>(map, width, height, p);
  } else {
    map_texel<CORE, DISTORT, FROM_MAP>(map, width, height, p);
  }
}

constexpr int PACK_LAYERS = 8;  // layers a pack launch takes

// Bits of a layer's Core in a fused stack's `cores`: layer i's core is
// (cores >> (CORE_BITS * i)) & CORE_MASK, so the ids come by value in one
// register and no thread indexes the kernel's parameters.
constexpr int CORE_BITS = 2;
constexpr unsigned CORE_MASK = (1u << CORE_BITS) - 1u;
static_assert(ANAMORPHIC_DEG4 <= (int)CORE_MASK &&
                  PACK_LAYERS * CORE_BITS <= 32,
              "a stack's cores fit in one unsigned");

// One layer of undistort for a thread's STACK_PIXELS points, each as
// map_texel maps one: frame_in, displace, frame_out.
template <int CORE>
__device__ __forceinline__ void undistort_points(const StmapParams& p,
                                                 float* u, float* v) {
#pragma unroll
  for (int k = 0; k < STACK_PIXELS; ++k) {
    float tx, ty, qx, qy;
    frame_in(p, u[k], v[k], &tx, &ty);
    displace<CORE, false>(p, tx, ty, tx, ty, &qx, &qy);
    const float4 st = frame_out(p, qx, qy, 0.0f, 1.0f);
    u[k] = st.x;
    v[k] = st.y;
  }
}

// An undistort stack of two or more layers in one pass: a thread's points
// run through every layer in registers and each texel is written once.
// The first layer's point is the pixel index, or (FROM_MAP) the texel's
// own (S, T); B and A carry through.  Each layer is map_texel's
// undistort: frame_in, displace, frame_out, in that order, so every
// point between two layers is the float32 (S, T) that a launch a layer
// stores in the map and the next one reads back, and the map is bit-equal
// to theirs.  The core is chosen by a switch on a value every thread of
// the launch shares, so a warp never diverges on it.  `cores` holds the
// layers' Core ids (CORE_BITS each), `params` their packed floats.  A
// thread maps STACK_PIXELS pixels, BLOCK_W columns apart in a tile
// STACK_PIXELS * BLOCK_W wide; a column past the ragged edge repeats the
// last one and is not written.
template <bool FROM_MAP>
__global__ void __launch_bounds__(BLOCK_W * BLOCK_H)
    stmap_stack_kernel(float4* __restrict__ map, int width, int height,
                       const StmapParams* __restrict__ params,
                       unsigned cores, int layers) {
  const int col = blockIdx.x * (STACK_PIXELS * BLOCK_W) + threadIdx.x;
  const int row = blockIdx.y * BLOCK_H + threadIdx.y;
  if (col >= width || row >= height) return;

  float4* texel[STACK_PIXELS];
  float u[STACK_PIXELS], v[STACK_PIXELS];
  float blue[STACK_PIXELS], alpha[STACK_PIXELS];
#pragma unroll
  for (int k = 0; k < STACK_PIXELS; ++k) {
    const int c = k == 0 ? col : min(col + k * BLOCK_W, width - 1);
    texel[k] = map + ((size_t)row * width + c);
    blue[k] = 0.0f;
    alpha[k] = 1.0f;
    if (FROM_MAP) {
      const float4 m = *texel[k];
      u[k] = m.x;
      v[k] = m.y;
      blue[k] = m.z;
      alpha[k] = m.w;
    } else {
      u[k] = (float)c;
      v[k] = (float)row;
    }
  }
  for (int layer = 0; layer < layers; ++layer) {
    StmapParams p;
    load_params(params + layer, &p);
    switch ((cores >> (CORE_BITS * layer)) & CORE_MASK) {
      case CLASSIC:
        undistort_points<CLASSIC>(p, u, v);
        break;
      case RADIAL_DEG4:
        undistort_points<RADIAL_DEG4>(p, u, v);
        break;
      default:
        undistort_points<ANAMORPHIC_DEG4>(p, u, v);
        break;
    }
  }
#pragma unroll
  for (int k = 0; k < STACK_PIXELS; ++k) {
    if (k == 0 || col + k * BLOCK_W < width) {
      *texel[k] = make_float4(u[k], v[k], blue[k], alpha[k]);
    }
  }
}

// ---------------------------------------------------------------------
// The lens parameters packed on the device.  Where a lens is given as
// tensors on the card (a solved lens, or models made there), the host
// does not read them back: pack_params_kernel folds them in float64, one
// thread a layer, and writes each layer's PARAM_COUNT floats, rounded
// once to float32, in StmapParams order; the map kernel reads them.  Its
// inputs are the fields themselves, each a device address of a
// one-element float or double tensor, or a host double.  The CPU tests
// hold a transcription of it (tests/test_torch/_torch_stmap_emulation.py).

enum Model {
  TDE_CLASSIC = 0,
  TDE_RADIAL_DEG4 = 1,
  TDE_ANAMORPHIC_DEG4 = 2,
  TDE_ANAMORPHIC_DEG4_RESCALED = 3,
};

constexpr int FILM_BACK_FIELDS = 5;  // width, height, offset x, y (cm),
                                     // pixel aspect
constexpr int MODEL_FIELDS = 14;     // the most a model has (rescaled)

// One field of a model or film back, in its dataclass's field order.
struct Field {
  double value;         // the host value, where `address` is null
  const void* address;  // else the device address of its one element
  int is_double;        // which is a double (else a float)
  int unused;
};
static_assert(sizeof(Field) == 24, "Field is ops/stmap.py's _FIELD");

constexpr int PACK_FIELDS = FILM_BACK_FIELDS + PACK_LAYERS * MODEL_FIELDS;
// Every field is read at once, one a thread.
constexpr int PACK_THREADS = (PACK_FIELDS + 31) / 32 * 32;

// The pack kernel's argument.
struct PackArgs {
  Field field[PACK_FIELDS];  // the film back's, then MODEL_FIELDS a layer
  int kind[PACK_LAYERS];     // Model
  int layers;
  // The first layer's source point is the pixel index of a width x
  // height image where width > 0, else (S, T) like every further layer.
  int width, height;
  int distort;
};

__device__ __forceinline__ double field_value(const Field& f) {
  if (f.address == nullptr) return f.value;
  return f.is_double ? *static_cast<const double*>(f.address)
                     : (double)*static_cast<const float*>(f.address);
}

// Row-major 2x2 matrices in float64, as the host's tuples.
struct Mat2 {
  double m00, m01, m10, m11;
};

__device__ __forceinline__ Mat2 matmul2(const Mat2& a, const Mat2& b) {
  return {a.m00 * b.m00 + a.m01 * b.m10, a.m00 * b.m01 + a.m01 * b.m11,
          a.m10 * b.m00 + a.m11 * b.m10, a.m10 * b.m01 + a.m11 * b.m11};
}

__device__ __forceinline__ Mat2 inverse2(const Mat2& m) {
  const double det = m.m00 * m.m11 - m.m01 * m.m10;
  return {m.m11 / det, -m.m01 / det, -m.m10 / det, m.m00 / det};
}

// Every field is read at once, one a thread, into shared memory; then
// one thread a layer folds them.
__global__ void __launch_bounds__(PACK_THREADS)
    pack_params_kernel(const PackArgs args, StmapParams* __restrict__ out) {
  __shared__ double values[PACK_FIELDS];
  const int fields = FILM_BACK_FIELDS + args.layers * MODEL_FIELDS;
  for (int i = threadIdx.x; i < fields; i += blockDim.x) {
    values[i] = field_value(args.field[i]);
  }
  __syncthreads();
  const int layer = threadIdx.x;
  if (layer >= args.layers) return;
  const double* fb = values;
  const double* v = values + FILM_BACK_FIELDS + layer * MODEL_FIELDS;
  const double deg2rad = 3.14159265358979323846 / 180.0;

  // The core's coefficients and the matrices around it,
  // undistort(xy) = post @ core(pre @ xy).
  double c[MAX_COEFFS] = {};
  const Mat2 identity = {1.0, 0.0, 0.0, 1.0};
  Mat2 pre = identity, post = identity;
  const int kind = args.kind[layer];
  if (kind == TDE_CLASSIC) {
    // distortion, anamorphic squeeze, curvature x, y, quartic.
    const double ld = v[0], sq = v[1], qu = v[4];
    c[0] = ld / sq;
    c[1] = (ld + v[2]) / sq;
    c[2] = ld + v[3];
    c[3] = ld;
    c[4] = qu / sq;
    c[5] = qu;
  } else if (kind == TDE_RADIAL_DEG4) {
    // degree 2 distortion, u, v; degree 4 distortion, u, v; cylindric
    // direction (degrees) and bending.
    for (int i = 0; i < 6; ++i) c[i] = v[i];
    const double q = sqrt(1.0 + v[7]);
    const double cs = cos(v[6] * deg2rad), sn = sin(v[6] * deg2rad);
    const double m01 = (q - 1.0 / q) * cs * sn;
    post = {cs * cs * q + sn * sn / q, m01, m01, cs * cs / q + sn * sn * q};
  } else {
    // cx02, cy02, cx22, cy22, cx04, cy04, cx24, cy24, cx44, cy44, lens
    // rotation (degrees), squeeze x, y[, rescale]: cos(2 phi) r^2 = d and
    // cos(4 phi) r^4 = 2 d^2 - r^4 with d = x^2 - y^2, so the r^4 term
    // takes c04 - c44 and the d^2 term 2 c44.
    for (int i = 0; i < 4; ++i) c[i] = v[i];
    c[4] = v[4] - v[8];
    c[5] = v[5] - v[9];
    c[6] = v[6];
    c[7] = v[7];
    c[8] = 2.0 * v[8];
    c[9] = 2.0 * v[9];
    // A = R(rot) @ Sx @ Sy [@ Rescale] @ Pa, B = Pa [@ Rescale] @ R(rot).
    const double cs = cos(v[10] * deg2rad), sn = sin(v[10] * deg2rad);
    const Mat2 rot = {cs, -sn, sn, cs};
    const double pixel_aspect = fb[4];
    const double x_scale = kind == TDE_ANAMORPHIC_DEG4_RESCALED
                               ? v[13] * pixel_aspect
                               : pixel_aspect;
    post = matmul2(rot, {v[11] * x_scale, 0.0, 0.0, v[12]});
    pre = inverse2(matmul2({x_scale, 0.0, 0.0, 1.0}, rot));
  }

  // Both affine maps folded around the core.
  Mat2 m_in = pre, m_out = post;
  if (args.distort) {
    m_in = inverse2(post);
    m_out = inverse2(pre);
  }
  const double fbw = fb[0], fbh = fb[1], lcox = fb[2], lcoy = fb[3];
  const double radius = hypot(fbw, fbh) * 0.5;
  // unit = source * scale + shift: a pixel's centre, or S and T as is.
  double scale_x = 1.0, scale_y = 1.0, shift_x = 0.0, shift_y = 0.0;
  if (layer == 0 && args.width > 0) {
    scale_x = 1.0 / args.width;
    scale_y = 1.0 / args.height;
    shift_x = 0.5 * scale_x;
    shift_y = 0.5 * scale_y;
  }
  // dn = source * dn_scale + dn_shift.
  const double dn_scale_x = scale_x * fbw / radius;
  const double dn_scale_y = scale_y * fbh / radius;
  const double dn_shift_x = ((shift_x - 0.5) * fbw - lcox) / radius;
  const double dn_shift_y = ((shift_y - 0.5) * fbh - lcoy) / radius;
  const double to_s = radius / fbw, to_t = radius / fbh;
  const double packed[PARAM_COUNT] = {
      c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], c[9],
      m_in.m00 * dn_scale_x, m_in.m01 * dn_scale_y,
      m_in.m10 * dn_scale_x, m_in.m11 * dn_scale_y,
      m_in.m00 * dn_shift_x + m_in.m01 * dn_shift_y,
      m_in.m10 * dn_shift_x + m_in.m11 * dn_shift_y,
      m_out.m00 * to_s, m_out.m01 * to_s, m_out.m10 * to_t, m_out.m11 * to_t,
      0.5 + lcox / fbw, 0.5 + lcoy / fbh};
  float* to = reinterpret_cast<float*>(out + layer);
  for (int i = 0; i < PARAM_COUNT; ++i) to[i] = (float)packed[i];
}

// One launch of stmap_kernel<CORE, DISTORT, FROM_MAP> over the map, whose
// parameters are at the device address `p`.
template <int CORE, bool FROM_MAP>
void launch_core(float4* map, int width, int height, bool distort,
                 const StmapParams* p, cudaStream_t stream) {
  dim3 block(BLOCK_W, BLOCK_H);
  if (distort) {
    constexpr int tile = DISTORT_PIXELS * BLOCK_W;
    dim3 grid((width + tile - 1) / tile, (height + BLOCK_H - 1) / BLOCK_H);
    stmap_kernel<CORE, true, FROM_MAP>
        <<<grid, block, 0, stream>>>(map, width, height, p);
  } else {
    dim3 grid((width + BLOCK_W - 1) / BLOCK_W,
              (height + BLOCK_H - 1) / BLOCK_H);
    stmap_kernel<CORE, false, FROM_MAP>
        <<<grid, block, 0, stream>>>(map, width, height, p);
  }
}

// The Core of a Model: both anamorphic models run the anamorphic core.
int core_of(int kind) {
  return kind < ANAMORPHIC_DEG4 ? kind : ANAMORPHIC_DEG4;
}

template <bool FROM_MAP>
void launch_map(float4* map, int width, int height, int core_id,
                bool distort, const StmapParams* p, cudaStream_t stream) {
  switch (core_id) {
    case CLASSIC:
      launch_core<CLASSIC, FROM_MAP>(map, width, height, distort, p, stream);
      break;
    case RADIAL_DEG4:
      launch_core<RADIAL_DEG4, FROM_MAP>(map, width, height, distort, p,
                                         stream);
      break;
    default:
      launch_core<ANAMORPHIC_DEG4, FROM_MAP>(map, width, height, distort, p,
                                             stream);
      break;
  }
}

// The pack launch for `layers` layers, then the map launches, reading
// each layer's PARAM_COUNT floats of `params`: an undistort stack of two
// or more layers is one stmap_stack_kernel launch; else one map launch a
// layer, the first from the pixel index unless FROM_MAP, every further
// one from the map.  ops/stmap.py::_fused_stack states the same rule.
// `fields` holds FILM_BACK_FIELDS Field records, then MODEL_FIELDS a
// layer; `kinds` a Model a layer; both are host memory, read before this
// returns.  `params` is device memory for layers * PARAM_COUNT floats,
// 8-byte aligned.  Returns cudaGetLastError() after the launches (0 =
// launched), or cudaErrorInvalidValue for a bad size, layer count or
// kind, a null pointer or a misaligned `params`.
template <bool FROM_MAP>
int launch(void* map, int width, int height, int distort, int layers,
           const int* kinds, const Field* fields, float* params,
           void* stream) {
  if (map == nullptr || kinds == nullptr || fields == nullptr ||
      params == nullptr || width <= 0 || height <= 0 || layers < 1 ||
      layers > PACK_LAYERS ||
      reinterpret_cast<size_t>(params) % alignof(float2) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  for (int layer = 0; layer < layers; ++layer) {
    if (kinds[layer] < TDE_CLASSIC ||
        kinds[layer] > TDE_ANAMORPHIC_DEG4_RESCALED) {
      return (int)cudaErrorInvalidValue;
    }
  }
  PackArgs args;
  const int count = FILM_BACK_FIELDS + layers * MODEL_FIELDS;
  for (int i = 0; i < count; ++i) args.field[i] = fields[i];
  for (int layer = 0; layer < layers; ++layer) args.kind[layer] = kinds[layer];
  args.layers = layers;
  args.width = FROM_MAP ? 0 : width;
  args.height = FROM_MAP ? 0 : height;
  args.distort = distort;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  StmapParams* packed = reinterpret_cast<StmapParams*>(params);
  pack_params_kernel<<<1, PACK_THREADS, 0, s>>>(args, packed);
  float4* m = static_cast<float4*>(map);
  if (!distort && layers >= 2) {
    unsigned cores = 0;
    for (int layer = 0; layer < layers; ++layer) {
      cores |= (unsigned)core_of(kinds[layer]) << (CORE_BITS * layer);
    }
    constexpr int tile = STACK_PIXELS * BLOCK_W;
    dim3 block(BLOCK_W, BLOCK_H);
    dim3 grid((width + tile - 1) / tile, (height + BLOCK_H - 1) / BLOCK_H);
    stmap_stack_kernel<FROM_MAP>
        <<<grid, block, 0, s>>>(m, width, height, packed, cores, layers);
    return (int)cudaGetLastError();
  }
  for (int layer = 0; layer < layers; ++layer) {
    const int core_id = core_of(kinds[layer]);
    const StmapParams* p = packed + layer;
    if (FROM_MAP || layer > 0) {
      launch_map<true>(m, width, height, core_id, distort != 0, p, s);
    } else {
      launch_map<false>(m, width, height, core_id, distort != 0, p, s);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes.  Both take the lens as Field records
// (see launch), launch the pack kernel once for up to PACK_LAYERS layers,
// then the map kernel a layer, or for an undistort stack the fused kernel
// once, reading the parameters from `params`; they launch on `stream`,
// allocate nothing and do not synchronise.

// Writes height*width float4 texels [S, T, 0, 1] to the device pointer
// `out` with the first layer, whose source point is the pixel index
// (col, row), and maps them in place with each further one.
extern "C" int mmsolver_stmap(void* out, int width, int height, int distort,
                              int layers, const int* kinds,
                              const void* fields, float* params,
                              void* stream) {
  return launch<false>(out, width, height, distort, layers, kinds,
                       static_cast<const Field*>(fields), params, stream);
}

// Maps the height*width float4 texels at the device pointer `map` in
// place with every layer; the source point is each texel's own (S, T).
extern "C" int mmsolver_stmap_layer(void* map, int width, int height,
                                    int distort, int layers,
                                    const int* kinds, const void* fields,
                                    float* params, void* stream) {
  return launch<true>(map, width, height, distort, layers, kinds,
                      static_cast<const Field*>(fields), params, stream);
}
