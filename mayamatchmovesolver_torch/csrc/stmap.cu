// Lens ST-map kernel for Hopper (sm_90a).
//
// Replaces mayamatchmovesolver_tpu/ops/stmap.py::_stmap_kernel, the
// Pallas TPU kernel.  For every output pixel it computes where that pixel
// samples the other image, for the four 3DE models, and writes the RGBA
// float32 ST-map texel [S, T, 0, 1].
//
// Every model's undistort is  post @ core(pre @ xy)  in diagonally
// normalised (dn) coordinates, with a polynomial `core` and constant 2x2
// matrices; distort inverts it as  inv(pre) @ core^-1(inv(post) @ xy),
// core^-1 by the ldpk fixed point p <- p + (target - core(p)).  The host
// wrapper (ops/stmap.py) folds the direction into two matrices, `m_in`
// applied before the core and `m_out` after it, computes them and the
// core's coefficients in float64 and passes them as float32 in a struct
// by value.
//
// What bounds it on this card: for distort, FP32 ALU work — 1 + 20 core
// evaluations (21) per pixel, each a few dozen FMAs and, for the
// anamorphic core, an IEEE division; for undistort, the 16-byte store per
// pixel (one core evaluation is far below the memory roofline's budget).
// What the design does about it: it reads nothing — pixel coordinates
// come from the thread index, the parameters from the kernel argument —
// and writes each texel with one 16-byte float4 store, so no coordinate
// tensor, pad, crop or stack pass ever touches device memory.  One
// thread per pixel, 32x8 blocks with threadIdx.x along the width, so a
// warp's stores are 512 contiguous bytes; the ragged edge is masked here.
// No --use_fast_math: IEEE division keeps the result within 2e-5 of the
// plain PyTorch version.

#include <cuda_runtime.h>

namespace {

enum Core { CLASSIC = 0, RADIAL_DEG4 = 1, ANAMORPHIC_DEG4 = 2 };

constexpr int BLOCK_W = 32;
constexpr int BLOCK_H = 8;
constexpr int MAX_COEFFS = 10;

struct StmapParams {
  float c[MAX_COEFFS];  // core coefficients, model-specific order
  float m_in[4];        // row-major 2x2 applied before the core
  float m_out[4];       // row-major 2x2 applied after the core
  float fbw, fbh;       // film back width, height (cm)
  float lcox, lcoy;     // lens centre offset (cm)
  float radius;         // half film-back diagonal (cm)
  float width, height;  // image size in pixels
  int iterations;       // fixed-point iterations (distort)
};

// Classic 3DE mixed model; c = {cxx, cxy, cyx, cyy, qx, qy} with the
// quartic terms qx*(x^4 + 2x^2y^2 + y^4) and qy*(...) likewise.
__device__ __forceinline__ void classic_core(const float* c, float x,
                                             float y, float* qx,
                                             float* qy) {
  float x2 = x * x, y2 = y * y;
  float x4 = x2 * x2, y4 = y2 * y2, xy2 = x2 * y2;
  *qx = x * (1.0f + c[0] * x2 + c[1] * y2 + c[4] * x4 +
             2.0f * c[4] * xy2 + c[4] * y4);
  *qy = y * (1.0f + c[2] * x2 + c[3] * y2 + c[5] * x4 +
             2.0f * c[5] * xy2 + c[5] * y4);
}

// 3DE4 radial degree 4 with decentering; c = {c2, u2, v2, c4, u4, v4}.
__device__ __forceinline__ void radial_core(const float* c, float x,
                                            float y, float* qx,
                                            float* qy) {
  float x2 = x * x, y2 = y * y, xy = x * y;
  float r2 = x2 + y2, r4 = r2 * r2;
  float radial = 1.0f + c[0] * r2 + c[3] * r4;
  float u = c[1] + c[4] * r2, v = c[2] + c[5] * r2;
  *qx = x * radial + (r2 + 2.0f * x2) * u + 2.0f * xy * v;
  *qy = y * radial + (r2 + 2.0f * y2) * v + 2.0f * xy * u;
}

// 3DE4 anamorphic degree 4; c = {cx02, cy02, cx22, cy22, cx04, cy04,
// cx24, cy24, cx44, cy44}.
__device__ __forceinline__ void anamorphic_core(const float* c, float x,
                                                float y, float* qx,
                                                float* qy) {
  float x2 = x * x, y2 = y * y;
  float r2 = x2 + y2, r4 = r2 * r2;
  float cos2 = (x2 - y2) / fmaxf(r2, 1e-30f);
  float cos4 = 2.0f * cos2 * cos2 - 1.0f;
  float fx = 1.0f + c[0] * r2 + c[4] * r4 + cos2 * (c[2] * r2 + c[6] * r4) +
             cos4 * c[8] * r4;
  float fy = 1.0f + c[1] * r2 + c[5] * r4 + cos2 * (c[3] * r2 + c[7] * r4) +
             cos4 * c[9] * r4;
  *qx = x * fx;
  *qy = y * fy;
}

template <int CORE>
__device__ __forceinline__ void core(const float* c, float x, float y,
                                     float* qx, float* qy) {
  if (CORE == CLASSIC) {
    classic_core(c, x, y, qx, qy);
  } else if (CORE == RADIAL_DEG4) {
    radial_core(c, x, y, qx, qy);
  } else {
    anamorphic_core(c, x, y, qx, qy);
  }
}

template <int CORE, bool DISTORT>
__global__ void __launch_bounds__(BLOCK_W * BLOCK_H)
    stmap_kernel(float4* __restrict__ out, int width, int height,
                 const StmapParams p) {
  int col = blockIdx.x * BLOCK_W + threadIdx.x;
  int row = blockIdx.y * BLOCK_H + threadIdx.y;
  if (col >= width || row >= height) return;

  // Pixel centre -> unit -> diagonally normalised coordinates.
  float x_unit = ((float)col + 0.5f) / p.width;
  float y_unit = ((float)row + 0.5f) / p.height;
  float x_dn = ((x_unit - 0.5f) * p.fbw - p.lcox) / p.radius;
  float y_dn = ((y_unit - 0.5f) * p.fbh - p.lcoy) / p.radius;

  float tx = p.m_in[0] * x_dn + p.m_in[1] * y_dn;
  float ty = p.m_in[2] * x_dn + p.m_in[3] * y_dn;
  float qx, qy;
  core<CORE>(p.c, tx, ty, &qx, &qy);
  if (DISTORT) {
    // Fixed-point inverse of the core: start at t - (core(t) - t).
    float px = tx - (qx - tx);
    float py = ty - (qy - ty);
    for (int i = 0; i < p.iterations; ++i) {
      float fx, fy;
      core<CORE>(p.c, px, py, &fx, &fy);
      px += tx - fx;
      py += ty - fy;
    }
    qx = px;
    qy = py;
  }
  float ox = p.m_out[0] * qx + p.m_out[1] * qy;
  float oy = p.m_out[2] * qx + p.m_out[3] * qy;

  // dn -> unit.
  float s = (ox * p.radius + p.fbw * 0.5f + p.lcox) / p.fbw;
  float t = (oy * p.radius + p.fbh * 0.5f + p.lcoy) / p.fbh;
  out[(size_t)row * width + col] = make_float4(s, t, 0.0f, 1.0f);
}

template <int CORE>
void launch(float4* out, int width, int height, bool distort,
            const StmapParams& p, cudaStream_t stream) {
  dim3 block(BLOCK_W, BLOCK_H);
  dim3 grid((width + BLOCK_W - 1) / BLOCK_W,
            (height + BLOCK_H - 1) / BLOCK_H);
  if (distort) {
    stmap_kernel<CORE, true><<<grid, block, 0, stream>>>(out, width,
                                                         height, p);
  } else {
    stmap_kernel<CORE, false><<<grid, block, 0, stream>>>(out, width,
                                                          height, p);
  }
}

}  // namespace

// Plain C entry point for ctypes.  `out` is a device pointer to
// height*width float4 texels; `host_params` points to host floats laid out
// as c[10], m_in[4], m_out[4], fbw, fbh, lcox, lcoy, radius (27 values).
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for an unknown core or a bad size.
extern "C" int mmsolver_stmap(void* out, int width, int height, int core_id,
                              int distort, int iterations,
                              const float* host_params, void* stream) {
  if (width <= 0 || height <= 0 || iterations < 0 || core_id < 0 ||
      core_id > ANAMORPHIC_DEG4) {
    return (int)cudaErrorInvalidValue;
  }
  StmapParams p;
  const float* h = host_params;
  for (int i = 0; i < MAX_COEFFS; ++i) p.c[i] = *h++;
  for (int i = 0; i < 4; ++i) p.m_in[i] = *h++;
  for (int i = 0; i < 4; ++i) p.m_out[i] = *h++;
  p.fbw = *h++;
  p.fbh = *h++;
  p.lcox = *h++;
  p.lcoy = *h++;
  p.radius = *h++;
  p.width = (float)width;
  p.height = (float)height;
  p.iterations = iterations;

  float4* o = static_cast<float4*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (core_id) {
    case CLASSIC:
      launch<CLASSIC>(o, width, height, distort != 0, p, s);
      break;
    case RADIAL_DEG4:
      launch<RADIAL_DEG4>(o, width, height, distort != 0, p, s);
      break;
    default:
      launch<ANAMORPHIC_DEG4>(o, width, height, distort != 0, p, s);
      break;
  }
  return (int)cudaGetLastError();
}
