// Bilinear warp with border clamping, optionally with its tap differentials,
// a source-index map and an in-kernel projection prologue.
//
// Replaces the TPU kernels of tpuslam/ops/pallas_warp.py:
//   K1a _pallas_warp_static_fused_impl (_warp_kernel_static_fused), with taps
//   K1b _pallas_warp_static_impl (_warp_kernel_static_groupskip), without
//   K4  _pallas_warp_tall_impl (_warp_kernel_tall): deduplicated sources
//   K5  _pallas_warp_tall_proj_impl (_warp_kernel_tall_proj): coordinates
//       computed in the kernel from depth and a per-image affine camera map
// It computes their function, not their tiling.  One thread per output pixel
// (n, y, x) of the (N, H, W, C) stack.
//
// Source index map.  Output n reads source image g = (n / (S*B)) * B + n % B
// of src (the stack order [direction, scale, batch] of train/steps.py, with
// src holding the 2*B distinct frames); S = 1, B = N is the identity, K1.  The
// S-fold tiled source never exists.
//
// Projection prologue (depth != null).  With u = x, v = y as floats, d =
// depth[n % (S*B), y, x] and a = ab[g] (12 floats, projection_affine):
//   r = (a0 u + a1 v + a2, a3 u + a4 v + a5, a6 u + a7 v + a8)
//   c = d * r + (a9, a10, a11);  z = max(c_z, 1e-3);  (x, y) = (c_x, c_y) / z
// evaluated op by op with round-to-nearest intrinsics (no FMA contraction),
// in the order of the plain version, so the coordinates equal its bit for
// bit.  Otherwise coords[n, y, x, :] are read.
//
// The warp: clamp to [0, W-1] x [0, H-1], floor, clamp the floors to W-2 /
// H-2 (camera.py bilinear_sampler), gather the four taps x C channels of the
// source (NHWC, so the channels of one tap are contiguous) and write
//   out = top * (1 - wy) + bot * wy
//   dx  = (a1 - a0) * (1 - wy) + (b1 - b0) * wy      (with_taps)
//   dy  = (b0 - a0) * (1 - wx) + (b1 - a1) * wx      (with_taps)
// All math is f32; the stores are f32 or bf16 (round to nearest even).
//
// Unlike the TPU kernels, which serve each output tile from a fixed source
// window (K1: 40 rows x 384 columns; K4/K5: all rows x 384 columns) and clamp
// flow that leaves it, this kernel is exact for any coordinates: it has the
// semantics of bilinear_sampler.
//
// Bound: memory.  Per output pixel it does ~30 flops on C = 3 channels (~20
// more for the projection).  In adapt_step (N = 2*S*B = 24 images of
// 192 x 640 x 3, bf16 outputs) the compulsory traffic with taps is: K1 src
// (tiled) 35.4 MB + coords 23.6 MB read, 3 x 17.7 MB written, ~112 MB or
// ~33 us at 3.35 TB/s; K4 src2 8.8 MB + coords 23.6 MB + 53.1 MB, ~85.5 MB or
// ~25.5 us; K5 src2 8.8 MB + depth 5.9 MB + 53.1 MB, ~67.8 MB or ~20.2 us.
// The gathers of smooth SLAM flow land near the output pixel, and one source
// image is 1.47 MB, so they hit L1/L2; neighbouring threads read neighbouring
// coords and write neighbouring outputs.  Vectorised stores and a staged
// source window are left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ T store_as(float v);

template <>
__device__ __forceinline__ float store_as<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// a0 * u + a1 * v + a2, rounded op by op like the plain torch expression
__device__ __forceinline__ float affine_row(const float* a, float u, float v) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a[0], u), __fmul_rn(a[1], v)), a[2]);
}

template <typename T, bool TAPS, bool PROJ>
__global__ void warp_kernel(const float* __restrict__ src,
                            const float* __restrict__ coords,
                            const float* __restrict__ depth,
                            const float* __restrict__ ab,
                            T* __restrict__ out, T* __restrict__ dx,
                            T* __restrict__ dy, int64_t n_pix, int H, int W,
                            int C, int S, int B) {
  const int64_t p = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  const int64_t hw = (int64_t)H * W;
  const int64_t n = p / hw;
  const int64_t pix = p - n * hw;
  const int64_t sb = (int64_t)S * B;
  const int64_t g = (n / sb) * B + n % B;

  float xr, yr;
  if (PROJ) {
    const float u = (float)(pix % W);
    const float v = (float)(pix / W);
    const float* a = ab + g * 12;
    const float d = depth[(n % sb) * hw + pix];
    const float cx = __fadd_rn(__fmul_rn(d, affine_row(a, u, v)), a[9]);
    const float cy = __fadd_rn(__fmul_rn(d, affine_row(a + 3, u, v)), a[10]);
    const float cz = __fadd_rn(__fmul_rn(d, affine_row(a + 6, u, v)), a[11]);
    const float z = fmaxf(cz, 1e-3f);
    xr = __fdiv_rn(cx, z);
    yr = __fdiv_rn(cy, z);
  } else {
    xr = coords[2 * p];
    yr = coords[2 * p + 1];
  }

  const float x = fminf(fmaxf(xr, 0.0f), (float)(W - 1));
  const float y = fminf(fmaxf(yr, 0.0f), (float)(H - 1));
  const float x0 = fminf(floorf(x), (float)(W - 2));
  const float y0 = fminf(floorf(y), (float)(H - 2));
  const float wx = x - x0;
  const float wy = y - y0;

  const float* top = src + (g * hw + (int64_t)y0 * W + (int64_t)x0) * C;
  const float* bot = top + (int64_t)W * C;
  T* o = out + p * C;
  for (int c = 0; c < C; ++c) {
    const float a0 = top[c], a1 = top[C + c];
    const float b0 = bot[c], b1 = bot[C + c];
    const float t = a0 * (1.0f - wx) + a1 * wx;
    const float b = b0 * (1.0f - wx) + b1 * wx;
    o[c] = store_as<T>(t * (1.0f - wy) + b * wy);
    if (TAPS) {
      dx[p * C + c] = store_as<T>((a1 - a0) * (1.0f - wy) + (b1 - b0) * wy);
      dy[p * C + c] = store_as<T>((b0 - a0) * (1.0f - wx) + (b1 - a1) * wx);
    }
  }
}

template <typename T, bool TAPS>
void launch_taps(const float* src, const float* coords, const float* depth,
                 const float* ab, void* out, void* dx, void* dy,
                 int64_t n_pix, int H, int W, int C, int S, int B,
                 cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((n_pix + threads - 1) / threads);
  if (depth != nullptr) {
    warp_kernel<T, TAPS, true><<<blocks, threads, 0, stream>>>(
        src, nullptr, depth, ab, (T*)out, (T*)dx, (T*)dy, n_pix, H, W, C, S, B);
  } else {
    warp_kernel<T, TAPS, false><<<blocks, threads, 0, stream>>>(
        src, coords, nullptr, nullptr, (T*)out, (T*)dx, (T*)dy, n_pix, H, W, C,
        S, B);
  }
}

template <typename T>
void launch(const float* src, const float* coords, const float* depth,
            const float* ab, void* out, void* dx, void* dy, int64_t n_pix,
            int H, int W, int C, int S, int B, int with_taps,
            cudaStream_t stream) {
  if (with_taps) {
    launch_taps<T, true>(src, coords, depth, ab, out, dx, dy, n_pix, H, W, C,
                         S, B, stream);
  } else {
    launch_taps<T, false>(src, coords, depth, ab, out, nullptr, nullptr, n_pix,
                          H, W, C, S, B, stream);
  }
}

}  // namespace

// src (2B or N, H, W, C) f32; either coords (N, H, W, 2) f32, or depth
// (S*B, H, W) f32 and ab (2B, 12) f32 (then coords is ignored); outputs
// (N, H, W, C) f32 or bf16; all contiguous.  Output n reads source
// (n / (S*B)) * B + n % B.  dx and dy are written only when with_taps is set.
// Returns cudaGetLastError() after the launch.
extern "C" int tpuslam_warp(const void* src, const void* coords,
                            const void* depth, const void* ab, void* out,
                            void* dx, void* dy, int64_t n, int H, int W, int C,
                            int S, int B, int with_taps, int bf16_out,
                            void* stream) {
  const int64_t n_pix = n * (int64_t)H * W;
  if (n_pix > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16_out) {
      launch<__nv_bfloat16>((const float*)src, (const float*)coords,
                            (const float*)depth, (const float*)ab, out, dx, dy,
                            n_pix, H, W, C, S, B, with_taps, s);
    } else {
      launch<float>((const float*)src, (const float*)coords,
                    (const float*)depth, (const float*)ab, out, dx, dy, n_pix,
                    H, W, C, S, B, with_taps, s);
    }
  }
  return (int)cudaGetLastError();
}
