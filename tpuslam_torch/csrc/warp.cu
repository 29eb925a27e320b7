// Bilinear warp with border clamping, optionally with its tap differentials,
// a source-index map, an in-kernel projection prologue and bf16-truncated
// taps; and the gather backward of the warp without taps.
//
// Replaces the TPU kernels of tpuslam/ops/pallas_warp.py:
//   K1a _pallas_warp_static_fused_impl (_warp_kernel_static_fused), with taps
//   K1b _pallas_warp_static_impl (_warp_kernel_static_groupskip), without
//   K2  _pallas_warp_static_impl, the two-kernel warp of pallas_warp_static
//       (dense, sparse, group-skip; packed and seg-skip with truncated taps),
//       and its backward _static_bwd (_grad_kernel_static*): warp_grad_kernel
//   K3  _pallas_warp_chw (_warp_kernel) and K3' _bwd (_grad_kernel), the
//       dynamic-window pallas_warp: the same two kernels without truncation
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
// All math is f32; the stores are f32 or bf16 (round to nearest even).  With
// trunc, each tap value is first truncated to bf16 toward zero (the low 16
// bits of the word cleared), as the packed TPU variants gather them
// (_pack_row_bf16); the weights stay f32.
//
// The backward (warp_grad_kernel, K2/K3'): per output pixel it gathers the
// same taps again and writes the coordinate cotangent
//   dcoords = (sum_c g_c * dx_c * live(x, W-1), sum_c g_c * dy_c * live(y, H-1))
// with live 1 strictly inside, 0.5 at an exact edge and 0 outside (the clip
// subgradient), summing the channels in the order c = 0..C-1 as
// _grad_kernel_static does.
//
// Unlike the TPU kernels, which serve each output tile from a fixed source
// window (K1/K2: 40 rows x 384 columns; K3: 16 x 256 at the tile's minimum;
// K4/K5: all rows x 384 columns) and clamp flow that leaves it, these kernels
// are exact for any coordinates: they have the semantics of bilinear_sampler.
//
// Bound: memory.  Per output pixel the warp does ~30 flops on C = 3 channels
// (~20 more for the projection), the backward ~60.  In adapt_step (N =
// 2*S*B = 24 images of 192 x 640 x 3) the compulsory traffic is: K1 with taps
// (bf16 stores) src (tiled) 35.4 MB + coords 23.6 MB read, 3 x 17.7 MB
// written, ~112 MB or ~33 us at 3.35 TB/s; K4 src2 8.8 MB + coords 23.6 MB +
// 53.1 MB, ~85.5 MB or ~25.5 us; K5 src2 8.8 MB + depth 5.9 MB + 53.1 MB,
// ~67.8 MB or ~20.2 us; K2 forward (f32 store) 35.4 + 23.6 + 35.4 MB, ~94 MB
// or ~28 us; K2 backward src, coords and g 94.4 MB read, dcoords 23.6 MB
// written, ~118 MB or ~35 us.  The gathers of smooth SLAM flow land near the
// output pixel, and one source image is 1.47 MB, so they hit L1/L2;
// neighbouring threads read neighbouring coords and write neighbouring
// outputs.  Vectorised stores and a staged source window are left for later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

unsigned blocks_for(int64_t n_pix) {
  return (unsigned)((n_pix + kThreads - 1) / kThreads);
}

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

// One tap value, truncated to bf16 toward zero when TRUNC
template <bool TRUNC>
__device__ __forceinline__ float tap(const float* p) {
  const float v = *p;
  return TRUNC ? __uint_as_float(__float_as_uint(v) & 0xFFFF0000u) : v;
}

// Clamp (xr, yr) to [0, W-1] x [0, H-1], floor, clamp the floors to W-2 /
// H-2; returns the pixel offset y0 * W + x0 of the top-left tap within its
// image and sets the weights.
__device__ __forceinline__ int64_t bilinear_corner(float xr, float yr, int H,
                                                   int W, float* wx,
                                                   float* wy) {
  const float x = fminf(fmaxf(xr, 0.0f), (float)(W - 1));
  const float y = fminf(fmaxf(yr, 0.0f), (float)(H - 1));
  const float x0 = fminf(floorf(x), (float)(W - 2));
  const float y0 = fminf(floorf(y), (float)(H - 2));
  *wx = x - x0;
  *wy = y - y0;
  return (int64_t)y0 * W + (int64_t)x0;
}

// Clip subgradient: 1 strictly inside (0, hi), 0.5 at an exact edge
__device__ __forceinline__ float live(float v, float hi) {
  if (v > 0.0f && v < hi) return 1.0f;
  return (v == 0.0f || v == hi) ? 0.5f : 0.0f;
}

template <typename T, bool TAPS, bool PROJ, bool TRUNC>
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

  float wx, wy;
  const float* top = src + (g * hw + bilinear_corner(xr, yr, H, W, &wx, &wy)) * C;
  const float* bot = top + (int64_t)W * C;
  T* o = out + p * C;
  for (int c = 0; c < C; ++c) {
    const float a0 = tap<TRUNC>(top + c), a1 = tap<TRUNC>(top + C + c);
    const float b0 = tap<TRUNC>(bot + c), b1 = tap<TRUNC>(bot + C + c);
    const float t = a0 * (1.0f - wx) + a1 * wx;
    const float b = b0 * (1.0f - wx) + b1 * wx;
    o[c] = store_as<T>(t * (1.0f - wy) + b * wy);
    if (TAPS) {
      dx[p * C + c] = store_as<T>((a1 - a0) * (1.0f - wy) + (b1 - b0) * wy);
      dy[p * C + c] = store_as<T>((b0 - a0) * (1.0f - wx) + (b1 - a1) * wx);
    }
  }
}

// The backward of the warp without taps: src (N, H, W, C), coords (N, H, W,
// 2) and g (N, H, W, C) f32 -> dcoords (N, H, W, 2) f32
template <bool TRUNC>
__global__ void warp_grad_kernel(const float* __restrict__ src,
                                 const float* __restrict__ coords,
                                 const float* __restrict__ g,
                                 float* __restrict__ dcoords, int64_t n_pix,
                                 int H, int W, int C) {
  const int64_t p = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  const int64_t hw = (int64_t)H * W;
  const float xr = coords[2 * p];
  const float yr = coords[2 * p + 1];
  float wx, wy;
  const float* top = src + ((p / hw) * hw + bilinear_corner(xr, yr, H, W, &wx, &wy)) * C;
  const float* bot = top + (int64_t)W * C;
  const float* gp = g + p * C;
  float ddx = 0.0f, ddy = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float a0 = tap<TRUNC>(top + c), a1 = tap<TRUNC>(top + C + c);
    const float b0 = tap<TRUNC>(bot + c), b1 = tap<TRUNC>(bot + C + c);
    ddx += gp[c] * ((a1 - a0) * (1.0f - wy) + (b1 - b0) * wy);
    ddy += gp[c] * ((b0 - a0) * (1.0f - wx) + (b1 - a1) * wx);
  }
  dcoords[2 * p] = ddx * live(xr, (float)(W - 1));
  dcoords[2 * p + 1] = ddy * live(yr, (float)(H - 1));
}

using Launch = void (*)(const float*, const float*, const float*, const float*,
                        void*, void*, void*, int64_t, int, int, int, int, int,
                        cudaStream_t);

template <typename T, bool TAPS, bool PROJ, bool TRUNC = false>
void launch(const float* src, const float* coords, const float* depth,
            const float* ab, void* out, void* dx, void* dy, int64_t n_pix,
            int H, int W, int C, int S, int B, cudaStream_t stream) {
  warp_kernel<T, TAPS, PROJ, TRUNC><<<blocks_for(n_pix), kThreads, 0, stream>>>(
      src, coords, depth, ab, (T*)out, (T*)dx, (T*)dy, n_pix, H, W, C, S, B);
}

template <typename T, bool TAPS>
Launch pick_proj(bool proj) {
  return proj ? launch<T, TAPS, true> : launch<T, TAPS, false>;
}

template <typename T>
Launch pick_taps(bool taps, bool proj) {
  return taps ? pick_proj<T, true>(proj) : pick_proj<T, false>(proj);
}

}  // namespace

// src (2B or N, H, W, C) f32; either coords (N, H, W, 2) f32, or depth
// (S*B, H, W) f32 and ab (2B, 12) f32 (then coords is ignored); outputs
// (N, H, W, C) f32 or bf16; all contiguous.  Output n reads source
// (n / (S*B)) * B + n % B.  dx and dy are written only when with_taps is set;
// trunc truncates the taps to bf16; it is taken only without taps, without
// projection and with f32 stores (K2), else cudaErrorInvalidValue is
// returned and nothing runs.  Returns cudaGetLastError() after the launch.
extern "C" int tpuslam_warp(const void* src, const void* coords,
                            const void* depth, const void* ab, void* out,
                            void* dx, void* dy, int64_t n, int H, int W, int C,
                            int S, int B, int with_taps, int bf16_out,
                            int trunc, void* stream) {
  const int64_t n_pix = n * (int64_t)H * W;
  const bool proj = depth != nullptr;
  if (trunc && (with_taps || bf16_out || proj)) return (int)cudaErrorInvalidValue;
  if (n_pix > 0) {
    const Launch fn = trunc      ? launch<float, false, false, true>
                      : bf16_out ? pick_taps<__nv_bfloat16>(with_taps, proj)
                                 : pick_taps<float>(with_taps, proj);
    fn((const float*)src, (const float*)coords, (const float*)depth,
       (const float*)ab, out, with_taps ? dx : nullptr,
       with_taps ? dy : nullptr, n_pix, H, W, C, S, B, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

// src, g (N, H, W, C), coords (N, H, W, 2) f32 -> dcoords (N, H, W, 2) f32,
// all contiguous: the gather backward of the warp without taps (trunc: with
// bf16-truncated taps).  Returns cudaGetLastError() after the launch.
extern "C" int tpuslam_warp_grad(const void* src, const void* coords,
                                 const void* g, void* dcoords, int64_t n,
                                 int H, int W, int C, int trunc,
                                 void* stream) {
  const int64_t n_pix = n * (int64_t)H * W;
  if (n_pix > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (trunc) {
      warp_grad_kernel<true><<<blocks_for(n_pix), kThreads, 0, s>>>(
          (const float*)src, (const float*)coords, (const float*)g,
          (float*)dcoords, n_pix, H, W, C);
    } else {
      warp_grad_kernel<false><<<blocks_for(n_pix), kThreads, 0, s>>>(
          (const float*)src, (const float*)coords, (const float*)g,
          (float*)dcoords, n_pix, H, W, C);
    }
  }
  return (int)cudaGetLastError();
}
