// Bilinear warp with border clamping, optionally with its tap differentials.
//
// Replaces the TPU kernels of tpuslam/ops/pallas_warp.py:
//   _pallas_warp_static_fused_impl (_warp_kernel_static_fused), when with_taps
//   _pallas_warp_static_impl (_warp_kernel_static_groupskip), without taps
// It computes their function, not their tiling.  One thread per output pixel
// (n, y, x): read coords[n, y, x, :], clamp to [0, W-1] x [0, H-1], floor, clamp
// the floors to W-2 / H-2 (camera.py bilinear_sampler, pallas_warp.py
// _static_tile_coords), gather the four taps x C channels of src[n] (NHWC, so
// the channels of one tap are contiguous) and write
//   out = top * (1 - wy) + bot * wy
//   dx  = (a1 - a0) * (1 - wy) + (b1 - b0) * wy      (with_taps)
//   dy  = (b0 - a0) * (1 - wx) + (b1 - a1) * wx      (with_taps)
// All math is f32; the stores are f32 or bf16 (round to nearest even).
//
// Unlike the TPU kernel, which serves each (8, 128) output tile from a fixed
// (8 + 32)-row x 384-column source window and clamps flow that leaves it, this
// kernel is exact for any coordinates: it has the semantics of
// bilinear_sampler.
//
// Bound: memory.  Per output pixel it does ~30 flops on C = 3 channels and
// moves 8 bytes of coords, 12 bytes of src and 3 x C outputs.  With taps, in
// adapt_step (N = 2*S*B = 24 images of 192 x 640 x 3), the compulsory
// traffic with bf16 outputs is src 35.4 MB + coords 23.6 MB read and
// 3 x 17.7 MB written, ~112 MB or ~33 us at 3.35 TB/s (f32 outputs: ~165 MB,
// ~49 us).  Without taps, in eval_step (batch 1, N = 2*S = 8 images), it is
// src 11.8 MB + coords 7.9 MB + out 5.9 MB (bf16), ~25.6 MB or ~7.6 us
// (f32 out: ~31.5 MB, ~9.4 us); that fits in the 50 MB L2.  The gathers of
// smooth SLAM flow land
// near the output pixel, and one source image is 1.47 MB, so they hit L1/L2;
// neighbouring threads read neighbouring coords and write neighbouring
// outputs.  Deduplicating the S-fold tiled source, vectorised stores and a
// staged source window are left for later work.
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

template <typename T, bool TAPS>
__global__ void warp_kernel(const float* __restrict__ src,
                            const float* __restrict__ coords,
                            T* __restrict__ out, T* __restrict__ dx,
                            T* __restrict__ dy, int64_t n_pix, int H, int W,
                            int C) {
  const int64_t p = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  const int64_t hw = (int64_t)H * W;
  const int64_t n = p / hw;

  const float x = fminf(fmaxf(coords[2 * p], 0.0f), (float)(W - 1));
  const float y = fminf(fmaxf(coords[2 * p + 1], 0.0f), (float)(H - 1));
  const float x0 = fminf(floorf(x), (float)(W - 2));
  const float y0 = fminf(floorf(y), (float)(H - 2));
  const float wx = x - x0;
  const float wy = y - y0;

  const float* top = src + (n * hw + (int64_t)y0 * W + (int64_t)x0) * C;
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

template <typename T>
void launch(const float* src, const float* coords, void* out, void* dx,
            void* dy, int64_t n_pix, int H, int W, int C, int with_taps,
            cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = (n_pix + threads - 1) / threads;
  if (with_taps) {
    warp_kernel<T, true><<<(unsigned)blocks, threads, 0, stream>>>(
        src, coords, (T*)out, (T*)dx, (T*)dy, n_pix, H, W, C);
  } else {
    warp_kernel<T, false><<<(unsigned)blocks, threads, 0, stream>>>(
        src, coords, (T*)out, nullptr, nullptr, n_pix, H, W, C);
  }
}

}  // namespace

// src (N, H, W, C) f32, coords (N, H, W, 2) f32, outputs (N, H, W, C) f32 or
// bf16; all contiguous.  dx and dy are read only when with_taps is set.
// Returns cudaGetLastError() after the launch.
extern "C" int tpuslam_warp(const void* src, const void* coords, void* out,
                            void* dx, void* dy, int64_t n, int H, int W, int C,
                            int with_taps, int bf16_out, void* stream) {
  const int64_t n_pix = n * (int64_t)H * W;
  if (n_pix > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16_out) {
      launch<__nv_bfloat16>((const float*)src, (const float*)coords, out, dx,
                            dy, n_pix, H, W, C, with_taps, s);
    } else {
      launch<float>((const float*)src, (const float*)coords, out, dx, dy,
                    n_pix, H, W, C, with_taps, s);
    }
  }
  return (int)cudaGetLastError();
}
