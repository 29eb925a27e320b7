// SSIM + L1 reprojection-error maps: forward, recompute backward, and the
// backward contracted with the warp's tap differentials.
//
// Replaces the TPU kernels of tpuslam/ops/pallas_loss.py and pallas_fused.py:
//   K6  _reproj_err_impl (_err_kernel): the error maps
//   K6' _bwd (_err_bwd_kernel): d err / d pred
//   K7/K8 _dc_from_err_bwd (_err_bwd_coords_kernel): d err / d pred, kept in
//       registers and contracted with the tap differentials dx, dy
// They compute the full-image function (the TPU kernels' row slabs and halos
// equal it exactly), not the TPU tiling.
//
// The function (pallas_loss.py _err_math_c, losses/photometric.py).  Pred n
// of the (N, H, W, C) stack is compared with target b = n % B.  Per channel,
// with 3x3 mean pools P over the reflect-padded image (row -1 is row 1, row H
// is row H-2; columns likewise):
//   mx = P(x), my = P(y), sx = P(x x) - mx^2, sy = P(y y) - my^2,
//   sxy = P(x y) - mx my,
//   n = (2 mx my + C1)(2 sxy + C2),  d = (mx^2 + my^2 + C1)(sx + sy + C2),
//   ssim_c = clamp((1 - n / d) / 2, 0, 1),  C1 = 0.01^2, C2 = 0.03^2,
//   err = 0.85 * mean_c(ssim_c) + 0.15 * mean_c(|y - x|).
// Preds (and the taps) are f32 or bf16 and are read as f32; target, g and
// err are f32.  The library is built with -fmad=false and every expression
// keeps the plain torch version's order (pools: rows, then columns, each sum
// times 1/3), so the kernels round op by op like it: the moments cancel
// (E[x^2] - mu^2) and the SSIM ratio amplifies their rounding where d is
// near C1 * C2.
//
// Forward: one thread per output pixel; per channel it reads the 3x3
// reflect-indexed window of pred and target and writes err.
//
// Backward: one thread per pred pixel q.  Per channel it reads the 5x5
// reflect-indexed neighbourhood of pred and target once; then for each error
// pixel r whose reflected window holds q (r within one pixel of q) it
// recomputes r's moments and forms d err_r / d(mx, P(xx), P(xy)) * g_r,
// which the pool adjoint carries to q with weight w_rq / 9.  w_rq is the
// product of a row and a column multiplicity in {0, 1, 2}: pixel 1 sits twice
// in row 0's reflected window, pixel H-2 twice in row H-1's.  The L1 term
// adds -0.15 / C * g_q * sign(y_q - x_q), with sign(0) = +1 (jnp.abs's
// subgradient at a tie).  The clamp passes the gradient strictly inside
// [0, 1] and half of it at an exact bound (jnp.clip's subgradient).  With
// `contract` the thread writes only dc = (sum_c dpred_c dx_c, sum_c dpred_c
// dy_c) as (N, 2, H, W) f32, without the boundary mask; otherwise dpred in
// preds' type.
//
// Bounds at the main path's shape (N = 24, 192 x 640 x 3, B = 3, bf16 preds
// and taps) at 3.35 TB/s: K6 moves preds 17.7 MB + target 4.4 MB + err
// 11.8 MB, ~10 us; K6' preds, target, g and dpred, ~15 us; K7/K8 preds, dx,
// dy, target, g and dc, ~28 us.  The function needs ~60 flops per pixel and
// channel forward and ~180 backward, so at 67 TFLOP/s float32 K6' is bound
// by operations (~24 us).  This backward recomputes each error pixel's
// moments for all nine of its neighbours (~9x the function's flops); reading
// a shared-memory tile of moments once per block is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kC1 = 1e-4f;  // 0.01^2
constexpr float kC2 = 9e-4f;  // 0.03^2
constexpr float kThird = 1.0f / 3.0f;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// reflect an index of [-1, n] into [0, n) (row -1 -> 1, row n -> n - 2),
// then clamp, so indices that no valid window uses stay in bounds
__device__ __forceinline__ int reflect(int k, int n) {
  k = k < 0 ? -k : (k >= n ? 2 * n - 2 - k : k);
  return min(max(k, 0), n - 1);
}

// 3x3 mean of v[r0 + a][c0 + b], a, b in 0..2: rows first, then columns,
// each sum times 1/3 (losses/photometric.py::_avg_pool3)
template <int N>
__device__ __forceinline__ float pool3(const float (&v)[N][N], int r0, int c0) {
  float col[3];
#pragma unroll
  for (int b = 0; b < 3; ++b)
    col[b] = (v[r0][c0 + b] + v[r0 + 1][c0 + b] + v[r0 + 2][c0 + b]) * kThird;
  return (col[0] + col[1] + col[2]) * kThird;
}

template <int N>
__device__ __forceinline__ float pool3_prod(const float (&u)[N][N],
                                            const float (&v)[N][N], int r0,
                                            int c0) {
  float col[3];
#pragma unroll
  for (int b = 0; b < 3; ++b)
    col[b] = (u[r0][c0 + b] * v[r0][c0 + b] +
              u[r0 + 1][c0 + b] * v[r0 + 1][c0 + b] +
              u[r0 + 2][c0 + b] * v[r0 + 2][c0 + b]) *
             kThird;
  return (col[0] + col[1] + col[2]) * kThird;
}

// SSIM terms of the error pixel whose 3x3 window is x[r0.., c0..]
struct Ssim {
  float mx, my, n1, n2, d1, d2, num, den, s;
};

template <int N>
__device__ __forceinline__ Ssim ssim_terms(const float (&x)[N][N],
                                           const float (&y)[N][N], int r0,
                                           int c0) {
  Ssim t;
  t.mx = pool3(x, r0, c0);
  t.my = pool3(y, r0, c0);
  const float sx = pool3_prod(x, x, r0, c0) - t.mx * t.mx;
  const float sy = pool3_prod(y, y, r0, c0) - t.my * t.my;
  const float sxy = pool3_prod(x, y, r0, c0) - t.mx * t.my;
  t.n1 = 2.0f * t.mx * t.my + kC1;
  t.n2 = 2.0f * sxy + kC2;
  t.d1 = t.mx * t.mx + t.my * t.my + kC1;
  t.d2 = sx + sy + kC2;
  t.num = t.n1 * t.n2;
  t.den = t.d1 * t.d2;
  t.s = (1.0f - t.num / t.den) * 0.5f;
  return t;
}

template <typename T>
__global__ void err_fwd_kernel(const T* __restrict__ preds,
                               const float* __restrict__ target,
                               float* __restrict__ err, int64_t n_pix, int B,
                               int H, int W, int C) {
  const int64_t p = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  const int64_t hw = (int64_t)H * W;
  const int64_t n = p / hw;
  const int64_t pix = p - n * hw;
  const int i = (int)(pix / W), j = (int)(pix % W);
  const T* xs = preds + n * hw * C;
  const float* ys = target + (n % B) * hw * C;
  int64_t off[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      off[a][b] = ((int64_t)reflect(i + a - 1, H) * W + reflect(j + b - 1, W)) * C;

  float ssim_sum = 0.0f, l1_sum = 0.0f;
  for (int c = 0; c < C; ++c) {
    float x[3][3], y[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        x[a][b] = load(xs + off[a][b] + c);
        y[a][b] = ys[off[a][b] + c];
      }
    const Ssim t = ssim_terms(x, y, 0, 0);
    ssim_sum += fminf(fmaxf(t.s, 0.0f), 1.0f);
    l1_sum += fabsf(y[1][1] - x[1][1]);
  }
  const float inv_c = 1.0f / (float)C;
  err[p] = 0.85f * (ssim_sum * inv_c) + 0.15f * (l1_sum * inv_c);
}

template <typename T, bool CONTRACT>
__global__ void err_bwd_kernel(const T* __restrict__ preds,
                               const float* __restrict__ target,
                               const float* __restrict__ g,
                               const T* __restrict__ dx,
                               const T* __restrict__ dy, T* __restrict__ dpred,
                               float* __restrict__ dc, int64_t n_pix, int B,
                               int H, int W, int C) {
  const int64_t p = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  const int64_t hw = (int64_t)H * W;
  const int64_t n = p / hw;
  const int64_t pix = p - n * hw;
  const int i = (int)(pix / W), j = (int)(pix % W);
  const T* xs = preds + n * hw * C;
  const float* ys = target + (n % B) * hw * C;
  const float* gn = g + n * hw;
  const float inv_c = 1.0f / (float)C;

  // the 5x5 neighbourhood: rows reflect(i - 2 .. i + 2), columns likewise
  int rows[5], cols[5];
#pragma unroll
  for (int a = 0; a < 5; ++a) {
    rows[a] = reflect(i + a - 2, H);
    cols[a] = reflect(j + a - 2, W);
  }
  // g_r / C times the pool-adjoint multiplicity w_rq, for the error pixel r
  // at (i + a - 1, j + b - 1); its window is rows[a..a+2] x cols[b..b+2]
  float gw[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int ri = i + a - 1;
    const int wr = (rows[a] == i) + (rows[a + 1] == i) + (rows[a + 2] == i);
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const int rj = j + b - 1;
      const int wc = (cols[b] == j) + (cols[b + 1] == j) + (cols[b + 2] == j);
      const bool valid = ri >= 0 && ri < H && rj >= 0 && rj < W;
      gw[a][b] = valid ? gn[(int64_t)ri * W + rj] * inv_c * (float)(wr * wc) : 0.0f;
    }
  }
  const float gq = gn[pix] * inv_c;

  float acc_x = 0.0f, acc_y = 0.0f;
  for (int c = 0; c < C; ++c) {
    float x[5][5], y[5][5];
#pragma unroll
    for (int a = 0; a < 5; ++a)
#pragma unroll
      for (int b = 0; b < 5; ++b) {
        const int64_t o = ((int64_t)rows[a] * W + cols[b]) * C + c;
        x[a][b] = load(xs + o);
        y[a][b] = ys[o];
      }
    const float xq = x[2][2], yq = y[2][2];
    float dp = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        if (gw[a][b] == 0.0f) continue;
        const Ssim t = ssim_terms(x, y, a, b);
        if (!(t.s >= 0.0f && t.s <= 1.0f)) continue;  // clamped: no gradient
        const float live = (t.s > 0.0f && t.s < 1.0f) ? 1.0f : 0.5f;
        // s = (1 - num / den) / 2
        const float k = 0.85f * live * gw[a][b] * 0.5f / t.den;
        const float dnum = -k;
        const float dden = k * (t.num / t.den);
        const float dn1 = dnum * t.n2, dn2 = dnum * t.n1;
        const float dd1 = dden * t.d2, dd2 = dden * t.d1;
        // mx enters n1, sxy, d1 and sx; P(xx) enters sx; P(xy) enters sxy
        const float dmx = 2.0f * (t.my * (dn1 - dn2) + t.mx * (dd1 - dd2));
        const float dxx = dd2;
        const float dxy = 2.0f * dn2;
        dp += (dmx + 2.0f * xq * dxx + yq * dxy) * (1.0f / 9.0f);
      }
    dp += yq - xq >= 0.0f ? -0.15f * gq : 0.15f * gq;
    if (CONTRACT) {
      acc_x += dp * load(dx + p * C + c);
      acc_y += dp * load(dy + p * C + c);
    } else {
      store(dpred + p * C + c, dp);
    }
  }
  if (CONTRACT) {
    dc[n * 2 * hw + pix] = acc_x;
    dc[n * 2 * hw + hw + pix] = acc_y;
  }
}

constexpr int kThreads = 256;

inline unsigned blocks_for(int64_t n_pix) {
  return (unsigned)((n_pix + kThreads - 1) / kThreads);
}

template <typename T>
void launch_bwd(const void* preds, const float* target, const float* g,
                const void* dx, const void* dy, void* dpred, float* dc,
                int64_t n_pix, int B, int H, int W, int C, cudaStream_t s) {
  if (dc != nullptr) {
    err_bwd_kernel<T, true><<<blocks_for(n_pix), kThreads, 0, s>>>(
        (const T*)preds, target, g, (const T*)dx, (const T*)dy, nullptr, dc,
        n_pix, B, H, W, C);
  } else {
    err_bwd_kernel<T, false><<<blocks_for(n_pix), kThreads, 0, s>>>(
        (const T*)preds, target, g, nullptr, nullptr, (T*)dpred, nullptr,
        n_pix, B, H, W, C);
  }
}

}  // namespace

// preds (N, H, W, C) f32 or bf16 (bf16 set), target (B, H, W, C) f32, err
// (N, H, W) f32; all contiguous, H, W >= 2.  Returns cudaGetLastError().
extern "C" int tpuslam_reproj_err(const void* preds, const void* target,
                                  void* err, int64_t N, int B, int H, int W,
                                  int C, int bf16, void* stream) {
  const int64_t n_pix = N * (int64_t)H * W;
  if (n_pix > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16) {
      err_fwd_kernel<__nv_bfloat16><<<blocks_for(n_pix), kThreads, 0, s>>>(
          (const __nv_bfloat16*)preds, (const float*)target, (float*)err,
          n_pix, B, H, W, C);
    } else {
      err_fwd_kernel<float><<<blocks_for(n_pix), kThreads, 0, s>>>(
          (const float*)preds, (const float*)target, (float*)err, n_pix, B, H,
          W, C);
    }
  }
  return (int)cudaGetLastError();
}

// The backward of tpuslam_reproj_err for the error cotangent g (N, H, W) f32.
// With dc == null it writes dpred (N, H, W, C) in preds' type; otherwise it
// reads the taps dx, dy (N, H, W, C, preds' type) and writes dc (N, 2, H, W)
// f32.  Returns cudaGetLastError().
extern "C" int tpuslam_reproj_err_bwd(const void* preds, const void* target,
                                      const void* g, const void* dx,
                                      const void* dy, void* dpred, void* dc,
                                      int64_t N, int B, int H, int W, int C,
                                      int bf16, void* stream) {
  const int64_t n_pix = N * (int64_t)H * W;
  if (n_pix > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16) {
      launch_bwd<__nv_bfloat16>(preds, (const float*)target, (const float*)g,
                                dx, dy, dpred, (float*)dc, n_pix, B, H, W, C,
                                s);
    } else {
      launch_bwd<float>(preds, (const float*)target, (const float*)g, dx, dy,
                        dpred, (float*)dc, n_pix, B, H, W, C, s);
    }
  }
  return (int)cudaGetLastError();
}
