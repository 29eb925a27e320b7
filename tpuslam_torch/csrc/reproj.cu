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
// The backward.  For pred pixel q and error pixel r within one pixel of it,
// d err_r / d x_q = w_rq / 9 * (dmx_r + 2 x_q dP(xx)_r + y_q dP(xy)_r): the
// three pool-adjoint coefficients of r (d err_r / d(mx, P(xx), P(xy)) times
// g_r / C) reach q with the reflect multiplicity w_rq, the product of a row
// and a column count in {0, 1, 2}: pixel 1 sits twice in row 0's reflected
// window, pixel H-2 twice in row H-1's.  The L1 term adds -0.15 / C * g_q *
// sign(y_q - x_q), with sign(0) = +1 (jnp.abs's subgradient at a tie).  The
// clamp passes the gradient strictly inside [0, 1] and half of it at an
// exact bound (jnp.clip's subgradient).  With `contract` the kernel writes
// only dc = (sum_c dpred_c dx_c, sum_c dpred_c dy_c) as (N, 2, H, W) f32,
// without the boundary mask; otherwise dpred in preds' type.
//
// What bounds them.  At the main path's shape (N = 24, 192 x 640 x 3, B = 3,
// bf16 preds and taps) the compulsory bytes are K6 33.9 MB (preds, target,
// err), K6' 51.6 MB (preds, target, g, dpred) and K7/K8 92.9 MB (preds, dx,
// dy, target, g, dc): 10, 15 and 28 us at 3.35 TB/s.  The function needs
// ~60 operations per pixel and channel forward and ~180 backward, each a
// separate instruction under -fmad=false (with two IEEE divisions of ~10
// instructions each per error pixel), so the backward's floor from the
// float32 pipes alone is ~50 us at the card's 33.5 T instructions/s: the
// backward is bound by operations, the forward by bytes.
//
// The design: one block of 256 threads per tile of one image (forward 32 x
// 64 pixels, backward 16 x 64), at most 64 registers a thread, so that four
// blocks share an SM.  Per channel the block stages the tile's pred and
// target, widened by the pools' halo, into shared memory as f32: warp w
// takes staged rows w, w + 8, ..., its lanes consecutive columns, so
// consecutive lanes read consecutive pixels.  Reflection at the image border
// is resolved once per block in a row and a column offset table; offsets
// inside an image are 32-bit.  The pools are separable and slide: a thread
// owns a run of pixels in one row (8 forward, 5 in the backward's pass B),
// keeps the vertical 3-means of x, y, xx, yy and xy of the last three
// columns in registers and adds one column per pixel, so a pixel's five
// moments take ~35 operations instead of ~90 and ~2.5 shared loads instead
// of 18.  The forward keeps each thread's SSIM and L1 sums over the channels
// in registers and writes the err tile through shared memory in whole rows.
// The backward, per channel: pass B computes every error pixel's moments,
// SSIM ratio and three coefficients once per block (the tile widened by one
// pixel, 18 x 70: ~1.2x the function's error pixels) into shared memory;
// pass C gives a thread R = 4 pred pixels of one column, slides down the
// coefficient rows (9 shared loads per row, each row used by up to three of
// its pixels) and sums each pixel's nine terms in the order a, b of its 3 x 3
// neighbourhood, then its L1 term; its taps are loaded at the start of pass
// C.  Threads whose pixels touch the reflected border read their w_rq from a
// packed word in shared memory; all others use 1.  Multiplying a term by
// w_rq / 9 rather than w_rq into g_r first is exact (w_rq is a power of
// two), so every moment, ratio and term is the same float as in the
// one-thread-per-pixel kernel this replaced, and the outputs are
// bit-identical to it.  Nothing but the outputs reaches device memory, as
// the TPU kernel's VMEM recompute kept it.  What remains is instructions:
// ~105 per error pixel in pass B (two IEEE divisions of ~10 each among
// them) and 6 per term in pass C (the exact order leaves nothing to fuse),
// ~190 per pixel and channel in all.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kC1 = 1e-4f;  // 0.01^2
constexpr float kC2 = 9e-4f;  // 0.03^2
constexpr float kThird = 1.0f / 3.0f;
constexpr float kNinth = 1.0f / 9.0f;
constexpr int kThreads = 256;

// Both kernels are held to 64 registers a thread: four blocks share an SM.
constexpr int kMinBlocks = 4;

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

// how often pixel q's row (or column) sits in the reflected window of the
// error pixel r's: 0 if r is outside [0, n), else 1 or 2
__device__ __forceinline__ int multiplicity(int r, int q, int n) {
  if (r < 0 || r >= n) return 0;
  return (reflect(r - 1, n) == q) + (r == q) + (reflect(r + 1, n) == q);
}

// vertical 3-means of x, y, xx, yy, xy at one column (pool3's first pass)
struct Col {
  float x, y, xx, yy, xy;
};

__device__ __forceinline__ Col col3(float x0, float x1, float x2, float y0,
                                    float y1, float y2) {
  Col v;
  v.x = (x0 + x1 + x2) * kThird;
  v.y = (y0 + y1 + y2) * kThird;
  v.xx = (x0 * x0 + x1 * x1 + x2 * x2) * kThird;
  v.yy = (y0 * y0 + y1 * y1 + y2 * y2) * kThird;
  v.xy = (x0 * y0 + x1 * y1 + x2 * y2) * kThird;
  return v;
}

// SSIM terms of the error pixel whose three columns are a, b, c
struct Ssim {
  float mx, my, n1, n2, d1, d2, num, den, s;
};

__device__ __forceinline__ Ssim ssim_terms(const Col& a, const Col& b,
                                           const Col& c) {
  Ssim t;
  t.mx = (a.x + b.x + c.x) * kThird;
  t.my = (a.y + b.y + c.y) * kThird;
  const float sx = (a.xx + b.xx + c.xx) * kThird - t.mx * t.mx;
  const float sy = (a.yy + b.yy + c.yy) * kThird - t.my * t.my;
  const float sxy = (a.xy + b.xy + c.xy) * kThird - t.mx * t.my;
  t.n1 = 2.0f * t.mx * t.my + kC1;
  t.n2 = 2.0f * sxy + kC2;
  t.d1 = t.mx * t.mx + t.my * t.my + kC1;
  t.d2 = sx + sy + kC2;
  t.num = t.n1 * t.n2;
  t.den = t.d1 * t.d2;
  t.s = (1.0f - t.num / t.den) * 0.5f;
  return t;
}

// Stage channel c of the SH x SW tile of pred and target (rows `rowofs`,
// offsets row * W; columns `colofs`) into planes of pitch SP as f32.  Warp w
// takes rows w, w + 8, ...; its lanes take columns lane, lane + 32, ...:
// consecutive lanes read consecutive pixels and write consecutive banks.
template <int SH, int SW, int SP, typename T>
__device__ __forceinline__ void stage(float* xs, float* ys, const T* xn,
                                      const float* yn, const int* rowofs,
                                      const int* colofs, int C, int c) {
  constexpr int NCH = (SW + 31) / 32;
  const int lane = threadIdx.x & 31;
  int col[NCH];
#pragma unroll
  for (int j = 0; j < NCH; ++j)
    col[j] = lane + 32 * j < SW ? colofs[lane + 32 * j] * C + c : 0;
  for (int sr = threadIdx.x >> 5; sr < SH; sr += kThreads / 32) {
    const int ro = rowofs[sr] * C;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int sc = lane + 32 * j;
      if (sc < SW) {
        xs[sr * SP + sc] = load(xn + ro + col[j]);
        ys[sr * SP + sc] = yn[ro + col[j]];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// The forward's tile: TH x TW pixels of one image, runs of L along a row.
struct FwdTile {
  static constexpr int TH = 32, TW = 64, L = 8;
  static constexpr int NSEG = (TW + L - 1) / L;  // runs per row
  static constexpr int EW = NSEG * L;            // pixel columns computed
  static constexpr int SH = TH + 2, SW = EW + 2;  // staged, with the halo
  static constexpr int SP = SW | 1;  // odd pitch: a warp down a column hits 32 banks
  static_assert(TH * NSEG <= kThreads, "one run per thread");
};

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    err_fwd_kernel(const T* __restrict__ preds, const float* __restrict__ target,
                   float* __restrict__ err, int B, int H, int W, int C) {
  constexpr int TH = FwdTile::TH, TW = FwdTile::TW, L = FwdTile::L;
  constexpr int SH = FwdTile::SH, SW = FwdTile::SW, SP = FwdTile::SP, EW = FwdTile::EW;
  __shared__ float xs[SH * SP], ys[SH * SP];
  __shared__ float et[TH * EW];
  __shared__ int rowofs[SH], colofs[SW];

  const int tid = threadIdx.x;
  const int i0 = blockIdx.y * TH, j0 = blockIdx.x * TW, n = blockIdx.z;
  const int64_t hw = (int64_t)H * W;
  const T* xn = preds + n * hw * C;
  const float* yn = target + (n % B) * hw * C;
  for (int k = tid; k < SH; k += kThreads) rowofs[k] = reflect(i0 - 1 + k, H) * W;
  for (int k = tid; k < SW; k += kThreads) colofs[k] = reflect(j0 - 1 + k, W);

  // this thread's run: row `row` of the tile, columns c0 .. c0 + L - 1
  const bool owner = tid < TH * FwdTile::NSEG;
  const int row = tid % TH, c0 = (tid / TH) * L;
  float ssim_sum[L], l1_sum[L];
#pragma unroll
  for (int k = 0; k < L; ++k) ssim_sum[k] = l1_sum[k] = 0.0f;

  for (int c = 0; c < C; ++c) {
    __syncthreads();  // offsets written; the last channel's planes read
    stage<SH, SW, SP>(xs, ys, xn, yn, rowofs, colofs, C, c);
    __syncthreads();
    if (!owner) continue;
    const float* x = xs + row * SP + c0;
    const float* y = ys + row * SP + c0;
    Col v0{}, v1{}, v2{};
    float diff_prev = 0.0f, diff = 0.0f;  // y - x on the centre row
#pragma unroll
    for (int s = 0; s < L + 2; ++s) {
      const float x1 = x[SP + s], y1 = y[SP + s];
      v0 = v1;
      v1 = v2;
      v2 = col3(x[s], x1, x[2 * SP + s], y[s], y1, y[2 * SP + s]);
      diff_prev = diff;
      diff = y1 - x1;
      if (s >= 2) {  // the pixel of the centre column s - 1
        const Ssim t = ssim_terms(v0, v1, v2);
        ssim_sum[s - 2] += fminf(fmaxf(t.s, 0.0f), 1.0f);
        l1_sum[s - 2] += fabsf(diff_prev);
      }
    }
  }
  const float inv_c = 1.0f / (float)C;
  if (owner) {
#pragma unroll
    for (int k = 0; k < L; ++k)
      et[row * EW + c0 + k] = 0.85f * (ssim_sum[k] * inv_c) + 0.15f * (l1_sum[k] * inv_c);
  }
  __syncthreads();
  float* en = err + n * hw;
  for (int k = tid; k < TH * TW; k += kThreads) {
    const int r = k / TW, cc = k - r * TW;
    if (i0 + r < H && j0 + cc < W) en[(i0 + r) * W + j0 + cc] = et[r * EW + cc];
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// The backward's tile: TH x TW pred pixels of one image, pass-B runs of LB
// error pixels along a row, pass-C runs of R pred pixels down a column.
struct BwdTile {
  static constexpr int TH = 16, TW = 64, LB = 5, R = 4;
  static constexpr int EH = TH + 2;                     // error rows
  static constexpr int NSEG = (TW + 2 + LB - 1) / LB;  // pass-B runs per row
  static constexpr int EW = NSEG * LB;                 // error columns
  static constexpr int EP = EW | 1;
  static constexpr int SH = TH + 4, SW = EW + 2;  // staged pred and target
  static constexpr int SP = SW | 1;
  static constexpr int NB = EH * NSEG;      // pass-B runs
  static constexpr int NC = TW * (TH / R);  // pass-C runs, one per thread
  static_assert(TH % R == 0 && NC <= kThreads, "one pass-C run per thread");
  static_assert(R <= 4, "w_rq of R pixels packed in 32 bits");
  static_assert((2 * SH * SP + 4 * EH * EP + SH + SW) * 4 <= 48 * 1024,
                "static shared memory");
};

// d err / d x_q of the R pred pixels of one column: the nine terms of each,
// rows a then columns b of its neighbourhood.  cm, cxx, cxy hold the error
// pixels' coefficients (pitch EP); (t0, jl) is the error-tile position of the
// first pixel's top-left neighbour.  BORDER: w_rq = wr * wc from `wpack`
// (2 bits each: wr of pixel t and row a at 2 (3 t + a), wc of column b at
// 24 + 2 b); else every w_rq is 1.
template <bool BORDER, int R, int EP>
__device__ __forceinline__ void gather(const float* cm, const float* cxx,
                                       const float* cxy, int t0, int jl,
                                       const float (&xq)[R], const float (&yq)[R],
                                       float (&dp)[R], int wpack) {
#pragma unroll
  for (int t = 0; t < R; ++t) dp[t] = 0.0f;
#pragma unroll
  for (int e = 0; e < R + 2; ++e) {
    const int o = (t0 + e) * EP + jl;
    float m[3], xx[3], xy[3];
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      m[b] = cm[o + b];
      xx[b] = cxx[o + b];
      xy[b] = cxy[o + b];
    }
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int a = e - t;  // error row qi + t + a - 1 of pixel t
      if (a < 0 || a > 2) continue;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const int w = ((wpack >> (2 * (3 * t + a))) & 3) * ((wpack >> (24 + 2 * b)) & 3);
        dp[t] += (m[b] + 2.0f * xq[t] * xx[b] + yq[t] * xy[b]) *
                 (BORDER ? (float)w * kNinth : kNinth);
      }
    }
  }
}

template <typename T, bool CONTRACT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    err_bwd_kernel(const T* __restrict__ preds, const float* __restrict__ target,
                   const float* __restrict__ g, const T* __restrict__ dx,
                   const T* __restrict__ dy, T* __restrict__ dpred,
                   float* __restrict__ dc, int B, int H, int W, int C) {
  constexpr int TH = BwdTile::TH, TW = BwdTile::TW, LB = BwdTile::LB, R = BwdTile::R;
  constexpr int SH = BwdTile::SH, SW = BwdTile::SW, SP = BwdTile::SP, EP = BwdTile::EP;
  constexpr int EC = BwdTile::EH * EP;
  __shared__ float xs[SH * SP], ys[SH * SP];
  __shared__ float gs[EC];  // g_r / C, 0 outside the image
  __shared__ float cm[EC], cxx[EC], cxy[EC];  // the error pixels' coefficients
  __shared__ int rowofs[SH], colofs[SW];
  __shared__ int wmul[kThreads];  // each thread's packed w_rq (gather)

  const int tid = threadIdx.x;
  const int i0 = blockIdx.y * TH, j0 = blockIdx.x * TW, n = blockIdx.z;
  const int64_t hw = (int64_t)H * W;
  const T* xn = preds + n * hw * C;
  const float* yn = target + (n % B) * hw * C;
  const float* gn = g + n * hw;
  const float inv_c = 1.0f / (float)C;
  for (int k = tid; k < SH; k += kThreads) rowofs[k] = reflect(i0 - 2 + k, H) * W;
  for (int k = tid; k < SW; k += kThreads) colofs[k] = reflect(j0 - 2 + k, W);
  for (int k = tid; k < BwdTile::EH * BwdTile::EW; k += kThreads) {
    const int er = k / BwdTile::EW, ec = k - er * BwdTile::EW;
    const int ri = i0 - 1 + er, rj = j0 - 1 + ec;
    gs[er * EP + ec] =
        (ri >= 0 && ri < H && rj >= 0 && rj < W) ? gn[ri * W + rj] * inv_c : 0.0f;
  }
  __syncthreads();

  // this thread's pass-C run: column jl, rows t0 .. t0 + R - 1 of the tile
  const bool owner = tid < BwdTile::NC;
  const int jl = tid % TW, t0 = (tid / TW) * R;
  const int qi = i0 + t0, qj = j0 + jl;
  const bool border = qi < 2 || qi + R > H - 2 || qj < 2 || qj > W - 3;
  int wpack = 0;
  if (border) {
#pragma unroll
    for (int t = 0; t < R; ++t)
#pragma unroll
      for (int a = 0; a < 3; ++a)
        wpack |= multiplicity(qi + t + a - 1, qi + t, H) << (2 * (3 * t + a));
#pragma unroll
    for (int b = 0; b < 3; ++b) wpack |= multiplicity(qj + b - 1, qj, W) << (24 + 2 * b);
  }
  wmul[tid] = wpack;  // read back inside the channel loop: not held in registers
  float acc_x[R], acc_y[R];
#pragma unroll
  for (int t = 0; t < R; ++t) acc_x[t] = acc_y[t] = 0.0f;

  for (int c = 0; c < C; ++c) {
    if (c > 0) __syncthreads();  // the last channel's planes and coefficients read
    stage<SH, SW, SP>(xs, ys, xn, yn, rowofs, colofs, C, c);
    __syncthreads();

    // pass B: each error pixel's coefficients, runs of LB along a row
    for (int k = tid; k < BwdTile::NB; k += kThreads) {
      const int er = k % BwdTile::EH, e0 = (k / BwdTile::EH) * LB;
      const float* x = xs + er * SP + e0;
      const float* y = ys + er * SP + e0;
      Col v0{}, v1{}, v2{};
#pragma unroll
      for (int s = 0; s < LB + 2; ++s) {
        v0 = v1;
        v1 = v2;
        v2 = col3(x[s], x[SP + s], x[2 * SP + s], y[s], y[SP + s], y[2 * SP + s]);
        if (s < 2) continue;
        const int o = er * EP + e0 + s - 2;
        const float gr = gs[o];
        float dmx = 0.0f, dxx = 0.0f, dxy = 0.0f;
        if (gr != 0.0f) {
          const Ssim t = ssim_terms(v0, v1, v2);
          if (t.s >= 0.0f && t.s <= 1.0f) {  // else clamped: no gradient
            const float live = (t.s > 0.0f && t.s < 1.0f) ? 1.0f : 0.5f;
            // s = (1 - num / den) / 2
            const float kk = 0.85f * live * gr * 0.5f / t.den;
            const float dnum = -kk;
            const float dden = kk * (t.num / t.den);
            const float dn1 = dnum * t.n2, dn2 = dnum * t.n1;
            const float dd1 = dden * t.d2, dd2 = dden * t.d1;
            // mx enters n1, sxy, d1 and sx; P(xx) enters sx; P(xy) enters sxy
            dmx = 2.0f * (t.my * (dn1 - dn2) + t.mx * (dd1 - dd2));
            dxx = dd2;
            dxy = 2.0f * dn2;
          }
        }
        cm[o] = dmx;
        cxx[o] = dxx;
        cxy[o] = dxy;
      }
    }
    __syncthreads();

    // pass C: gather each pred pixel's nine terms, then the L1 term
    if (!owner) continue;
    float xq[R], yq[R], dp[R], tdx[R], tdy[R];
#pragma unroll
    for (int t = 0; t < R; ++t) {
      xq[t] = xs[(t0 + t + 2) * SP + jl + 2];
      yq[t] = ys[(t0 + t + 2) * SP + jl + 2];
      if (CONTRACT) {  // the taps, loaded before the gather that precedes their use
        const bool in = qi + t < H && qj < W;
        const int o = ((qi + t) * W + qj) * C + c;
        tdx[t] = in ? load(dx + n * hw * C + o) : 0.0f;
        tdy[t] = in ? load(dy + n * hw * C + o) : 0.0f;
      }
    }
    if (border)
      gather<true, R, EP>(cm, cxx, cxy, t0, jl, xq, yq, dp, wmul[tid]);
    else
      gather<false, R, EP>(cm, cxx, cxy, t0, jl, xq, yq, dp, 0);
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const float gq = gs[(t0 + t + 1) * EP + jl + 1];
      dp[t] += yq[t] - xq[t] >= 0.0f ? -0.15f * gq : 0.15f * gq;
      if (CONTRACT) {
        acc_x[t] += dp[t] * tdx[t];
        acc_y[t] += dp[t] * tdy[t];
      } else if (qi + t < H && qj < W) {
        store(dpred + n * hw * C + ((qi + t) * W + qj) * C + c, dp[t]);
      }
    }
  }
  if (CONTRACT && owner) {
#pragma unroll
    for (int t = 0; t < R; ++t) {
      if (qi + t >= H || qj >= W) continue;
      const int o = (qi + t) * W + qj;
      dc[n * 2 * hw + o] = acc_x[t];
      dc[n * 2 * hw + hw + o] = acc_y[t];
    }
  }
}

template <typename T>
void launch_fwd(const void* preds, const float* target, float* err, int64_t N,
                int B, int H, int W, int C, cudaStream_t s) {
  constexpr int TH = FwdTile::TH, TW = FwdTile::TW;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, (unsigned)N);
  err_fwd_kernel<T><<<grid, kThreads, 0, s>>>(
      (const T*)preds, target, err, B, H, W, C);
}

template <typename T>
void launch_bwd(const void* preds, const float* target, const float* g,
                const void* dx, const void* dy, void* dpred, float* dc,
                int64_t N, int B, int H, int W, int C, cudaStream_t s) {
  constexpr int TH = BwdTile::TH, TW = BwdTile::TW;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, (unsigned)N);
  if (dc != nullptr) {
    err_bwd_kernel<T, true><<<grid, kThreads, 0, s>>>(
        (const T*)preds, target, g, (const T*)dx, (const T*)dy, nullptr, dc, B,
        H, W, C);
  } else {
    err_bwd_kernel<T, false><<<grid, kThreads, 0, s>>>(
        (const T*)preds, target, g, nullptr, nullptr, (T*)dpred, nullptr, B, H,
        W, C);
  }
}

// one image's offsets fit 32 bits; the grid's z holds the images
inline bool shape_ok(int64_t N, int H, int W, int C) {
  return N <= 65535 && (int64_t)H * W * C < (int64_t(1) << 31);
}

}  // namespace

// preds (N, H, W, C) f32 or bf16 (bf16 set), target (B, H, W, C) f32, err
// (N, H, W) f32; all contiguous, H, W >= 2, N <= 65535, H * W * C < 2^31.
// Returns cudaGetLastError().
extern "C" int tpuslam_reproj_err(const void* preds, const void* target,
                                  void* err, int64_t N, int B, int H, int W,
                                  int C, int bf16, void* stream) {
  if (!shape_ok(N, H, W, C)) return (int)cudaErrorInvalidValue;
  if (N > 0 && H > 0 && W > 0 && C > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16)
      launch_fwd<__nv_bfloat16>(preds, (const float*)target, (float*)err, N, B, H, W, C, s);
    else
      launch_fwd<float>(preds, (const float*)target, (float*)err, N, B, H, W, C, s);
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
  if (!shape_ok(N, H, W, C)) return (int)cudaErrorInvalidValue;
  if (N > 0 && H > 0 && W > 0 && C > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16) {
      launch_bwd<__nv_bfloat16>(preds, (const float*)target, (const float*)g,
                                dx, dy, dpred, (float*)dc, N, B, H, W, C, s);
    } else {
      launch_bwd<float>(preds, (const float*)target, (const float*)g, dx, dy,
                        dpred, (float*)dc, N, B, H, W, C, s);
    }
  }
  return (int)cudaGetLastError();
}
