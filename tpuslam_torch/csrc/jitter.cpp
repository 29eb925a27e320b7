// Colour jitter of one float32 (H, W, 3) image on the host: brightness,
// contrast, saturation and hue, each with its own factor, in a drawn order.
//
// The same function as the numpy helpers of tpuslam_torch/data/base.py
// (adjust_brightness, adjust_contrast, adjust_saturation, adjust_hue), which
// the JAX package's data pipeline shares, computed pixel by pixel instead of
// as whole-image expressions with their temporaries:
//   blend(x, y, f) = clip(f x + (1 - f) y, 0, 1), (1 - f) taken in double and
//       then rounded, as numpy rounds a Python float to float32;
//   brightness: blend(x, 0, f);
//   contrast:   blend(x, mean grey of the image as it stands, f);
//   saturation: blend(x, grey of the pixel, f);
//   grey = 0.299 r + 0.587 g + 0.114 b;
//   hue: HSV round trip with the hue turned by f (branches delta == 0,
//       maxc == 0, then maxc == r, then maxc == g), sector floor(6 h) mod 6.
// Every op is float32 and in numpy's order.  The library is built with
// -ffp-contract=off and without -ffast-math, so nothing is fused or
// reassociated behind the code's back.  Two places follow numpy's own
// evaluation rather than the formula's text: the grey dot product is a chain
// of fused multiply-adds, r first, as BLAS evaluates `img @ gray`; and the
// mean is numpy's float32 reduction: pairwise sums (8 accumulators, blocks of
// 128) over chunks of 8192 values, the chunks added in turn.
//
// Contrast needs the mean grey of the image after the ops drawn before it.
// So there are two passes over the pixels: the first applies the ops before
// contrast, writes the result and keeps each pixel's grey; the second applies
// contrast and the ops after it in place.  Each pass takes blocks of pixels
// split into r, g and b rows and runs one op at a time along them.  The
// compiler vectorises the blends; the hue is written on 8-lane vectors, since
// its branches would keep it scalar, and every lane computes both sides of
// each select.  On x86-64 the passes are built twice, with FMA and AVX and
// for the baseline, and the loader picks by the CPU; both give the same IEEE
// results.  One thread; the caller (ctypes) runs it without Python's lock.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__x86_64__) && defined(__GNUC__)
#define JITTER_CLONES __attribute__((target_clones("fma", "default")))
#else
#define JITTER_CLONES
#endif
#define INLINE inline __attribute__((always_inline))

namespace {

constexpr float kGrey[3] = {0.299f, 0.587f, 0.114f};
constexpr int64_t kReduceChunk = 8192;  // numpy's iterator buffer size
constexpr int64_t kPairwiseBlock = 128;
constexpr int64_t kBlock = 512;  // pixels a block

enum Op { kBrightness = 0, kContrast = 1, kSaturation = 2, kHue = 3 };

struct Blend {
  float f, g;  // f and 1 - f, each rounded to float32 from double
};

INLINE Blend make_blend(double factor) {
  return {static_cast<float>(factor), static_cast<float>(1.0 - factor)};
}

INLINE float clip01(float x) { return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x); }

INLINE float blend(float x, float y, Blend b) { return clip01(b.f * x + b.g * y); }

INLINE float grey(float r, float g, float b) {
  return std::fma(b, kGrey[2], std::fma(g, kGrey[1], r * kGrey[0]));
}

struct Jitter {
  Blend brightness, contrast, saturation;
  float turn;
  float mean;  // the contrast's mean grey, once the first pass has run
};

typedef float F8 __attribute__((vector_size(32)));
typedef int32_t I8 __attribute__((vector_size(32)));

INLINE F8 clip01(F8 x, F8 zero, F8 one) {
  const F8 low = x < zero ? zero : x;
  return low > one ? one : low;
}

// floor, exactly, of lanes of magnitude below 2^31
INLINE F8 floor8(F8 x) {
  const F8 t = __builtin_convertvector(__builtin_convertvector(x, I8), F8);
  return t > x ? t - 1.0f : t;
}

// numpy's float32 `x % 1.0` (fmod, then + 1 where negative) is x - floor(x)
// exactly: fmod's remainder is exact, and both round x + n + 1 once
INLINE F8 mod1(F8 x) { return x - floor8(x); }

// adjust_hue on 8 pixels
INLINE void hue8(F8& r, F8& g, F8& b, float turn) {
  const F8 zero = {}, one = zero + 1.0f;
  const F8 maxrg = r > g ? r : g, minrg = r < g ? r : g;
  const F8 maxc = maxrg > b ? maxrg : b;
  const F8 minc = minrg < b ? minrg : b;
  const F8 v = maxc;
  const F8 delta = maxc - minc;
  const I8 flat = delta == zero, black = maxc == zero;
  const F8 safe = flat ? one : delta;
  const F8 s = black ? zero : delta / (black ? one : maxc);
  const F8 rc = (maxc - r) / safe;
  const F8 gc = (maxc - g) / safe;
  const F8 bc = (maxc - b) / safe;
  F8 h = maxc == r ? bc - gc : (maxc == g ? (2.0f + rc) - bc : (4.0f + gc) - rc);
  h = mod1((flat ? zero : h) / 6.0f);
  h = mod1(h + turn);
  const F8 i = floor8(h * 6.0f);
  const F8 f = h * 6.0f - i;
  const F8 p = v * (1.0f - s);
  const F8 q = v * (1.0f - s * f);
  const F8 t = v * (1.0f - s * (1.0f - f));
  const F8 k = i == 6.0f ? zero : i;  // the sector, i mod 6, compared as floats
  // sector k:  0  1  2  3  4  5
  //   r        v  q  p  p  t  v
  //   g        t  v  v  q  p  p
  //   b        p  p  t  v  v  q
  const F8 o0 = k == 1.0f ? q : ((k == 2.0f) | (k == 3.0f) ? p : (k == 4.0f ? t : v));
  const F8 o1 = k == 0.0f ? t : ((k == 1.0f) | (k == 2.0f) ? v : (k == 3.0f ? q : p));
  const F8 o2 = k == 2.0f ? t : ((k == 3.0f) | (k == 4.0f) ? v : (k == 5.0f ? q : p));
  r = clip01(o0, zero, one);
  g = clip01(o1, zero, one);
  b = clip01(o2, zero, one);
}

// ops[0..n_ops) on n pixels held as rows r, g, b
INLINE void apply_ops(const Jitter& j, const int32_t* ops, int n_ops, float* __restrict r,
                      float* __restrict g, float* __restrict b, int64_t n) {
  for (int o = 0; o < n_ops; ++o) {
    switch (ops[o]) {
      case kBrightness:
        for (int64_t i = 0; i < n; ++i) {
          r[i] = blend(r[i], 0.0f, j.brightness);
          g[i] = blend(g[i], 0.0f, j.brightness);
          b[i] = blend(b[i], 0.0f, j.brightness);
        }
        break;
      case kContrast:
        for (int64_t i = 0; i < n; ++i) {
          r[i] = blend(r[i], j.mean, j.contrast);
          g[i] = blend(g[i], j.mean, j.contrast);
          b[i] = blend(b[i], j.mean, j.contrast);
        }
        break;
      case kSaturation:
        for (int64_t i = 0; i < n; ++i) {
          const float y = grey(r[i], g[i], b[i]);
          r[i] = blend(r[i], y, j.saturation);
          g[i] = blend(g[i], y, j.saturation);
          b[i] = blend(b[i], y, j.saturation);
        }
        break;
      default:  // the rows hold whole vectors past n
        for (int64_t i = 0; i < n; i += 8) {
          F8 vr, vg, vb;
          std::memcpy(&vr, r + i, sizeof vr);
          std::memcpy(&vg, g + i, sizeof vg);
          std::memcpy(&vb, b + i, sizeof vb);
          hue8(vr, vg, vb, j.turn);
          std::memcpy(r + i, &vr, sizeof vr);
          std::memcpy(g + i, &vg, sizeof vg);
          std::memcpy(b + i, &vb, sizeof vb);
        }
    }
  }
}

// One pass: read src, run ops[0..n_ops), write dst (src may equal dst), and
// where `greys` is given keep each pixel's grey after the ops.
JITTER_CLONES
void pass(const Jitter& j, const int32_t* ops, int n_ops, const float* src, float* dst,
          int64_t pixels, float* greys) {
  float r[kBlock] = {}, g[kBlock] = {}, b[kBlock] = {};
  for (int64_t k0 = 0; k0 < pixels; k0 += kBlock) {
    const int64_t n = pixels - k0 < kBlock ? pixels - k0 : kBlock;
    const float* in = src + 3 * k0;
    for (int64_t i = 0; i < n; ++i) {
      r[i] = in[3 * i];
      g[i] = in[3 * i + 1];
      b[i] = in[3 * i + 2];
    }
    apply_ops(j, ops, n_ops, r, g, b, n);
    if (greys != nullptr) {
      for (int64_t i = 0; i < n; ++i) greys[k0 + i] = grey(r[i], g[i], b[i]);
    }
    float* out = dst + 3 * k0;
    for (int64_t i = 0; i < n; ++i) {
      out[3 * i] = r[i];
      out[3 * i + 1] = g[i];
      out[3 * i + 2] = b[i];
    }
  }
}

// numpy's pairwise_sum for float32 (loops_utils.h)
float pairwise_sum(const float* a, int64_t n) {
  if (n < 8) {
    float res = -0.0f;
    for (int64_t i = 0; i < n; ++i) res += a[i];
    return res;
  }
  if (n <= kPairwiseBlock) {
    float r[8];
    for (int j = 0; j < 8; ++j) r[j] = a[j];
    int64_t i = 8;
    for (; i < n - (n % 8); i += 8) {
      for (int j = 0; j < 8; ++j) r[j] += a[i + j];
    }
    float res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
    for (; i < n; ++i) res += a[i];
    return res;
  }
  int64_t n2 = n / 2;
  n2 -= n2 % 8;
  return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
}

// np.mean(x, dtype=np.float32): the sum, then divided by the count in double
float numpy_mean(const std::vector<float>& x) {
  const int64_t n = static_cast<int64_t>(x.size());
  float sum = 0.0f;
  for (int64_t k = 0; k < n; k += kReduceChunk) {
    sum += pairwise_sum(x.data() + k, n - k < kReduceChunk ? n - k : kReduceChunk);
  }
  return static_cast<float>(static_cast<double>(sum) / static_cast<double>(n));
}

}  // namespace

// src, dst: `pixels` RGB float32 pixels, contiguous, not overlapping.
// order: the four ops (0 brightness, 1 contrast, 2 saturation, 3 hue) in the
// order they run.  factors: brightness, contrast, saturation, hue, as drawn.
extern "C" void tpuslam_color_jitter(const float* src, float* dst, int64_t pixels,
                                     const int32_t* order, const double* factors) {
  Jitter j{make_blend(factors[0]), make_blend(factors[1]), make_blend(factors[2]),
           static_cast<float>(factors[3]), 0.0f};
  int split = 0;
  while (order[split] != kContrast) ++split;
  std::vector<float> greys(pixels);
  pass(j, order, split, src, dst, pixels, greys.data());
  j.mean = numpy_mean(greys);
  pass(j, order + split, 4 - split, dst, dst, pixels, nullptr);
}
