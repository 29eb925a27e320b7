// Rounding of float32 images in [0, 1] to uint8 levels on the host, in one
// pass with no temporaries:
//   dst[i] = clamp(rint(src[i] * 255), 0, 255)
// the same bytes as numpy's `np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)`
// on a float32 array x, which tpuslam_torch/train/batch.py::make_frame_batch
// evaluated before:
//   - the product is float32 (numpy 2 keeps a Python float weak);
//   - rint rounds half to even under the default rounding mode, as
//     std::nearbyint does;
//   - the clamp follows it, so -inf gives 0 and +inf gives 255.
// NaN is out of scope: numpy's cast of NaN to uint8 is platform-defined.
// The library is built with -ffp-contract=off and without -ffast-math, so
// nothing is fused or reassociated.  On x86-64 the loop is built twice, with
// AVX2 and for the baseline, and the loader picks by the CPU: the baseline
// has no vector round instruction and calls libm once a value, the AVX2
// clone rounds eight values an instruction.  Both give the same results.
// One thread; the caller (ctypes) runs it without Python's lock.

#include <cmath>
#include <cstdint>

#if defined(__x86_64__) && defined(__GNUC__)
#define TO_UINT8_CLONES __attribute__((target_clones("avx2", "default")))
#else
#define TO_UINT8_CLONES
#endif

extern "C" TO_UINT8_CLONES void tpuslam_to_uint8(const float* __restrict src,
                                                 uint8_t* __restrict dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    float v = std::nearbyint(src[i] * 255.0f);
    v = v < 0.0f ? 0.0f : v;
    v = v > 255.0f ? 255.0f : v;
    dst[i] = static_cast<uint8_t>(static_cast<int32_t>(v));
  }
}
