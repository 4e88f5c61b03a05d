// Shared device helpers of the training kernels (salo_table_attention.cu,
// salo_table_backward.cu): type conversions, 16-byte loads, and the plan's
// per-step mask on ORIGINAL positions — the port of
// repro/core/scheduler.py::BandSchedule.step_mask / window_mask.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace salo {

constexpr float kNegInf = -1e30f;        // never -inf: keeps 0 * inf away
constexpr int kBig = 2146435072;   // BIG = 2**31 - 2**20 (plan_contract.py)
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// Elements of T in one 16-byte load.
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

// One 16-byte load of N elements of T, widened to f32.
template <typename T>
__device__ __forceinline__ void load16(const T* __restrict__ p, float (&f)[Vec<T>::N]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) f[i] = to_f32(e[i]);
}

// The pattern fields the mask reads (ctypes MaskSpec in
// kernels/salo_attention.py). The window is clamped into int32 by the
// wrapper.
struct MaskSpec {
  int a, b;          // 1-D window: a <= pos_j - pos_i <= b
  int dilation;      // (pos_j - pos_i) % dilation == 0
  int n_global;      // leading global tokens (global column)
  int causal;        // pos_j <= pos_i
  int n;             // original sequence length: positions >= n are padding
  int is2d;          // 2-D (ViL) grid window instead of the 1-D window
  int grid_w;        // grid width W (2-D)
  int wh2, ww2;      // half window (wh // 2, ww // 2) (2-D)
};

// Floor division for a positive divisor (JAX's //; C truncates toward 0).
__device__ __forceinline__ int floordiv(int x, int d) {
  const int q = x / d;
  return (x % d != 0 && x < 0) ? q - 1 : q;
}

// BandSchedule.step_mask(pos_i, pos_j, flags): window term gated by flag
// bit 1, global-column term (disjoint from the window) by bit 2; flags 0
// is a padding no-op. Positions lie in [0, BIG], so pos_j - pos_i cannot
// overflow int32, and BIG fails every term through the `< n` guards.
__device__ __forceinline__ bool step_mask(const MaskSpec& s, int pi, int pj, int fl) {
  bool w;
  if (s.is2d) {
    const int di = pi - s.n_global, dj = pj - s.n_global;
    const int yi = floordiv(di, s.grid_w), yj = floordiv(dj, s.grid_w);
    const int xi = di - yi * s.grid_w, xj = dj - yj * s.grid_w;
    w = abs(yj - yi) <= s.wh2 && abs(xj - xi) <= s.ww2 && pi >= s.n_global &&
        pj >= s.n_global;
  } else {
    const int rel = pj - pi;
    w = rel >= s.a && rel <= s.b;
    if (s.dilation > 1) w = w && (rel % s.dilation == 0);
  }
  if (s.causal) w = w && pj <= pi;
  w = w && pi < s.n && pj < s.n;
  bool m = w && (fl & 1);
  if (s.n_global > 0) {
    bool gc = pj < s.n_global && pi < s.n && !w;
    if (s.causal) gc = gc && pj <= pi;
    m = m || (gc && (fl & 2));
  }
  return m;
}

// Max / sum over the 16 lanes of a half-warp that share one query row.
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage `rows` (<= 64) rows of HD elements of T, starting at `src`, rows
// SRC_LD elements apart, into shared memory transposed: dst[d * ld + j] =
// src[j * SRC_LD + d] in f32 (HD < SRC_LD stages a column chunk). Rows in
// [valid, 64) are zero. Thread-fast index = row, so the stores hit
// consecutive banks.
template <typename T, int HD, int SRC_LD = HD>
__device__ __forceinline__ void stage_t(float* dst, int ld, const T* __restrict__ src,
                                        int rows, int valid) {
  constexpr int N = Vec<T>::N;
  constexpr int NC = HD / N;
  for (int idx = threadIdx.x; idx < rows * NC; idx += kThreads) {
    const int j = idx % rows, c = idx / rows;
    float f[N];
    if (j < valid) {
      load16(src + (int64_t)j * SRC_LD + c * N, f);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) dst[(c * N + e) * ld + j] = f[e];
  }
}

// The same rows staged row-major: dst[j * ld + d] = src[j * HD + d].
template <typename T, int HD>
__device__ __forceinline__ void stage_r(float* dst, int ld, const T* __restrict__ src,
                                        int rows, int valid) {
  constexpr int N = Vec<T>::N;
  constexpr int NC = HD / N;
  for (int idx = threadIdx.x; idx < rows * NC; idx += kThreads) {
    const int c = idx % NC, j = idx / NC;
    float f[N];
    if (j < valid) {
      load16(src + (int64_t)j * HD + c * N, f);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) dst[j * ld + c * N + e] = f[e];
  }
}

}  // namespace salo
