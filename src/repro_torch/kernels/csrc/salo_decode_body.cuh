// The ragged one-token decode body shared by the paged-slab kernel (K4,
// salo_paged_decode.cu) and the contiguous-cache kernel (K5,
// salo_decode.cu). Both replace the TPU kernel body of
// repro/kernels/salo_decode.py (_tile_update, with _make_paged_kernel for
// K4 and _ragged_kernel for K5); they differ only in how a logical slot
// maps to its K/V row and its position, a compile-time switch (PAGED).
//
// What it computes, per (request b, kv head h), over the rep = H / Hkv
// query rows of the group and every logical slot of the request:
//   rel = pos_k - t[b];  mask = (rel in [a, 0] && rel % dilation == 0)
//                               || pos_k < n_global;   mask &= pos_k <= t[b]
//   online softmax in f32 with the guarded NEG_INF/2 shift and corr, the
//   unnormalized p rounded to V's compute type before the PV product (as
//   the TPU kernel does), f32 accumulation, out = acc / (l == 0 ? 1 : l).
//   A row with no live slot gives out 0, m NEG_INF, l 0 (the reference's
//   XLA twin gives the mean of V there; only inactive engine rows are
//   empty, and their logits are discarded).
//
// Variants (runtime operands, null when off):
//   * int8 slab (K4): K and V are int8 (KV = int8_t), read in 16-byte loads
//     (16 values), dequantized as float(x) * scale[physical page] and
//     rounded to the compute type T before the products, exactly as the
//     TPU kernel and the plain gather_view do.
//   * state: out in f32, unrounded, plus the row stats m and l (f32).
//   * page stats (K4): pm[b, h, z, p] = max masked score of this block's
//     rows against logical page p (NEG_INF if every slot of the page is
//     masked or its tile is skipped); the wrapper reduces the (h, z)
//     partials with amax, so the result is deterministic (no atomics).
//
// Bound on this card: bytes. Per launch it must read the live slots' K and
// V rows (2 * live_slots * hd * sizeof(KV) per (b, h)) plus q, positions
// and tables; the arithmetic is ~4*rep*hd flops per live slot, far below
// the bf16 tensor-core ridge. So the design is about keeping many loads in
// flight, since few blocks run:
//
// Design: one block of 256 threads per (b, h) and group of up to kRows = 4
// query rows (grid Hkv x B x ceil(rep / 4)), a loop over tiles of 256
// logical slots. Per tile, three phases:
//   A. one thread per slot: position, mask and row address (K4: the page
//      table is read from global memory here; K5: strides); a live slot's
//      thread reads its whole K row in 16-byte loads (all issued before the
//      FMAs) and computes the kRows scores. Dead slots read nothing, and a
//      tile without a live slot is skipped after one barrier.
//   B. one warp per row: tile max, guarded shift, p (rounded to V's type),
//      corr and the (m, l) update. Page stats, when asked for, are taken
//      in the same phase, one page per warp at a time (a page may be
//      smaller or larger than a warp, and may straddle two tiles).
//   C. threads own (16-byte chunk of d, slot group): each reads V chunks of
//      its live slots in batches of 16-byte loads and keeps the kRows
//      partial sums in registers across tiles (rescaled by corr).
// After the last tile the slot groups' partials are summed in shared
// memory, one row at a time, in ascending group order. No LANES-wide stat
// scratch, no scalar prefetch: what the TPU layout needed is gone.
//
// Known weakness: the grid is only B x Hkv blocks (24 at B=8, Hkv=3 on
// 132 SMs) and each block walks its tiles in sequence with three barriers
// each. A later version splits the tiles of a request over several blocks
// and merges the partial (acc, m, l) with the renorm merge.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace decode_body {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads;          // slots per tile: one per thread in A
constexpr int kRows = 4;                 // query rows per block

// Every operand of one launch. Pointers that a variant does not use are
// null; strides are in elements.
struct Params {
  const void* q;                 // (B, H, 1, hd) contiguous, type T
  const void* k;                 // K4: slab (n_pages, page, Hkv, hd); K5: cache
  const void* v;
  const float* k_scale;          // K4 int8: (n_pages,) f32
  const float* v_scale;
  const int32_t* page_tables;    // K4: (B, npp)
  const int32_t* positions;      // K4: (B, S); K5: rows of S, or null (= slot)
  int64_t pos_sb;                // K5: batch stride of positions (0 = shared)
  const int32_t* t_vec;          // (B,), or null: t_scalar for every row
  int t_scalar;
  int64_t k_sb, k_sh, k_ss;      // K5: strides (batch, kv head, slot) of K
  int64_t v_sb, v_sh, v_ss;      //     and of V
  void* out;                     // (B, H, 1, hd): T, or f32 when out_f32
  int out_f32;
  float* m_out;                  // (B, H) or null
  float* l_out;
  float* pm_out;                 // K4: (B, Hkv, ceil(rep / kRows), npp) or null
  int B, H, Hkv, hd, S;          // S: logical slots per request
  int page, npp;                 // K4 only
  int win_lo, dilation, n_global;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to T and widened back (the compute type's value of x).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Elements of KV in one 16-byte load.
template <typename KV> struct Vec { static constexpr int N = 16 / sizeof(KV); };

// One 16-byte load of N elements of KV, widened to f32.
template <typename KV>
__device__ __forceinline__ void load16(const KV* __restrict__ p, float (&f)[Vec<KV>::N]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<KV>::N; ++i) f[i] = to_f32(e[i]);
}

// int8 slab: dequantize by the page's scale and round to the compute type.
template <typename T, typename KV>
__device__ __forceinline__ void dequant(float (&f)[Vec<KV>::N], float s) {
  if constexpr (sizeof(KV) == 1) {
#pragma unroll
    for (int i = 0; i < Vec<KV>::N; ++i) f[i] = round_to<T>(f[i] * s);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// T: compute type of q (and of K/V after dequant); KV: storage type of the
// cache (T, or int8_t for the quantized slab); PAGED: K4's slab addressing.
template <typename T, typename KV, int HD, bool PAGED>
__global__ void __launch_bounds__(kThreads) decode_kernel(const Params p) {
  constexpr int N = Vec<KV>::N;                // elements per 16-byte load
  constexpr int NC = HD / N;                   // 16-byte chunks per row
  constexpr int G = kThreads / NC;             // slot groups in phase C
  constexpr int SPT = kTile / G;               // slots per thread in phase C
  constexpr int LIM = 64 / N < 8 ? 64 / N : 8; // loads in flight per batch
  constexpr int KB = SPT < LIM ? SPT : LIM;
  constexpr int KA = NC < LIM ? NC : LIM;
  constexpr bool kQuant = sizeof(KV) == 1;

  __shared__ __align__(16) float q_sh[kRows * HD];
  __shared__ float s_sh[kRows * kTile];    // scores, then p in V's type
  __shared__ int64_t row_sh[kTile];        // element offset of the slot's V row
  __shared__ float vs_sh[kTile];           // int8: V scale of the slot's page
  __shared__ float smax_sh[kTile];         // page stats: slot max over rows
  __shared__ int live_sh[kTile];
  __shared__ float m_sh[kRows], l_sh[kRows], c_sh[kRows];
  __shared__ float red_sh[G * HD];         // slot groups' partials, one row

  const KV* __restrict__ k_base = static_cast<const KV*>(p.k);
  const KV* __restrict__ v_base = static_cast<const KV*>(p.v);
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int H = p.H, Hkv = p.Hkv, S = p.S;
  const int rep = H / Hkv;
  const int r0 = blockIdx.z * kRows;       // first row of this block's group
  const int nr = min(kRows, rep - r0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = p.t_vec != nullptr ? p.t_vec[b] : p.t_scalar;
  const bool want_pm = p.pm_out != nullptr;
  float* pm = nullptr;
  if (want_pm) {
    pm = p.pm_out + (((int64_t)b * Hkv + h) * gridDim.z + blockIdx.z) * p.npp;
    for (int i = tid; i < p.npp; i += kThreads) pm[i] = kNegInf;
  }

  const T* q_b = static_cast<const T*>(p.q) + ((int64_t)b * H + (int64_t)h * rep + r0) * HD;
  for (int e = tid; e < kRows * HD; e += kThreads)
    q_sh[e] = e < nr * HD ? to_f32(q_b[e]) : 0.f;
  if (tid < kRows) {
    m_sh[tid] = kNegInf;
    l_sh[tid] = 0.f;
  }

  const int c = tid % NC;                  // phase C: 16-byte chunk of d
  const int g = tid / NC;                  //          slot group
  float part[kRows][N];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int e = 0; e < N; ++e) part[r][e] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < S; t0 += kTile) {
    // Phase A: mask, row address and scores, one thread per slot.
    const int s = t0 + tid;
    bool live = false;
    int64_t k_row = 0, v_row = 0;
    float ks = 1.f, vs = 1.f;
    if (s < S) {
      int pos;
      if constexpr (PAGED) {
        pos = p.positions[(int64_t)b * S + s];
        const int64_t pg = p.page_tables[(int64_t)b * p.npp + s / p.page];
        k_row = v_row = (pg * p.page + s % p.page) * ((int64_t)Hkv * HD) + (int64_t)h * HD;
        if constexpr (kQuant) {
          ks = p.k_scale[pg];
          vs = p.v_scale[pg];
        }
      } else {
        pos = p.positions != nullptr ? p.positions[(int64_t)b * p.pos_sb + s] : s;
        k_row = (int64_t)b * p.k_sb + (int64_t)h * p.k_sh + (int64_t)s * p.k_ss;
        v_row = (int64_t)b * p.v_sb + (int64_t)h * p.v_sh + (int64_t)s * p.v_ss;
      }
      const int rel = pos - t;
      live = (rel >= p.win_lo) && (rel <= 0);
      if (p.dilation > 1) live = live && (rel % p.dilation == 0);
      if (p.n_global > 0) live = live || (pos < p.n_global);
      live = live && (pos <= t);
    }
    float sc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = 0.f;
    if (live) {
      const KV* kr = k_base + k_row;
#pragma unroll 1
      for (int cb = 0; cb < NC; cb += KA) {
        float kf[KA][N];
#pragma unroll
        for (int u = 0; u < KA; ++u) load16(kr + (cb + u) * N, kf[u]);
#pragma unroll
        for (int u = 0; u < KA; ++u) {
          dequant<T, KV>(kf[u], ks);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float* q_r = q_sh + r * HD + (cb + u) * N;
#pragma unroll
            for (int e = 0; e < N; ++e) sc[r] += q_r[e] * kf[u][e];
          }
        }
      }
    }
    float smax = kNegInf;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float x = live ? sc[r] * p.scale : kNegInf;
      s_sh[r * kTile + tid] = x;
      if (r < nr) smax = fmaxf(smax, x);
    }
    smax_sh[tid] = smax;
    live_sh[tid] = live ? 1 : 0;
    row_sh[tid] = v_row;
    vs_sh[tid] = vs;
    if (!__syncthreads_or(live)) continue;  // nothing to fold in this tile

    // Phase B: fold the tile into the row stats, one warp per row.
    for (int r = warp; r < kRows; r += kWarps) {
      float* s_r = s_sh + r * kTile;
      float mx = kNegInf;
      for (int j = lane; j < kTile; j += 32) mx = fmaxf(mx, s_r[j]);
      mx = warp_max(mx);
      const float m_prev = m_sh[r];
      const float m_new = fmaxf(m_prev, mx);
      const float shift = (m_new <= kNegInf / 2) ? 0.f : m_new;
      float sum = 0.f;
      for (int j = lane; j < kTile; j += 32) {
        const float pj = live_sh[j] ? expf(s_r[j] - shift) : 0.f;
        sum += pj;
        s_r[j] = round_to<T>(pj);          // p in V's type for the PV product
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = (m_prev <= kNegInf / 2) ? 0.f : expf(m_prev - shift);
        c_sh[r] = corr;
        l_sh[r] = l_sh[r] * corr + sum;
        m_sh[r] = m_new;
      }
    }
    // Page stats: the max of the slot maxima over each page in this tile
    // (the block owns its partial row, so no other block touches pm).
    if (want_pm) {
      const int hi = min(t0 + kTile, S);
      for (int pg = t0 / p.page + warp; pg * p.page < hi; pg += kWarps) {
        const int lo = max(pg * p.page, t0);
        const int end = min((pg + 1) * p.page, hi);
        float mx = kNegInf;
        for (int j = lo + lane; j < end; j += 32) mx = fmaxf(mx, smax_sh[j - t0]);
        mx = warp_max(mx);
        if (lane == 0) pm[pg] = fmaxf(pm[pg], mx);
      }
    }
    __syncthreads();

    // Phase C: part = part * corr + p @ V over this thread's slots.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float corr = c_sh[r];
#pragma unroll
      for (int e = 0; e < N; ++e) part[r][e] *= corr;
    }
#pragma unroll 1
    for (int jb = 0; jb < SPT; jb += KB) {
      float vf[KB][N];
#pragma unroll
      for (int u = 0; u < KB; ++u) {
        const int j = g + (jb + u) * G;
        if (live_sh[j]) {
          load16(v_base + row_sh[j] + c * N, vf[u]);
          dequant<T, KV>(vf[u], vs_sh[j]);
        } else {
#pragma unroll
          for (int e = 0; e < N; ++e) vf[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < KB; ++u) {
        const int j = g + (jb + u) * G;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float pj = s_sh[r * kTile + j];
#pragma unroll
          for (int e = 0; e < N; ++e) part[r][e] += pj * vf[u][e];
        }
      }
    }
    __syncthreads();   // the next tile overwrites the per-slot arrays
  }

  // Sum the slot groups' partials (one row at a time, groups in ascending
  // order), normalize, write the rows of this block.
  const int64_t row0 = (int64_t)b * H + (int64_t)h * rep + r0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < nr) {                          // uniform over the block
#pragma unroll
      for (int e = 0; e < N; ++e) red_sh[g * HD + c * N + e] = part[r][e];
      __syncthreads();
      const float l = l_sh[r];
      const float div = l == 0.f ? 1.f : l;
      for (int d = tid; d < HD; d += kThreads) {
        float acc = 0.f;
        for (int gg = 0; gg < G; ++gg) acc += red_sh[gg * HD + d];
        const int64_t o = (row0 + r) * HD + d;
        if (p.out_f32) static_cast<float*>(p.out)[o] = acc / div;
        else static_cast<T*>(p.out)[o] = from_f32<T>(acc / div);
      }
      __syncthreads();   // red_sh is reused by the next row
    }
  }
  if (p.m_out != nullptr && tid < nr) {
    p.m_out[row0 + tid] = m_sh[tid];
    p.l_out[row0 + tid] = l_sh[tid];
  }
}

template <typename T, typename KV, bool PAGED>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int rep = p.H / p.Hkv;
  dim3 grid(p.Hkv, p.B, (rep + kRows - 1) / kRows);
  switch (p.hd) {
    case 64:
      decode_kernel<T, KV, 64, PAGED><<<grid, kThreads, 0, stream>>>(p);
      break;
    case 128:
      decode_kernel<T, KV, 128, PAGED><<<grid, kThreads, 0, stream>>>(p);
      break;
    case 256:
      decode_kernel<T, KV, 256, PAGED><<<grid, kThreads, 0, stream>>>(p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (the compute type of q and
// of the cache, or of its dequantized values when kv_int8; only the paged
// slab comes in int8).
template <typename T, bool PAGED>
cudaError_t launch_kv(int kv_int8, const Params& p, cudaStream_t s) {
  if constexpr (PAGED) {
    if (kv_int8) return launch<T, int8_t, true>(p, s);
  } else {
    if (kv_int8) return cudaErrorInvalidValue;
  }
  return launch<T, T, PAGED>(p, s);
}

template <bool PAGED>
cudaError_t dispatch(int dtype, int kv_int8, const Params& p, cudaStream_t s) {
  if (p.B <= 0 || p.Hkv <= 0 || p.H % p.Hkv != 0 || p.S <= 0)
    return cudaErrorInvalidValue;
  if (PAGED && (p.page <= 0 || p.npp <= 0 || p.S != p.page * p.npp))
    return cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch_kv<float, PAGED>(kv_int8, p, s);
    case 1:
      return launch_kv<__nv_bfloat16, PAGED>(kv_int8, p, s);
    case 2:
      return launch_kv<__half, PAGED>(kv_int8, p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace decode_body
