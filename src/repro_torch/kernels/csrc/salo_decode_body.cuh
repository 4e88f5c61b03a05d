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
//   the TPU kernel does), l summed over the f32 p, f32 accumulation,
//   out = acc / (l == 0 ? 1 : l). A row with no live slot gives out 0,
//   m NEG_INF, l 0 (the reference's XLA twin gives the mean of V there;
//   only inactive engine rows are empty, and their logits are discarded).
//
// Variants (runtime operands, null when off):
//   * int8 slab (K4): K and V are int8 (KV = int8_t), dequantized as
//     float(x) * scale[physical page] and rounded to the compute type T
//     before the products, exactly as the TPU kernel and the plain
//     gather_view do.
//   * state: out in f32, unrounded, plus the row stats m and l (f32).
//   * page stats (K4): pm[b, h, z, p] = max masked score of the rows of
//     row group z against logical page p (NEG_INF if every slot of the page
//     is masked or skipped); the wrapper reduces the (h, z) partials with
//     amax, so the result is deterministic.
//
// Bound on this card: bytes. A call must read the live slots' K and V rows
// (2 * live_slots * hd * sizeof(KV) per (b, h)) plus q, positions and
// tables, about 1-3 us at the decode shapes; the arithmetic is ~4*rep*hd
// flops per live slot, far below any ridge. What a call pays instead is
// latency: a few dependent memory round trips and the launch. The design
// keeps that chain short and spreads it over the whole card.
//
// Design: split-KV in one launch. The grid is (B * Hkv * n_rg) x n_split
// blocks of 256 threads (n_rg = ceil(rep / kRows) row groups of up to
// kRows = 4 query rows); block (unit, split) owns the slots
// [split * split_len, (split + 1) * split_len) of its unit (b, h, z). The
// wrapper's planner picks n_split and split_len from shapes alone (about
// two blocks per SM; split_len a multiple of 16 slots and, for K4, of the
// page, so every split owns whole pages). A block walks its split in tiles
// of TS slots (TS x row bytes ~16 KB of K and as much of V):
//   1. q goes to shared memory by cp.async; TPS = 256 / TS threads per
//      slot read the slot's position and (K4) page-table entry together
//      (the page depends on the slot, not on the position), mask it, and
//      issue cp.async copies of the live slots' K and V rows (16 bytes a
//      copy, dead slots' V zero-filled, no copy for dead K) before any
//      arithmetic, so V's latency hides under the scores. Rows are padded
//      in shared memory so that the reads below hit distinct banks.
//   2. each slot's TPS threads compute its kRows scores from the K rows
//      they copied themselves, summed by shuffles. A tile with no live
//      slot is skipped after this barrier (a dead split loads no K or V).
//   3. one warp per row: the split-local max, the guarded shift, p (l sums
//      the f32 p; the PV product takes p rounded to T) and corr; the other
//      four warps take the page maxima at the same time.
//   4. threads own (16-byte chunk of d, slot group) and accumulate
//      p @ V from shared memory in registers (rescaled by corr per tile);
//      the groups' sums meet in shared memory in ascending order.
// With n_split = 1 the block writes out (and m, l) directly. Otherwise it
// writes its partial (acc f32, m, l) to a workspace and, after a barrier,
// one thread fences and takes a ticket from the unit's int32 counter; the
// block that draws the last ticket merges the n_split partials in
// ascending split order with the guarded renorm merge (c_s = m_s dead ? 0
// : exp(m_s - M), acc = sum c_s acc_s, l = sum c_s l_s; partials read past
// L1), normalizes, writes the rows and resets the counter to 0 for the
// next launch. The result does not depend on which block finishes last.
// No LANES-wide stat scratch, no scalar prefetch: what the TPU layout
// needed is gone.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace decode_body {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                 // query rows per row group
constexpr int kMaxSplits = 64;           // the planner never asks for more
constexpr int kTileBytes = 16384;        // unpadded bytes of one K (or V) tile

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
  int n_split, split_len;        // the planner's split of the S slots
  float* ws;                     // n_split > 1: acc (units, n_split, kRows, hd)
                                 // then (m, l) (units, n_split, kRows, 2)
  int* counters;                 // n_split > 1: (units,) int32, 0 between launches
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

// N elements of E from 16-byte aligned shared memory, widened to f32.
template <typename E, int N>
__device__ __forceinline__ void lds(const void* p, float (&f)[N]) {
  constexpr int V = N * (int)sizeof(E) / 16;       // 16-byte loads
  static_assert(V * 16 == N * (int)sizeof(E), "whole 16-byte loads");
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const uint4 raw = reinterpret_cast<const uint4*>(p)[i];
    const E* e = reinterpret_cast<const E*>(&raw);
#pragma unroll
    for (int k = 0; k < 16 / (int)sizeof(E); ++k) f[i * (16 / sizeof(E)) + k] = to_f32(e[k]);
  }
}

// int8 slab: dequantize by the page's scale and round to the compute type.
template <typename T, typename KV, int N>
__device__ __forceinline__ void dequant(float (&f)[N], float s) {
  if constexpr (sizeof(KV) == 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = round_to<T>(f[i] * s);
  }
}

// 16 bytes global -> shared, asynchronously (bypassing L1); with
// src_bytes = 0 nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp16(void* s, const void* g, int src_bytes = 16) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(g),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Shared-memory row stride, in 16-byte units, for a tile read by quarter
// warps that take n consecutive chunks of 8 / n consecutive rows: the
// smallest stride >= x that is an odd multiple of n puts those reads on
// distinct banks (any stride does once n >= 8).
__host__ __device__ constexpr int row_stride(int x, int n) {
  if (n >= 8) return x;
  int y = x;
  while (y % n != 0 || (y / n) % 2 == 0) ++y;
  return y;
}

// The tile geometry of one instantiation.
template <typename KV, int HD>
struct Tile {
  static constexpr int N = 16 / (int)sizeof(KV);   // KV elements per 16 bytes
  static constexpr int NC = HD / N;                 // 16-byte chunks per row
  static constexpr int TS = (kTileBytes / (HD * (int)sizeof(KV))) < 128
                                ? kTileBytes / (HD * (int)sizeof(KV)) : 128;  // slots
  static constexpr int TPS = kThreads / TS;         // threads per slot
  static constexpr int CPT = NC / TPS;              // chunks per thread per row
  static constexpr int G = kThreads / NC;           // slot groups of step 4
  static constexpr int GR = G < kWarps ? G : kWarps;  // group sums after shuffles
  static constexpr int RK = row_stride(NC, TPS);    // K row stride (16-byte units)
  static constexpr int RV = row_stride(NC, NC);     // V row stride
  static constexpr int KV_BYTES = TS * (RK + RV) * 16;
  static_assert(TS % 16 == 0 && TS * TPS == kThreads, "slot tile");
  static_assert(NC % TPS == 0 && TS % G == 0, "chunk split");
  static_assert(GR * kRows * HD * 4 <= KV_BYTES, "group sums fit the K/V tiles");
};

// T: compute type of q (and of K/V after dequant); KV: storage type of the
// cache (T, or int8_t for the quantized slab); PAGED: K4's slab addressing.
template <typename T, typename KV, int HD, bool PAGED>
__global__ void __launch_bounds__(kThreads, 2) decode_kernel(const Params p) {
  using TL = Tile<KV, HD>;
  constexpr int N = TL::N, NC = TL::NC, TS = TL::TS, TPS = TL::TPS;
  constexpr int CPT = TL::CPT, G = TL::G, GR = TL::GR;
  constexpr bool kQuant = sizeof(KV) == 1;
  constexpr int QC = HD * (int)sizeof(T) / 16;      // 16-byte chunks of a q row

  __shared__ __align__(16) unsigned char kv_sh[TL::KV_BYTES];  // K tile, V tile
  __shared__ __align__(16) T q_sh[kRows * HD];
  __shared__ float s_sh[kRows * TS];       // scores, then p in V's type
  __shared__ float smax_sh[TS];            // page stats: slot max over rows
  __shared__ float vs_sh[TS];              // int8: V scale of the slot's page
  __shared__ float m_sh[kRows], l_sh[kRows], c_sh[kRows];
  __shared__ float f_sh[kRows * kMaxSplits], fl_sh[kRows * kMaxSplits];
  __shared__ int last_sh;

  unsigned char* k_tile = kv_sh;
  unsigned char* v_tile = kv_sh + TS * TL::RK * 16;
  const KV* __restrict__ k_base = static_cast<const KV*>(p.k);
  const KV* __restrict__ v_base = static_cast<const KV*>(p.v);
  const int H = p.H, Hkv = p.Hkv, S = p.S;
  const int rep = H / Hkv;
  const int n_rg = (rep + kRows - 1) / kRows;
  const int n_split = p.n_split;
  const int unit = blockIdx.x / n_split;   // ((b * Hkv) + h) * n_rg + z
  const int split = blockIdx.x - unit * n_split;
  const int z = unit % n_rg;
  const int h = (unit / n_rg) % Hkv;
  const int b = unit / (n_rg * Hkv);
  const int r0 = z * kRows;                // first row of this block's group
  const int nr = min(kRows, rep - r0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int s0 = split * p.split_len;
  const int s1 = min(s0 + p.split_len, S);
  const int t = p.t_vec != nullptr ? p.t_vec[b] : p.t_scalar;
  const int64_t row0 = (int64_t)b * H + (int64_t)h * rep + r0;

  // q rows of the group (zeros past the last row), asynchronously.
  {
    const T* q_b = static_cast<const T*>(p.q) + row0 * HD;
    for (int i = tid; i < kRows * QC; i += kThreads) {
      const bool in = i < nr * QC;
      cp16(q_sh + i * (16 / sizeof(T)), in ? q_b + i * (16 / sizeof(T)) : q_b, in ? 16 : 0);
    }
  }
  const bool want_pm = p.pm_out != nullptr;
  float* pm = want_pm ? p.pm_out + (int64_t)unit * p.npp : nullptr;
  if (want_pm)  // this split's pages, and no other block's
    for (int pg = s0 / p.page + tid; pg < s1 / p.page; pg += kThreads) pm[pg] = kNegInf;
  if (tid < kRows) {
    m_sh[tid] = kNegInf;
    l_sh[tid] = 0.f;
  }

  const int j = tid / TPS;                 // steps 1-2: this thread's slot
  const int u = tid % TPS;                 //            and its chunk lane
  const int c = tid % NC;                  // step 4: 16-byte chunk of d
  const int g = tid / NC;                  //         slot group
  float part[kRows][N];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int e = 0; e < N; ++e) part[r][e] = 0.f;
  bool any_live = false;                   // uniform over the block

  for (int c0 = s0; c0 < s1; c0 += TS) {
    // 1. position, page, mask; K and V rows of live slots to shared memory.
    const int s = c0 + j;
    bool live = false;
    const KV* k_row = k_base;
    const KV* v_row = v_base;
    float ks = 1.f, vs = 1.f;
    if (s < s1) {
      int pos;
      int64_t k_off, v_off;
      int64_t pg = 0;
      if constexpr (PAGED) {
        pos = p.positions[(int64_t)b * S + s];
        pg = p.page_tables[(int64_t)b * p.npp + s / p.page];
        k_off = v_off = (pg * p.page + s % p.page) * ((int64_t)Hkv * HD) + (int64_t)h * HD;
      } else {
        pos = p.positions != nullptr ? p.positions[(int64_t)b * p.pos_sb + s] : s;
        k_off = (int64_t)b * p.k_sb + (int64_t)h * p.k_sh + (int64_t)s * p.k_ss;
        v_off = (int64_t)b * p.v_sb + (int64_t)h * p.v_sh + (int64_t)s * p.v_ss;
      }
      const int rel = pos - t;
      live = (rel >= p.win_lo) && (rel <= 0);
      if (p.dilation > 1) live = live && (rel % p.dilation == 0);
      if (p.n_global > 0) live = live || (pos < p.n_global);
      live = live && (pos <= t);
      if (live) {
        k_row = k_base + k_off;
        v_row = v_base + v_off;
        if constexpr (PAGED && kQuant) {
          ks = p.k_scale[pg];
          vs = p.v_scale[pg];
        }
      }
    }
    unsigned char* k_dst = k_tile + j * TL::RK * 16;
    unsigned char* v_dst = v_tile + j * TL::RV * 16;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int ch = u + i * TPS;
      if (live) cp16(k_dst + ch * 16, k_row + ch * N);
      cp16(v_dst + ch * 16, v_row + (live ? ch * N : 0), live ? 16 : 0);
    }
    cp_commit();
    if (u == 0) vs_sh[j] = vs;
    cp_wait_all();
    __syncthreads();                       // q (first tile) from every thread

    // 2. scores of this thread's slot over its chunks, summed by shuffles.
    float sc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = 0.f;
    if (live) {
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int ch = u + i * TPS;
        float kf[N];
        lds<KV, N>(k_dst + ch * 16, kf);
        dequant<T, KV, N>(kf, ks);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float qf[N];
          lds<T, N>(q_sh + r * HD + ch * N, qf);
#pragma unroll
          for (int e = 0; e < N; ++e) sc[r] += qf[e] * kf[e];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int o = TPS / 2; o > 0; o >>= 1) sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], o);
    if (u == 0) {
      float smax = kNegInf;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float x = live ? sc[r] * p.scale : kNegInf;
        s_sh[r * TS + j] = x;
        if (r < nr) smax = fmaxf(smax, x);
      }
      smax_sh[j] = smax;
    }
    if (!__syncthreads_or(live)) continue;  // nothing to fold in this tile
    any_live = true;

    // 3. fold the tile into the row stats, one warp per row; the other
    //    warps take the page maxima (this block owns its pages of pm).
    if (warp < kRows) {
      const int r = warp;
      float* s_r = s_sh + r * TS;
      float mx = kNegInf;
      for (int jj = lane; jj < TS; jj += 32) mx = fmaxf(mx, s_r[jj]);
      mx = warp_max(mx);
      const float m_prev = m_sh[r];
      const float m_new = fmaxf(m_prev, mx);
      const float shift = (m_new <= kNegInf / 2) ? 0.f : m_new;
      float sum = 0.f;
      for (int jj = lane; jj < TS; jj += 32) {
        const float x = s_r[jj];
        const float pj = x <= kNegInf / 2 ? 0.f : expf(x - shift);
        sum += pj;
        s_r[jj] = round_to<T>(pj);         // p in V's type for the PV product
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = (m_prev <= kNegInf / 2) ? 0.f : expf(m_prev - shift);
        c_sh[r] = corr;
        l_sh[r] = l_sh[r] * corr + sum;
        m_sh[r] = m_new;
      }
    } else if (want_pm) {
      const int hi = min(c0 + TS, s1);
      for (int pg = c0 / p.page + warp - kRows; pg * p.page < hi; pg += kWarps - kRows) {
        const int lo = max(pg * p.page, c0);
        const int end = min((pg + 1) * p.page, hi);
        float mx = kNegInf;
        for (int jj = lo + lane; jj < end; jj += 32) mx = fmaxf(mx, smax_sh[jj - c0]);
        mx = warp_max(mx);
        if (lane == 0) pm[pg] = fmaxf(pm[pg], mx);
      }
    }
    __syncthreads();

    // 4. part = part * corr + p @ V over this thread's slots.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float corr = c_sh[r];
#pragma unroll
      for (int e = 0; e < N; ++e) part[r][e] *= corr;
    }
#pragma unroll
    for (int i = 0; i < TS / G; ++i) {
      const int jj = g + i * G;
      float vf[N];
      lds<KV, N>(v_tile + (jj * TL::RV + c) * 16, vf);
      dequant<T, KV, N>(vf, vs_sh[jj]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = s_sh[r * TS + jj];
#pragma unroll
        for (int e = 0; e < N; ++e) part[r][e] += pj * vf[e];
      }
    }
    __syncthreads();   // the next tile overwrites the shared tiles
  }

  // Sum the slot groups' partials: shuffles within a warp, then the GR
  // warp (or group) sums through shared memory in ascending order.
  float* red = reinterpret_cast<float*>(kv_sh);    // (GR, kRows, HD)
  if (any_live) {
    if constexpr (NC < 32) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int e = 0; e < N; ++e)
#pragma unroll
          for (int o = NC; o < 32; o <<= 1)
            part[r][e] += __shfl_xor_sync(0xffffffffu, part[r][e], o);
    }
    const int ri = NC < 32 ? warp : g;
    if (NC >= 32 || lane < NC) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int e = 0; e < N; ++e) red[(ri * kRows + r) * HD + c * N + e] = part[r][e];
    }
    __syncthreads();
  }

  if (n_split == 1) {                      // the block holds the whole row
    for (int i = tid; i < nr * HD; i += kThreads) {
      const int r = i / HD, d = i - r * HD;
      float acc = 0.f;
      if (any_live) {
#pragma unroll
        for (int gi = 0; gi < GR; ++gi) acc += red[(gi * kRows + r) * HD + d];
      }
      const float l = l_sh[r];
      const float o = acc / (l == 0.f ? 1.f : l);
      if (p.out_f32) static_cast<float*>(p.out)[row0 * HD + i] = o;
      else static_cast<T*>(p.out)[row0 * HD + i] = from_f32<T>(o);
    }
    if (p.m_out != nullptr && tid < nr) {
      p.m_out[row0 + tid] = m_sh[tid];
      p.l_out[row0 + tid] = l_sh[tid];
    }
    return;
  }

  // This split's partial to the workspace (a dead split writes only its
  // (NEG_INF, 0) stats: the merge never reads its acc), then the ticket.
  const int64_t units = (int64_t)gridDim.x / n_split;
  float* acc_u = p.ws + (int64_t)unit * n_split * kRows * HD;   // split 0 of the unit
  float* ml_u = p.ws + units * n_split * kRows * HD + (int64_t)unit * n_split * kRows * 2;
  if (any_live)
    for (int i = tid; i < nr * HD; i += kThreads) {
      const int r = i / HD, d = i - r * HD;
      float acc = 0.f;
#pragma unroll
      for (int gi = 0; gi < GR; ++gi) acc += red[(gi * kRows + r) * HD + d];
      acc_u[((int64_t)split * kRows + r) * HD + d] = acc;
    }
  if (tid < nr) {
    ml_u[(split * kRows + tid) * 2] = m_sh[tid];
    ml_u[(split * kRows + tid) * 2 + 1] = l_sh[tid];
  }
  __syncthreads();
  if (tid == 0) {           // as a grid barrier does: the block's writes,
    __threadfence();        // ordered by the barrier, before the ticket,
    last_sh = atomicAdd(p.counters + unit, 1) == n_split - 1;
    __threadfence();        // and the other blocks' partials after it
  }
  __syncthreads();
  if (!last_sh) return;

  // The last block merges every split of the unit, in ascending order.
  if (warp < nr) {
    const int r = warp;
    float mx = kNegInf;
    for (int sp = lane; sp < n_split; sp += 32) {
      const float m = __ldcg(ml_u + (sp * kRows + r) * 2);
      f_sh[r * kMaxSplits + sp] = m;
      fl_sh[r * kMaxSplits + sp] = __ldcg(ml_u + (sp * kRows + r) * 2 + 1);
      mx = fmaxf(mx, m);
    }
    mx = warp_max(mx);
    for (int sp = lane; sp < n_split; sp += 32) {
      const float m = f_sh[r * kMaxSplits + sp];
      f_sh[r * kMaxSplits + sp] = m <= kNegInf / 2 ? 0.f : expf(m - mx);
    }
    __syncwarp();
    if (lane == 0) {
      float l = 0.f;
      for (int sp = 0; sp < n_split; ++sp) l += f_sh[r * kMaxSplits + sp] * fl_sh[r * kMaxSplits + sp];
      m_sh[r] = mx;
      l_sh[r] = l;
    }
  }
  __syncthreads();
  for (int i = tid; i < nr * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    float acc = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {    // a dead split's acc is never read
      const float f = f_sh[r * kMaxSplits + sp];
      if (f != 0.f) acc += f * __ldcg(acc_u + ((int64_t)sp * kRows + r) * HD + d);
    }
    const float l = l_sh[r];
    const float o = acc / (l == 0.f ? 1.f : l);
    if (p.out_f32) static_cast<float*>(p.out)[row0 * HD + i] = o;
    else static_cast<T*>(p.out)[row0 * HD + i] = from_f32<T>(o);
  }
  if (p.m_out != nullptr && tid < nr) {
    p.m_out[row0 + tid] = m_sh[tid];
    p.l_out[row0 + tid] = l_sh[tid];
  }
  if (tid == 0) p.counters[unit] = 0;      // ready for the next launch
}

template <typename T, typename KV, bool PAGED>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int rep = p.H / p.Hkv;
  const long long units = (long long)p.B * p.Hkv * ((rep + kRows - 1) / kRows);
  const long long blocks = units * p.n_split;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
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
  // the split: whole 16-slot multiples (K4: whole pages) covering S, every
  // split non-empty, and a workspace and counters when there are several
  const long long len = p.split_len;
  if (p.n_split < 1 || p.n_split > kMaxSplits || len <= 0 || len % 16 != 0 ||
      (PAGED && len % p.page != 0) || (p.n_split - 1) * len >= p.S ||
      p.n_split * len < p.S || (p.n_split > 1 && (p.ws == nullptr || p.counters == nullptr)))
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

// The static shared memory of one instantiation, in bytes, as the
// compiler laid it out (cudaFuncGetAttributes); -1 for a head dim or type
// the launcher does not take, or an error. analysis/smem_budget.py mirrors
// it (decode_bytes).
template <typename T, typename KV, bool PAGED>
int static_smem(int hd) {
  cudaFuncAttributes a;
  cudaError_t e;
  switch (hd) {
    case 64: e = cudaFuncGetAttributes(&a, decode_kernel<T, KV, 64, PAGED>); break;
    case 128: e = cudaFuncGetAttributes(&a, decode_kernel<T, KV, 128, PAGED>); break;
    case 256: e = cudaFuncGetAttributes(&a, decode_kernel<T, KV, 256, PAGED>); break;
    default: return -1;
  }
  return e == cudaSuccess ? (int)a.sharedSizeBytes : -1;
}

template <bool PAGED>
int smem_of(int dtype, int kv_int8, int hd) {
  if (kv_int8 && !PAGED) return -1;
  switch (dtype) {
    case 0:
      return kv_int8 ? static_smem<float, int8_t, PAGED>(hd) : static_smem<float, float, PAGED>(hd);
    case 1:
      return kv_int8 ? static_smem<__nv_bfloat16, int8_t, PAGED>(hd)
                     : static_smem<__nv_bfloat16, __nv_bfloat16, PAGED>(hd);
    case 2:
      return kv_int8 ? static_smem<__half, int8_t, PAGED>(hd) : static_smem<__half, __half, PAGED>(hd);
    default:
      return -1;
  }
}

}  // namespace decode_body
