// SALO ragged paged decode for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded through ctypes by repro_torch/kernels/_build.py).
//
// Replaces the TPU kernel repro/kernels/salo_decode.py::salo_paged_decode
// (body: _make_paged_kernel + _tile_update), fp-slab variant: one new
// query token per request against the pooled paged ring-cache slab
// (n_pages, page, Hkv, hd), shared by every request. The physical page of
// logical slot s of request b is page_tables[b, s / page] and is read from
// global memory inside the kernel; the slab is never gathered.
//
// What it computes, per (request b, kv head h), over the rep = H / Hkv
// query rows of the group and every logical slot of the request:
//   rel = pos_k - t[b];  mask = (rel in [a, 0] && rel % dilation == 0)
//                               || pos_k < n_global;   mask &= pos_k <= t[b]
//   online softmax in f32 with the guarded NEG_INF/2 shift and corr, the
//   unnormalized p rounded to V's type before the PV product (as the TPU
//   kernel does), f32 accumulation, out = acc / (l == 0 ? 1 : l) in q's
//   type. A row with no live slot gives 0 (the reference's XLA twin gives
//   the mean of V there; only inactive engine rows are empty, and their
//   logits are discarded).
//
// Bound on this card: bytes. Per launch it must read the live slots' K and
// V rows (2 * live_slots * hd * sizeof(T) per (b, h)) plus q, the page
// tables and the positions; the arithmetic is ~4*rep*hd flops per live
// slot, far below the bf16 tensor-core ridge. So the design is about
// keeping many loads in flight, since few blocks run:
//
// Design: one block of 256 threads per (b, h) and group of up to kRows = 4
// query rows (grid Hkv x B x ceil(rep / 4)), a loop over tiles of 256
// logical slots (16 pages of 16). Per tile, three phases:
//   A. one thread per slot: position, mask and page lookup; a live slot's
//      thread reads its whole K row in 16-byte loads (all issued before the
//      FMAs) and computes the kRows scores. Dead slots read nothing, and a
//      tile without a live slot is skipped after one barrier.
//   B. one warp per row: tile max, guarded shift, p (rounded to V's type),
//      corr and the (m, l) update.
//   C. threads own (16-byte chunk of d, slot group): each reads V chunks of
//      its live slots in batches of 16-byte loads and keeps the kRows
//      partial sums in registers across tiles (rescaled by corr).
// After the last tile the slot groups' partials are summed in shared
// memory. K/V rows are read at stride Hkv*hd in the slab. No LANES-wide
// stat scratch, no scalar prefetch: what the TPU layout needed is gone.
//
// Known weakness: the grid is only B x Hkv blocks (24 at B=8, Hkv=3 on
// 132 SMs) and each block walks its tiles in sequence with three barriers
// each. A later version splits the tiles of a request over several blocks
// and merges the partial (acc, m, l) with the renorm merge.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads;          // slots per tile: one per thread in A
constexpr int kRows = 4;                 // query rows per block

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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,           // (B, H, 1, HD)
                    const T* __restrict__ k_slab,      // (n_pages, page, Hkv, HD)
                    const T* __restrict__ v_slab,
                    const int32_t* __restrict__ page_tables,  // (B, npp)
                    const int32_t* __restrict__ positions,    // (B, npp*page)
                    const int32_t* __restrict__ t_vec,        // (B,)
                    T* __restrict__ out,                      // (B, H, 1, HD)
                    int H, int Hkv, int page, int npp,
                    int win_lo, int dilation, int n_global, float scale) {
  constexpr int N = Vec<T>::N;             // elements per 16-byte load
  constexpr int NC = HD / N;               // 16-byte chunks per row
  constexpr int G = kThreads / NC;         // slot groups in phase C
  constexpr int SPT = kTile / G;           // slots per thread in phase C
  constexpr int KB = SPT < 8 ? SPT : 8;    // loads in flight per batch
  constexpr int KA = NC < 8 ? NC : 8;

  __shared__ __align__(16) float q_sh[kRows * HD];
  __shared__ float s_sh[kRows * kTile];    // scores, then p in V's type
  __shared__ int64_t row_sh[kTile];        // slab element offset of the slot
  __shared__ int live_sh[kTile];
  __shared__ float m_sh[kRows], l_sh[kRows], c_sh[kRows];
  __shared__ float red_sh[G * kRows * HD]; // slot groups' partial sums

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = H / Hkv;
  const int r0 = blockIdx.z * kRows;       // first row of this block's group
  const int nr = min(kRows, rep - r0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = t_vec[b];
  const int S = npp * page;
  const int64_t row_stride = (int64_t)Hkv * HD;      // one slot of the slab

  const T* q_b = q + ((int64_t)b * H + (int64_t)h * rep + r0) * HD;
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

  const int32_t* pos_b = positions + (int64_t)b * S;
  const int32_t* pt_b = page_tables + (int64_t)b * npp;
  for (int t0 = 0; t0 < S; t0 += kTile) {
    // Phase A: mask, page lookup and scores, one thread per slot.
    const int s = t0 + tid;
    bool live = false;
    int64_t row = 0;
    if (s < S) {
      const int pos = pos_b[s];
      const int64_t pg = pt_b[s / page];
      const int rel = pos - t;
      live = (rel >= win_lo) && (rel <= 0);
      if (dilation > 1) live = live && (rel % dilation == 0);
      if (n_global > 0) live = live || (pos < n_global);
      live = live && (pos <= t);
      row = ((pg * page + s % page) * row_stride) + (int64_t)h * HD;
    }
    float sc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = 0.f;
    if (live) {
      const T* k_row = k_slab + row;
#pragma unroll 1
      for (int cb = 0; cb < NC; cb += KA) {
        float kf[KA][N];
#pragma unroll
        for (int u = 0; u < KA; ++u) load16(k_row + (cb + u) * N, kf[u]);
#pragma unroll
        for (int u = 0; u < KA; ++u) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float* q_r = q_sh + r * HD + (cb + u) * N;
#pragma unroll
            for (int e = 0; e < N; ++e) sc[r] += q_r[e] * kf[u][e];
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) s_sh[r * kTile + tid] = live ? sc[r] * scale : kNegInf;
    live_sh[tid] = live ? 1 : 0;
    row_sh[tid] = row;
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
        const float p = live_sh[j] ? expf(s_r[j] - shift) : 0.f;
        sum += p;
        s_r[j] = to_f32(from_f32<T>(p));   // p in V's type for the PV product
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = (m_prev <= kNegInf / 2) ? 0.f : expf(m_prev - shift);
        c_sh[r] = corr;
        l_sh[r] = l_sh[r] * corr + sum;
        m_sh[r] = m_new;
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
          load16(v_slab + row_sh[j] + c * N, vf[u]);
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
          const float p = s_sh[r * kTile + j];
#pragma unroll
          for (int e = 0; e < N; ++e) part[r][e] += p * vf[u][e];
        }
      }
    }
    __syncthreads();   // the next tile overwrites s_sh, live_sh, row_sh
  }

  // Sum the slot groups' partials, normalize, write the rows of this block.
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int e = 0; e < N; ++e) red_sh[(g * kRows + r) * HD + c * N + e] = part[r][e];
  __syncthreads();
  T* out_b = out + ((int64_t)b * H + (int64_t)h * rep + r0) * HD;
  for (int e = tid; e < nr * HD; e += kThreads) {
    const int r = e / HD;
    const int d = e - r * HD;
    float acc = 0.f;
    for (int gg = 0; gg < G; ++gg) acc += red_sh[(gg * kRows + r) * HD + d];
    const float l = l_sh[r];
    out_b[e] = from_f32<T>(acc / (l == 0.f ? 1.f : l));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int32_t* pt,
                   const int32_t* pos, const int32_t* t, void* out, int B, int H,
                   int Hkv, int page, int npp, int win_lo, int dilation,
                   int n_global, float scale, cudaStream_t stream) {
  const int rep = H / Hkv;
  dim3 grid(Hkv, B, (rep + kRows - 1) / kRows);
  paged_decode_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      pt, pos, t, static_cast<T*>(out), H, Hkv, page, npp, win_lo, dilation,
      n_global, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const int32_t* pt, const int32_t* pos, const int32_t* t,
                        void* out, int B, int H, int Hkv, int page, int npp,
                        int win_lo, int dilation, int n_global, float scale,
                        cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, pt, pos, t, out, B, H, Hkv, page, npp, win_lo,
                           dilation, n_global, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, pt, pos, t, out, B, H, Hkv, page, npp, win_lo,
                            dilation, n_global, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, pt, pos, t, out, B, H, Hkv, page, npp, win_lo,
                            dilation, n_global, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns cudaGetLastError()
// after the launch (0 = success); the launch is asynchronous on `stream`.
// The slabs must be 16-byte aligned (the wrapper checks).
int salo_paged_decode(int dtype, int hd, const void* q, const void* k_slab,
                      const void* v_slab, const void* page_tables,
                      const void* positions, const void* t, void* out, int B,
                      int H, int Hkv, int page, int npp, int win_lo, int dilation,
                      int n_global, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || page <= 0 || npp <= 0)
    return (int)cudaErrorInvalidValue;
  const int32_t* pt = static_cast<const int32_t*>(page_tables);
  const int32_t* pos = static_cast<const int32_t*>(positions);
  const int32_t* tv = static_cast<const int32_t*>(t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case 0:
      e = dispatch_hd<float>(hd, q, k_slab, v_slab, pt, pos, tv, out, B, H, Hkv,
                             page, npp, win_lo, dilation, n_global, scale, s);
      break;
    case 1:
      e = dispatch_hd<__nv_bfloat16>(hd, q, k_slab, v_slab, pt, pos, tv, out, B, H,
                                     Hkv, page, npp, win_lo, dilation, n_global,
                                     scale, s);
      break;
    case 2:
      e = dispatch_hd<__half>(hd, q, k_slab, v_slab, pt, pos, tv, out, B, H, Hkv,
                              page, npp, win_lo, dilation, n_global, scale, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return (int)e;
}

const char* salo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
