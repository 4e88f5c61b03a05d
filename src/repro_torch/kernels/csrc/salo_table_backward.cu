// SALO table-driven backward for Hopper (sm_90a): dQ (K2) and dK/dV (K3),
// CUDA C++ with a plain C interface (loaded through ctypes by
// repro_torch/kernels/_build.py).
//
// Replaces the TPU kernels repro/kernels/salo_backward.py::
// salo_table_backward_dq (body _dq_kernel) and salo_table_backward_dkv
// (body _dkv_kernel, plus the per-owner-tile scatter-add after it). Both
// recompute p = exp(s - m) / l from the forward's f32 row stats with the
// guarded shift (m <= NEG_INF/2 -> 0) and l (l == 0 -> 1), so a row that
// attends nothing contributes exactly zero, and both work in f32
// throughout (dout, delta, m, l are f32; q, k, v are widened on load):
//   dQ:    ds = p * (dout . v - delta);  dq_i = scale * sum_j ds_ij k_j
//          over the FORWARD tables; dq is written in q's type.
//   dK/dV: dv_j = sum_i p_ij dout_i;  dk_j = scale * sum_i ds_ij q_i
//          over the PACKED transposed tables (row r owns KV tile
//          row_tile[r]); f32 per-row partials, then summed per owner tile.
//
// Bound on this card: operations (6 and 8 flops x hd per attended pair,
// against each input byte read once). The score product q.k^T takes the
// compute-type q and k (the TPU kernels accumulate it in f32), so with
// 16-bit inputs the card could run its 2 x hd flops per pair at the 16-bit
// tensor rate and the rest at the f32 rate. Here every product runs on the
// CUDA cores in f32 FMA (exact f32, no TF32).
//
// Design, dQ: like the forward kernel — a block takes a 64-row slice of a
// plan query block with Q and dout resident (transposed, f32) and walks
// each step's KV tile in 64-key sub-tiles (K and V transposed for the two
// score products, K row-major for the ds @ K product); each thread owns a
// 4 x 4 block of the score tile and 4 rows x hd/16 columns of dq; masked
// sub-tiles are skipped.
// Design, dK/dV: a block takes a 64-key slice of packed row r's owner tile
// with K and V resident and streams the row's query blocks past in 32-query
// sub-tiles (Q and dout staged transposed and row-major); each thread owns
// 4 keys x 2 queries of the tile and 4 keys x hd/16 columns of dk and dv.
// The per-row partials land in an f32 buffer; a second, small kernel sums
// the rows of each owner tile in ascending row order. pack_rows emits the
// split rows of a tile next to each other, so the order is the plan's and
// never the scheduler's: two runs give bitwise-equal dK/dV (float atomics
// would not).
#include "salo_common.cuh"

namespace {

using namespace salo;

constexpr int kRows = 64;     // dQ: query rows of one block
constexpr int kKeys = 64;     // keys per sub-tile (dQ) / per block (dK/dV)
constexpr int kQs = 32;       // dK/dV: queries per sub-tile
constexpr int kLdT = 68;      // leading dim of 64-wide transposed tiles
constexpr int kLdQ = 36;      // leading dim of 32-wide transposed tiles

// ------------------------------- dQ (K2) -------------------------------- //
template <int HD>
constexpr int dq_smem_bytes() {
  return (4 * HD * kLdT + kKeys * (HD + 4) + kRows * kLdT) * 4 + kKeys * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ dout, const float* __restrict__ delta,
          const float* __restrict__ m, const float* __restrict__ l,
          const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const int* __restrict__ pos_q, const int* __restrict__ pos_k,
          const int* __restrict__ kvt, const int* __restrict__ flg, T* __restrict__ dq,
          MaskSpec ms, int nq, int bq, int nkb, int bk, int steps, float scale) {
  constexpr int LDR = HD + 4;
  constexpr int NU = HD / 64;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                       // [HD][kLdT]
  float* Ot = Qt + HD * kLdT;             // dout, [HD][kLdT]
  float* Kt = Ot + HD * kLdT;             // [HD][kLdT]
  float* Vt = Kt + HD * kLdT;             // [HD][kLdT]
  float* Ks = Vt + HD * kLdT;             // [kKeys][LDR]
  float* Ds = Ks + kKeys * LDR;           // ds, [kRows][kLdT]
  int* pk = reinterpret_cast<int*>(Ds + kRows * kLdT);

  const int rq = min(kRows, bq);
  const int ks = min(kKeys, bk);
  const int slices = bq / rq;
  const int i = blockIdx.x / slices;
  const int row0 = i * bq + (blockIdx.x % slices) * rq;
  const int64_t bh = blockIdx.y;
  const int nQ = nq * bq, nK = nkb * bk;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  stage_t<T, HD>(Qt, kLdT, q + (bh * nQ + row0) * HD, kRows, rq);
  stage_t<float, HD>(Ot, kLdT, dout + (bh * nQ + row0) * HD, kRows, rq);
  int pq[4];
  float shift[4], lsafe[4], dl[4], acc[4][4 * NU];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty * 4 + r;
    const bool ok = row < rq;
    const int64_t g = bh * nQ + row0 + row;
    pq[r] = ok ? pos_q[row0 + row] : kBig;
    const float mr = ok ? m[g] : kNegInf;
    const float lr = ok ? l[g] : 0.f;
    shift[r] = (mr <= kNegInf / 2) ? 0.f : mr;
    lsafe[r] = (lr == 0.f) ? 1.f : lr;
    dl[r] = ok ? delta[g] : 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NU; ++c) acc[r][c] = 0.f;
  }

  for (int s = 0; s < steps; ++s) {
    const int fl = flg[i * steps + s];
    if (fl == 0) continue;
    const int tile = kvt[i * steps + s];
    for (int sub = 0; sub < bk / ks; ++sub) {
      const int key0 = tile * bk + sub * ks;
      __syncthreads();
      stage_t<T, HD>(Kt, kLdT, k + (bh * nK + key0) * HD, kKeys, ks);
      stage_t<T, HD>(Vt, kLdT, v + (bh * nK + key0) * HD, kKeys, ks);
      stage_r<T, HD>(Ks, LDR, k + (bh * nK + key0) * HD, kKeys, ks);
      if (tid < kKeys) pk[tid] = tid < ks ? pos_k[key0 + tid] : kBig;
      __syncthreads();

      bool mk[4][4];
      bool any = false;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          mk[r][c] = step_mask(ms, pq[r], pk[tx * 4 + c], fl);
          any = any || mk[r][c];
        }
      if (!__syncthreads_or(any)) continue;

      float sc[4][4], dp[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(Qt + d * kLdT + ty * 4);
        const float4 b = *reinterpret_cast<const float4*>(Kt + d * kLdT + tx * 4);
        const float4 o = *reinterpret_cast<const float4*>(Ot + d * kLdT + ty * 4);
        const float4 w = *reinterpret_cast<const float4*>(Vt + d * kLdT + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
        const float ov[4] = {o.x, o.y, o.z, o.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            sc[r][c] = fmaf(av[r], bv[c], sc[r][c]);
            dp[r][c] = fmaf(ov[r], wv[c], dp[r][c]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float ds[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = mk[r][c] ? expf(sc[r][c] * scale - shift[r]) / lsafe[r] : 0.f;
          ds[c] = p * (dp[r][c] - dl[r]);
        }
        *reinterpret_cast<float4*>(Ds + (ty * 4 + r) * kLdT + tx * 4) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
      __syncthreads();

      for (int j = 0; j < ks; ++j) {
        float dj[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) dj[r] = Ds[(ty * 4 + r) * kLdT + j];
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          const float4 kk = *reinterpret_cast<const float4*>(Ks + j * LDR + u * 64 + tx * 4);
          const float kf[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[r][u * 4 + e] = fmaf(dj[r], kf[e], acc[r][u * 4 + e]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty * 4 + r;
    if (row >= rq) continue;
    const int64_t g = bh * nQ + row0 + row;
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dq[g * HD + u * 64 + tx * 4 + e] = from_f32<T>(acc[r][u * 4 + e] * scale);
  }
}

// ------------------------------ dK/dV (K3) ------------------------------ //
template <int HD>
constexpr int dkv_smem_bytes() {
  return (2 * HD * kLdT + 2 * HD * kLdQ + 2 * kQs * (HD + 4) + 2 * kKeys * kLdQ + 3 * kQs) *
             4 + kQs * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const float* __restrict__ dout, const float* __restrict__ delta,
           const float* __restrict__ m, const float* __restrict__ l,
           const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const int* __restrict__ pos_q, const int* __restrict__ pos_k,
           const int* __restrict__ row_tile, const int* __restrict__ qbt,
           const int* __restrict__ flg, float* __restrict__ part_dk,
           float* __restrict__ part_dv, MaskSpec ms, int nq, int bq, int nkb, int bk,
           int R, int steps, float scale) {
  constexpr int LDR = HD + 4;
  constexpr int NU = HD / 64;
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                       // [HD][kLdT] resident
  float* Vt = Kt + HD * kLdT;             // [HD][kLdT] resident
  float* Qt = Vt + HD * kLdT;             // [HD][kLdQ]
  float* Ot = Qt + HD * kLdQ;             // dout, [HD][kLdQ]
  float* Qs = Ot + HD * kLdQ;             // [kQs][LDR]
  float* Os = Qs + kQs * LDR;             // dout, [kQs][LDR]
  float* Pt = Os + kQs * LDR;             // p^T, [kKeys][kLdQ]
  float* Dt = Pt + kKeys * kLdQ;          // ds^T, [kKeys][kLdQ]
  float* sh_shift = Dt + kKeys * kLdQ;    // [kQs]
  float* sh_lsafe = sh_shift + kQs;
  float* sh_dl = sh_lsafe + kQs;
  int* sh_pq = reinterpret_cast<int*>(sh_dl + kQs);

  const int ks = min(kKeys, bk);
  const int qs = min(kQs, bq);
  const int kslices = bk / ks;
  const int r = blockIdx.x / kslices;
  const int tile = row_tile[r];
  const int kofs = (blockIdx.x % kslices) * ks;   // key offset inside the tile
  const int key0 = tile * bk + kofs;
  const int64_t bh = blockIdx.y;
  const int nQ = nq * bq, nK = nkb * bk;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  stage_t<T, HD>(Kt, kLdT, k + (bh * nK + key0) * HD, kKeys, ks);
  stage_t<T, HD>(Vt, kLdT, v + (bh * nK + key0) * HD, kKeys, ks);
  int pkr[4];
  float dk[4][4 * NU], dv[4][4 * NU];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int key = ty * 4 + kk;
    pkr[kk] = key < ks ? pos_k[key0 + key] : kBig;
#pragma unroll
    for (int c = 0; c < 4 * NU; ++c) dk[kk][c] = dv[kk][c] = 0.f;
  }

  for (int s = 0; s < steps; ++s) {
    const int fl = flg[r * steps + s];
    if (fl == 0) continue;
    const int qb = qbt[r * steps + s];
    for (int sub = 0; sub < bq / qs; ++sub) {
      const int q0 = qb * bq + sub * qs;
      __syncthreads();
      stage_t<T, HD>(Qt, kLdQ, q + (bh * nQ + q0) * HD, kQs, qs);
      stage_t<float, HD>(Ot, kLdQ, dout + (bh * nQ + q0) * HD, kQs, qs);
      stage_r<T, HD>(Qs, LDR, q + (bh * nQ + q0) * HD, kQs, qs);
      stage_r<float, HD>(Os, LDR, dout + (bh * nQ + q0) * HD, kQs, qs);
      if (tid < kQs) {
        const bool ok = tid < qs;
        const int64_t g = bh * nQ + q0 + tid;
        const float mr = ok ? m[g] : kNegInf;
        const float lr = ok ? l[g] : 0.f;
        sh_shift[tid] = (mr <= kNegInf / 2) ? 0.f : mr;
        sh_lsafe[tid] = (lr == 0.f) ? 1.f : lr;
        sh_dl[tid] = ok ? delta[g] : 0.f;
        sh_pq[tid] = ok ? pos_q[q0 + tid] : kBig;
      }
      __syncthreads();

      bool mk[4][2];
      bool any = false;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          mk[kk][c] = step_mask(ms, sh_pq[tx * 2 + c], pkr[kk], fl);
          any = any || mk[kk][c];
        }
      if (!__syncthreads_or(any)) continue;

      float sc[4][2], dp[4][2];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < 2; ++c) sc[kk][c] = dp[kk][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(Kt + d * kLdT + ty * 4);
        const float4 w = *reinterpret_cast<const float4*>(Vt + d * kLdT + ty * 4);
        const float2 b = *reinterpret_cast<const float2*>(Qt + d * kLdQ + tx * 2);
        const float2 o = *reinterpret_cast<const float2*>(Ot + d * kLdQ + tx * 2);
        const float av[4] = {a.x, a.y, a.z, a.w}, wv[4] = {w.x, w.y, w.z, w.w};
        const float bv[2] = {b.x, b.y}, ov[2] = {o.x, o.y};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            sc[kk][c] = fmaf(av[kk], bv[c], sc[kk][c]);
            dp[kk][c] = fmaf(wv[kk], ov[c], dp[kk][c]);
          }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float p2[2], d2[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qi = tx * 2 + c;
          const float p =
              mk[kk][c] ? expf(sc[kk][c] * scale - sh_shift[qi]) / sh_lsafe[qi] : 0.f;
          p2[c] = p;
          d2[c] = p * (dp[kk][c] - sh_dl[qi]);
        }
        *reinterpret_cast<float2*>(Pt + (ty * 4 + kk) * kLdQ + tx * 2) = make_float2(p2[0], p2[1]);
        *reinterpret_cast<float2*>(Dt + (ty * 4 + kk) * kLdQ + tx * 2) = make_float2(d2[0], d2[1]);
      }
      __syncthreads();

      for (int j = 0; j < qs; ++j) {
        float pj[4], dj[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pj[kk] = Pt[(ty * 4 + kk) * kLdQ + j];
          dj[kk] = Dt[(ty * 4 + kk) * kLdQ + j];
        }
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          const float4 o = *reinterpret_cast<const float4*>(Os + j * LDR + u * 64 + tx * 4);
          const float4 a = *reinterpret_cast<const float4*>(Qs + j * LDR + u * 64 + tx * 4);
          const float of[4] = {o.x, o.y, o.z, o.w}, qf[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dv[kk][u * 4 + e] = fmaf(pj[kk], of[e], dv[kk][u * 4 + e]);
              dk[kk][u * 4 + e] = fmaf(dj[kk], qf[e], dk[kk][u * 4 + e]);
            }
        }
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int key = ty * 4 + kk;
    if (key >= ks) continue;
    const int64_t g = (bh * R + r) * (int64_t)bk + kofs + key;
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        part_dk[g * HD + u * 64 + tx * 4 + e] = dk[kk][u * 4 + e] * scale;
        part_dv[g * HD + u * 64 + tx * 4 + e] = dv[kk][u * 4 + e];
      }
  }
}

// Owner-tile sum: dk[b, t] = sum of part_dk[b, r] over the rows r with
// row_tile[r] == t, in ascending r (a fixed order: deterministic). Grid
// (nkb, B); dynamic shared memory holds the matching row list (R ints).
__global__ void __launch_bounds__(kThreads)
owner_sum_kernel(const float* __restrict__ part_dk, const float* __restrict__ part_dv,
                 const int* __restrict__ row_tile, float* __restrict__ dk,
                 float* __restrict__ dv, int R, int tile_elems) {
  extern __shared__ int rows[];
  __shared__ int cnt;
  const int t = blockIdx.x;
  const int64_t bh = blockIdx.y;
  if (threadIdx.x == 0) {
    int c = 0;
    for (int r = 0; r < R; ++r)
      if (row_tile[r] == t) rows[c++] = r;
    cnt = c;
  }
  __syncthreads();
  const int64_t out0 = (bh * gridDim.x + t) * tile_elems;
  for (int e = threadIdx.x; e < tile_elems; e += kThreads) {
    float sk = 0.f, sv = 0.f;
    for (int c = 0; c < cnt; ++c) {
      const int64_t src = (bh * R + rows[c]) * tile_elems + e;
      sk += part_dk[src];
      sv += part_dv[src];
    }
    dk[out0 + e] = sk;
    dv[out0 + e] = sv;
  }
}

template <typename T, int HD>
cudaError_t launch_dq(const float* dout, const float* delta, const float* m, const float* l,
                      const void* q, const void* k, const void* v, const int* pos_q,
                      const int* pos_k, const int* kvt, const int* flg, void* dq,
                      const MaskSpec& ms, int B, int nq, int bq, int nkb, int bk, int steps,
                      float scale, cudaStream_t stream) {
  auto kern = dq_kernel<T, HD>;
  constexpr int smem = dq_smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(nq * (bq / min(kRows, bq)), B);
  kern<<<grid, kThreads, smem, stream>>>(
      dout, delta, m, l, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos_q, pos_k, kvt, flg, static_cast<T*>(dq), ms, nq, bq, nkb,
      bk, steps, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const float* dout, const float* delta, const float* m, const float* l,
                       const void* q, const void* k, const void* v, const int* pos_q,
                       const int* pos_k, const int* row_tile, const int* qbt, const int* flg,
                       float* part_dk, float* part_dv, float* dk, float* dv,
                       const MaskSpec& ms, int B, int nq, int bq, int nkb, int bk, int R,
                       int steps, float scale, cudaStream_t stream) {
  auto kern = dkv_kernel<T, HD>;
  constexpr int smem = dkv_smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(R * (bk / min(kKeys, bk)), B);
  kern<<<grid, kThreads, smem, stream>>>(
      dout, delta, m, l, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos_q, pos_k, row_tile, qbt, flg, part_dk, part_dv, ms, nq,
      bq, nkb, bk, R, steps, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t rows_bytes = (size_t)R * sizeof(int);
  if (rows_bytes > 48 * 1024) return cudaErrorInvalidValue;
  owner_sum_kernel<<<dim3(nkb, B), kThreads, rows_bytes, stream>>>(
      part_dk, part_dv, row_tile, dk, dv, R, bk * HD);
  return cudaGetLastError();
}

bool block_ok(int b) { return b == 32 || b == 64 || b == 128 || b == 256; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (of q, k, v; dout, delta,
// m, l are f32); hd in {64, 128}; block_q, block_k in {32, 64, 128, 256}.
// q, dout: (B, nq*bq, hd); delta, m, l: (B, nq*bq); k, v: (B, nkb*bk, hd);
// pos_q: (nq*bq,), pos_k: (nkb*bk,), kvt, flg: (nq*steps,) int32. dq is
// written in q's type. Returns cudaGetLastError() after the launch.
int salo_table_backward_dq(int dtype, int hd, const void* dout, const void* delta,
                           const void* m, const void* l, const void* q, const void* k,
                           const void* v, const void* pos_q, const void* pos_k,
                           const void* kvt, const void* flg, void* dq, const MaskSpec* ms,
                           int B, int nq, int bq, int nkb, int bk, int steps, float scale,
                           void* stream) {
  if (B <= 0 || nq <= 0 || nkb <= 0 || steps <= 0 || !block_ok(bq) || !block_ok(bk))
    return (int)cudaErrorInvalidValue;
  const float* d_o = static_cast<const float*>(dout);
  const float* dl = static_cast<const float*>(delta);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  const int* pq = static_cast<const int*>(pos_q);
  const int* pk = static_cast<const int*>(pos_k);
  const int* kt = static_cast<const int*>(kvt);
  const int* fl = static_cast<const int*>(flg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SALO_DQ(T, HD)                                                                   \
  launch_dq<T, HD>(d_o, dl, mf, lf, q, k, v, pq, pk, kt, fl, dq, *ms, B, nq, bq, nkb, bk, \
                   steps, scale, s)
  if (hd != 64 && hd != 128) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)(hd == 64 ? SALO_DQ(float, 64) : SALO_DQ(float, 128));
    case 1: return (int)(hd == 64 ? SALO_DQ(__nv_bfloat16, 64) : SALO_DQ(__nv_bfloat16, 128));
    case 2: return (int)(hd == 64 ? SALO_DQ(__half, 64) : SALO_DQ(__half, 128));
    default: return (int)cudaErrorInvalidValue;
  }
#undef SALO_DQ
}

// As above, plus row_tile: (R,), qbt, flg: (R*steps,) int32 packed
// transposed tables; part_dk, part_dv: (B, R*bk, hd) f32 scratch; dk, dv:
// (B, nkb*bk, hd) f32. Two launches on `stream`: the row walk, then the
// owner-tile sum. Returns cudaGetLastError() after them.
int salo_table_backward_dkv(int dtype, int hd, const void* dout, const void* delta,
                            const void* m, const void* l, const void* q, const void* k,
                            const void* v, const void* pos_q, const void* pos_k,
                            const void* row_tile, const void* qbt, const void* flg,
                            void* part_dk, void* part_dv, void* dk, void* dv,
                            const MaskSpec* ms, int B, int nq, int bq, int nkb, int bk, int R,
                            int steps, float scale, void* stream) {
  if (B <= 0 || nq <= 0 || nkb <= 0 || R <= 0 || steps <= 0 || !block_ok(bq) ||
      !block_ok(bk))
    return (int)cudaErrorInvalidValue;
  const float* d_o = static_cast<const float*>(dout);
  const float* dl = static_cast<const float*>(delta);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  const int* pq = static_cast<const int*>(pos_q);
  const int* pk = static_cast<const int*>(pos_k);
  const int* rt = static_cast<const int*>(row_tile);
  const int* qt = static_cast<const int*>(qbt);
  const int* fl = static_cast<const int*>(flg);
  float* pdk = static_cast<float*>(part_dk);
  float* pdv = static_cast<float*>(part_dv);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SALO_DKV(T, HD)                                                                     \
  launch_dkv<T, HD>(d_o, dl, mf, lf, q, k, v, pq, pk, rt, qt, fl, pdk, pdv, dkf, dvf, *ms, B, \
                    nq, bq, nkb, bk, R, steps, scale, s)
  if (hd != 64 && hd != 128) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)(hd == 64 ? SALO_DKV(float, 64) : SALO_DKV(float, 128));
    case 1: return (int)(hd == 64 ? SALO_DKV(__nv_bfloat16, 64) : SALO_DKV(__nv_bfloat16, 128));
    case 2: return (int)(hd == 64 ? SALO_DKV(__half, 64) : SALO_DKV(__half, 128));
    default: return (int)cudaErrorInvalidValue;
  }
#undef SALO_DKV
}

const char* salo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
