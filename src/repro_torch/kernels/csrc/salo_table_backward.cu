// SALO table-driven backward for Hopper (sm_90a): dQ (K2) and dK/dV (K3),
// CUDA C++ with a plain C interface (loaded through ctypes by
// repro_torch/kernels/_build.py).
//
// Replaces the TPU kernels repro/kernels/salo_backward.py::
// salo_table_backward_dq (body _dq_kernel) and salo_table_backward_dkv
// (body _dkv_kernel, plus the per-owner-tile scatter-add after it). Both
// recompute p = exp(s - m) / l from the forward's f32 row stats with the
// guarded shift (m <= NEG_INF/2 -> 0) and l (l == 0 -> 1), so a row that
// attends nothing contributes exactly zero (dout, delta, m, l are f32):
//   dQ:    ds = p * (dout . v - delta);  dq_i = scale * sum_j ds_ij k_j
//          over the FORWARD tables; dq is written in q's type.
//   dK/dV: dv_j = sum_i p_ij dout_i;  dk_j = scale * sum_i ds_ij q_i
//          over the PACKED transposed tables (row r owns KV tile
//          row_tile[r]); f32 per-row partials, then summed per owner tile.
//
// Bound on this card: operations. With 16-bit inputs each product runs
// once on the tensor cores at their 16-bit rate: 6 x hd flops per attended
// pair for dQ (q.k^T, dout.v^T, ds.k) and 8 x hd for dK/dV (q.k^T,
// dout.v^T, p^T.dout, ds^T.q), against each input byte read once. The
// hi/lo split below runs 10 x hd and 16 x hd flops per pair; the f32 path
// prices every product at the f32 CUDA-core rate.
//
// Numerics. The TPU kernels take the compute-type q and k as they are in
// the score product (f32 accumulator) and take dout, p, ds and the widened
// v, k, q in f32 in the other products. One rounding of those f32 operands
// to 16 bits would move dK/dV by ~1e-2 (bf16). So the 16-bit path keeps
// them exact to ~2^-16 relative: each f32 operand x is split, in
// registers or once at staging, into hi = rn(x) and lo = rn(x - hi) in the
// inputs' own 16-bit type, and each product sums its partial products in
// f32 on mma.sync.m16n8k16: a * b16 = hi*b + lo*b where b (v, k or q) is
// exact in 16 bits, and p^T.dout = hi*hi + hi*lo + lo*hi. With f16
// inputs dout (and with it dp, delta and ds) is first scaled by an exact
// power of two that brings its largest |element| into [0.5, 1), and the
// sums are scaled back after: a train step's dout (~1e-6) lies below
// f16's normal range, where hi and lo would lose their bits. dQ scales
// each query row by its own power, and its ds once more, per row, by the
// power that puts the largest |ds| so far in [2^14, 2^15): the small ds of
// far keys then stay above f16's subnormals (without it, 2.8 % of an f16
// dq at the train shapes sat one rounding off the f32 value on the H100;
// PERF.md). dK/dV, whose sums run over queries, scales each 64-query
// sub-tile by one power. Both rescale their accumulators, exactly, when a
// power moves. bf16 has f32's exponent range, where powers of two commute
// with rounding: the scale would give the same bits at a cost
// (tools/ab_backward.py), so bf16 skips it. The f32 instantiation is the
// exact path: every product in f32 FMA on the CUDA cores (no TF32), as the
// first version of these kernels did.
//
// Design, 16-bit dQ (dq_mma_kernel): a block owns 16 x NW rows of a plan
// query block (NW warps, a warp 16 rows) with Q and dout's hi/lo resident
// in shared memory, and walks each step's KV tile in 64-key sub-tiles
// through a two-stage cp.async ring: the next live sub-tile loads while
// this one computes. Per sub-tile a warp runs S = Q.K^T and dP (split) on
// mma.sync with ldmatrix fragments, p and ds in registers, and dQ += ds.K
// with ds's C fragments reused as A fragments (no shared-memory round
// trip); K serves both products, through ldmatrix and ldmatrix.trans.
// Design, 16-bit dK/dV (dkv_mma_kernel): a block owns 16 x NW keys of
// packed row r's owner tile with K and V resident; the row's query blocks
// stream past in 64-query sub-tiles through the ring (Q, dout in f32, m, l,
// delta), dout split once per sub-tile. A warp owns 16 keys: S^T = K.Q^T
// and dP^T, then dV += p^T.dout and dK += ds^T.Q from the same register
// reuse. Both kernels evaluate step_mask only on the 32 score positions a
// thread owns (one bit each), skip a sub-tile in which no pair of the
// block survives before loading it, and skip a warp's products where none
// of its own pairs does.
//
// Design, f32 dQ (dq_kernel): like the forward kernel — a block takes a
// 64-row slice of a plan query block with Q and dout resident (transposed,
// f32) and walks each step's KV tile in 64-key sub-tiles (K and V
// transposed for the two score products, K row-major for the ds @ K
// product); each thread owns a 4 x 4 block of the score tile and 4 rows x
// hd/16 columns of dq; masked sub-tiles are skipped.
// Design, f32 dK/dV (dkv_kernel): a block takes a 64-key slice of packed
// row r's owner tile with K and V resident and streams the row's query
// blocks past in 32-query sub-tiles (Q and dout staged transposed and
// row-major); each thread owns 4 keys x 2 queries of the tile and 4 keys x
// hd/16 columns of dk and dv.
// At hd 256 both f32 kernels stage the score products' operands (Q, dout,
// K, V transposed) 128 hd columns at a time, each sub-tile, in the same
// order of arithmetic: the resident tiles above would take 362,752 (dQ)
// and 298,496 (dK/dV) of the 232,448 bytes a block may have.
// Design at hd 256, 16-bit: a warp's 16 x 256 accumulators (dq, or dk and
// dv) do not fit in its registers beside the score fragments, so the
// accumulated columns are split over blocks: blockIdx.z takes hd columns
// [128z, 128z + 128) of dq (or dk, dv) and recomputes S and dP over the
// full hd from shared memory, in the same order as the other block, so the
// split changes no number; the launch counts stay as they are. dQ then runs
// 2-warp blocks (Q, dout hi/lo and the K/V ring over 264-element rows take
// 189,976 bytes), dK/dV 4-warp blocks (211,256 bytes), whose dout is read
// straight from global memory (L2) at the split instead of through a
// 65,536-byte f32 staging buffer.
// Both dK/dV paths write f32 per-row partials; a second, small kernel sums
// the rows of each owner tile in ascending row order. pack_rows emits the
// split rows of a tile next to each other, so the order is the plan's and
// never the scheduler's: two runs give bitwise-equal dK/dV (float atomics
// would not). On the 16-bit path a tile with a single packed row is
// written by the row walk straight into dk/dv and the sum skips it.
#include <type_traits>

#include "salo_mma.cuh"

namespace {

using namespace salo;

constexpr int kRows = 64;     // dQ: query rows of one block
constexpr int kKeys = 64;     // keys per sub-tile (dQ) / per block (dK/dV)
constexpr int kQs = 32;       // dK/dV: queries per sub-tile
constexpr int kLdT = 68;      // leading dim of 64-wide transposed tiles
constexpr int kLdQ = 36;      // leading dim of 32-wide transposed tiles

// hd columns the f32 kernels stage at once: all of them up to hd 128
__host__ __device__ constexpr int staged_cols(int hd) { return hd > 128 ? 128 : hd; }

// ------------------------------- dQ (K2) -------------------------------- //
template <int HD>
constexpr int dq_smem_bytes() {
  return (4 * staged_cols(HD) * kLdT + kKeys * (HD + 4) + kRows * kLdT) * 4 + kKeys * 4;
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
  constexpr int HC = staged_cols(HD);
  constexpr bool kResident = HC == HD;    // Q and dout staged once
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                       // [HC][kLdT]
  float* Ot = Qt + HC * kLdT;             // dout, [HC][kLdT]
  float* Kt = Ot + HC * kLdT;             // [HC][kLdT]
  float* Vt = Kt + HC * kLdT;             // [HC][kLdT]
  float* Ks = Vt + HC * kLdT;             // [kKeys][LDR]
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

  if constexpr (kResident) {
    stage_t<T, HD>(Qt, kLdT, q + (bh * nQ + row0) * HD, kRows, rq);
    stage_t<float, HD>(Ot, kLdT, dout + (bh * nQ + row0) * HD, kRows, rq);
  }
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
      const T* ksrc = k + (bh * nK + key0) * HD;
      __syncthreads();
      if constexpr (kResident) {
        stage_t<T, HD>(Kt, kLdT, ksrc, kKeys, ks);
        stage_t<T, HD>(Vt, kLdT, v + (bh * nK + key0) * HD, kKeys, ks);
      }
      stage_r<T, HD>(Ks, LDR, ksrc, kKeys, ks);
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
      for (int h0 = 0; h0 < HD; h0 += HC) {
        if constexpr (!kResident) {   // this chunk of hd columns of Q, dout, K, V
          __syncthreads();
          stage_t<T, HC, HD>(Qt, kLdT, q + (bh * nQ + row0) * HD + h0, kRows, rq);
          stage_t<float, HC, HD>(Ot, kLdT, dout + (bh * nQ + row0) * HD + h0, kRows, rq);
          stage_t<T, HC, HD>(Kt, kLdT, ksrc + h0, kKeys, ks);
          stage_t<T, HC, HD>(Vt, kLdT, v + (bh * nK + key0) * HD + h0, kKeys, ks);
          __syncthreads();
        }
#pragma unroll 4
        for (int d = 0; d < HC; ++d) {
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
  return (2 * staged_cols(HD) * (kLdT + kLdQ) + 2 * kQs * (HD + 4) + 2 * kKeys * kLdQ +
          3 * kQs) * 4 + kQs * 4;
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
  constexpr int HC = staged_cols(HD);
  constexpr bool kResident = HC == HD;    // K and V staged once
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                       // [HC][kLdT]
  float* Vt = Kt + HC * kLdT;             // [HC][kLdT]
  float* Qt = Vt + HC * kLdT;             // [HC][kLdQ]
  float* Ot = Qt + HC * kLdQ;             // dout, [HC][kLdQ]
  float* Qs = Ot + HC * kLdQ;             // [kQs][LDR]
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

  if constexpr (kResident) {
    stage_t<T, HD>(Kt, kLdT, k + (bh * nK + key0) * HD, kKeys, ks);
    stage_t<T, HD>(Vt, kLdT, v + (bh * nK + key0) * HD, kKeys, ks);
  }
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
      if constexpr (kResident) {
        stage_t<T, HD>(Qt, kLdQ, q + (bh * nQ + q0) * HD, kQs, qs);
        stage_t<float, HD>(Ot, kLdQ, dout + (bh * nQ + q0) * HD, kQs, qs);
      }
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
      for (int h0 = 0; h0 < HD; h0 += HC) {
        if constexpr (!kResident) {   // this chunk of hd columns of K, V, Q, dout
          __syncthreads();
          stage_t<T, HC, HD>(Kt, kLdT, k + (bh * nK + key0) * HD + h0, kKeys, ks);
          stage_t<T, HC, HD>(Vt, kLdT, v + (bh * nK + key0) * HD + h0, kKeys, ks);
          stage_t<T, HC, HD>(Qt, kLdQ, q + (bh * nQ + q0) * HD + h0, kQs, qs);
          stage_t<float, HC, HD>(Ot, kLdQ, dout + (bh * nQ + q0) * HD + h0, kQs, qs);
          __syncthreads();
        }
#pragma unroll 4
        for (int d = 0; d < HC; ++d) {
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

// ------------------- 16-bit inputs: the tensor-core path ------------------ //
template <int HD, int NW>
constexpr int dq_mma_smem_bytes() {   // Q, dout hi/lo; 2 stages of K, V; the walk
  return (3 * 16 * NW + 4 * kSub) * (HD + 8) * 2 + walk_smem_bytes<NW>();
}

// dQ on the tensor cores. A block owns RB = 16 * NW rows of a plan query
// block: Q and the hi/lo split of dout stay resident; each step's KV tile
// streams in 64-key sub-tiles through a two-stage cp.async ring, the next
// live sub-tile loading while this one computes. Warp w owns rows
// 16w..16w+15 and, per sub-tile, S = Q K^T and dP = dout_hi V^T +
// dout_lo V^T (16 x 64 each, f32 accumulators), p and ds in registers,
// then dQ += ds_hi K + ds_lo K with ds's C fragments reused as A fragments.
template <typename T, int HD, int NW>
__global__ void __launch_bounds__(NW * 32, min_blocks(NW, HD))
dq_mma_kernel(const float* __restrict__ dout, const float* __restrict__ delta,
              const float* __restrict__ m, const float* __restrict__ l,
              const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ pos_q, const int* __restrict__ pos_k,
              const int* __restrict__ kvt, const int* __restrict__ flg, T* __restrict__ dq,
              MaskSpec ms, int nq, int bq, int nkb, int bk, int steps, float scale) {
  using M = Mma16<T>;
  constexpr int LD = HD + 8, RB = 16 * NW, NT = 32 * NW, KC = HD / 8;
  constexpr int DC = acc_cols(HD);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [RB][LD], resident
  T* Dh = Qs + RB * LD;                     // dout hi, [RB][LD], resident
  T* Dl = Dh + RB * LD;                     // dout lo
  T* ring = Dl + RB * LD;                   // stage st: K at 2st, V at 2st + 1, [kSub][LD]

  const int c0 = DC == HD ? 0 : blockIdx.z * DC;   // this block's dq columns
  const int slices = bq / RB;
  const int i = blockIdx.x / slices;
  const int row0 = i * bq + (blockIdx.x % slices) * RB;
  const int64_t bh = blockIdx.y;
  const int nQ = nq * bq, nK = nkb * bk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tg = lane & 3;
  const int ks = min(kSub, bk);
  LiveWalk<NW> walk(reinterpret_cast<unsigned char*>(ring + 4 * kSub * LD), pos_k,
                    kvt + i * steps, flg + i * steps, steps, bk, ks);
  int ex[2] = {0, 0};   // rows g, g + 8: dout, delta and ds carry 2^-ex

  {
    // Q, and dout in f32 through the ring (free until K, V stream), then
    // dout's hi/lo split
    static_assert(RB * HD * 4 <= 4 * kSub * LD * 2, "dout staging exceeds the ring");
    float* Of = reinterpret_cast<float*>(ring);
    const T* src = q + (bh * nQ + row0) * HD;
    const float* osrc = dout + (bh * nQ + row0) * HD;
    for (int c = tid; c < RB * KC; c += NT) cp16(Qs + (c / KC) * LD + (c % KC) * 8, src + c * 8);
    for (int c = tid; c < RB * HD / 4; c += NT) cp16(Of + c * 4, osrc + c * 4);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    // Warp w splits its own 16 rows, in f16 row r scaled by 2^-e_r
    // (pow2_exp of its largest |element|); the thread keeps e of rows g and
    // g + 8.
#pragma unroll 1
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      float x[HD / 32];
#pragma unroll
      for (int c = 0; c < HD / 32; ++c) x[c] = Of[row * HD + lane * (HD / 32) + c];
      int e = 0;
      if constexpr (M::kScale) {
        float mx = 0.f;
#pragma unroll
        for (int c = 0; c < HD / 32; ++c) mx = fmaxf(mx, fabsf(x[c]));
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        e = pow2_exp(mx);
        if (r == g) ex[0] = e;
        if (r == g + 8) ex[1] = e;
      }
      const float sc = pow2(-e);
#pragma unroll
      for (int c = 0; c < HD / 32; c += 2) {
        uint32_t h, lo;
        split2<T>(x[c] * sc, x[c + 1] * sc, h, lo);
        const int o = row * LD + lane * (HD / 32) + c;
        *reinterpret_cast<uint32_t*>(Dh + o) = h;
        *reinterpret_cast<uint32_t*>(Dl + o) = lo;
      }
    }
    __syncthreads();
    // the rows a 32-key tile leaves empty stay zero (0 * 0, never 0 * NaN)
    const int tail = (kSub - ks) * KC;
    for (int c = tid; c < 4 * tail; c += NT)
      zero16(ring + (c / tail) * kSub * LD + (ks + (c % tail) / KC) * LD + (c % KC) * 8);
  }
  // p = exp(s * scale - shift) / l_safe as exp2(s * scale2 - shift2) * rl
  const float scale2 = scale * kLog2e;
  int pq[2];
  float shift2[2], rl[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + warp * 16 + g + 8 * h;
    const int64_t gi = bh * nQ + row;
    pq[h] = pos_q[row];
    const float mr = m[gi], lr = l[gi];
    shift2[h] = ((mr <= kNegInf / 2) ? 0.f : mr) * kLog2e;
    rl[h] = 1.f / ((lr == 0.f) ? 1.f : lr);
    dl[h] = delta[gi] * pow2(-ex[h]);
  }
  float acc[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  int dt[2] = {15 + kMaxExp, 15 + kMaxExp};   // f16: acc of rows g, g + 8 carry 2^dt

  // The mask on this thread's 32 score positions: bit 4j + 2h + e is row
  // g + 8h of the warp's 16, key 8j + 2t + e of the sub-tile.
  auto mask = [&](const int* ps, int fl) {
    int cp[16];
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j) {
      const int2 p = *reinterpret_cast<const int2*>(ps + 8 * j + 2 * tg);
      cp[2 * j] = p.x;
      cp[2 * j + 1] = p.y;
    }
    return mask_2x16<true>(ms, pq, cp, fl);
  };
  auto load_kv = [&](int st, int key0) {
    T* Kd = ring + 2 * st * kSub * LD;
    T* Vd = Kd + kSub * LD;
    const T* ksrc = k + (bh * nK + key0) * HD;
    const T* vsrc = v + (bh * nK + key0) * HD;
    for (int c = tid; c < (ks * KC); c += NT) {
      const int o = (c / KC) * LD + (c % KC) * 8;
      cp16(Kd + o, ksrc + c * 8);
      cp16(Vd + o, vsrc + c * 8);
    }
    cp_commit();
  };

  int key0 = 0, st = 0;
  uint32_t bits = 0;
  int u = walk.next(mask, key0, bits);
  if (u < walk.total) load_kv(0, key0);
  while (u < walk.total) {
    cp_wait<0>();
    __syncthreads();   // sub-tile u has landed; every warp is done with stage st ^ 1
    uint32_t bits1 = 0;
    const int u1 = walk.next(mask, key0, bits1);
    if (u1 < walk.total) load_kv(st ^ 1, key0);
    if (__any_sync(0xffffffffu, bits != 0u)) {
      const T* Ks = ring + 2 * st * kSub * LD;
      const T* Vs = Ks + kSub * LD;
      float sc[kSub / 8][4], dp[kSub / 8][4];
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[j][c] = dp[j][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int ao = (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
        uint32_t a[4], oh[4], ol[4];
        ldsm_x4(a, Qs + ao);
        ldsm_x4(oh, Dh + ao);
        ldsm_x4(ol, Dl + ao);
#pragma unroll
        for (int jp = 0; jp < kSub / 16; ++jp) {
          const int bo = (jp * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                         ((lane >> 3) & 1) * 8;
          uint32_t b[4];
          ldsm_x4(b, Ks + bo);
          M::mma(sc[2 * jp], a, b[0], b[1]);
          M::mma(sc[2 * jp + 1], a, b[2], b[3]);
          ldsm_x4(b, Vs + bo);
          M::mma(dp[2 * jp], oh, b[0], b[1]);
          M::mma(dp[2 * jp + 1], oh, b[2], b[3]);
          M::mma(dp[2 * jp], ol, b[0], b[1]);
          M::mma(dp[2 * jp + 1], ol, b[2], b[3]);
        }
      }
      float dsm[2] = {1.f, 1.f};
      if constexpr (M::kScale) {
        // ds in place of the scores, times 2^dt of its row: dt is the
        // running minimum over the row's sub-tiles of 15 - pow2_exp(max
        // |ds|), so the largest |ds| so far lies in [2^14, 2^15). Small ds
        // then keep their bits in f16 and none overflows; acc is rescaled
        // (exactly) when dt moves.
        float mx[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int h = c >> 1;
            const float p = exp2f(fmaf(sc[j][c], scale2, -shift2[h])) * rl[h];
            sc[j][c] = (bits >> (4 * j + c)) & 1u ? p * (dp[j][c] - dl[h]) : 0.f;
            mx[h] = fmaxf(mx[h], fabsf(sc[j][c]));
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // the row's 64 keys lie on the 4 lanes of a quad
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const int t = min(dt[h], 15 - pow2_exp(mx[h]));
          if (mx[h] > 0.f && t != dt[h]) {
            const float ratio = pow2(t - dt[h]);
#pragma unroll
            for (int n = 0; n < DC / 8; ++n) {
              acc[n][2 * h] *= ratio;
              acc[n][2 * h + 1] *= ratio;
            }
            dt[h] = t;
          }
          dsm[h] = pow2(dt[h]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        uint32_t ah[4], al[4];   // ds over keys 16kk..16kk+15: hi and lo
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int j = 2 * kk + (x >> 1), h = x & 1;
          float d2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 2 * h + e;
            if constexpr (M::kScale) {
              d2[e] = sc[j][c] * dsm[h];
            } else {
              const float p = exp2f(fmaf(sc[j][c], scale2, -shift2[h])) * rl[h];
              d2[e] = (bits >> (4 * j + c)) & 1u ? p * (dp[j][c] - dl[h]) : 0.f;
            }
          }
          split2<T>(d2[0], d2[1], ah[x], al[x]);
        }
#pragma unroll
        for (int np = 0; np < DC / 16; ++np) {
          const int bo = (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + c0 + np * 16 +
                         (lane >> 4) * 8;
          uint32_t b[4];
          ldsm_x4_t(b, Ks + bo);
          M::mma(acc[2 * np], ah, b[0], b[1]);
          M::mma(acc[2 * np + 1], ah, b[2], b[3]);
          M::mma(acc[2 * np], al, b[0], b[1]);
          M::mma(acc[2 * np + 1], al, b[2], b[3]);
        }
      }
    }
    u = u1;
    bits = bits1;
    st ^= 1;
  }
  cp_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t gi = bh * nQ + row0 + warp * 16 + g + 8 * h;
    const float un = pow2(ex[h]), ud = M::kScale ? pow2(-dt[h]) : 1.f;
#pragma unroll
    for (int n = 0; n < DC / 8; ++n)
      *reinterpret_cast<uint32_t*>(dq + gi * HD + c0 + n * 8 + 2 * tg) = pack2<T>(
          acc[n][2 * h] * ud * un * scale, acc[n][2 * h + 1] * ud * un * scale);
  }
}

// One ring stage of dK/dV: Q and m/l/delta.
template <int HD>
__host__ __device__ constexpr int dkv_mma_stage_bytes() {
  return kSub * (HD + 8) * 2 + 3 * kSub * 4;
}
// dK/dV stages dout in f32 through shared memory up to hd 128; at hd 256
// the split reads it from global memory (65,536 more bytes would not fit).
__host__ __device__ constexpr bool dkv_stages_dout(int hd) { return hd <= 128; }
template <int HD, int NW>
constexpr int dkv_mma_smem_bytes() {   // K, V; dout hi/lo; stats; dout f32; 2 stages; the walk; max
  return (2 * 16 * NW + 2 * kSub) * (HD + 8) * 2 + 3 * kSub * 4 +
         (dkv_stages_dout(HD) ? kSub * HD * 4 : 0) + 2 * dkv_mma_stage_bytes<HD>() +
         walk_smem_bytes<NW>() + NW * 4;
}

// dK/dV on the tensor cores. A block owns KB = 16 * NW keys of packed row
// r's owner tile, with K and V resident; the row's query blocks stream past
// in 64-query sub-tiles through a two-stage cp.async ring (Q, m/l/delta;
// dout in f32 through one buffer, split into hi/lo once per sub-tile), the
// next live one loading while this one computes. Warp w owns keys
// 16w..16w+15 and, per
// sub-tile, S^T = K Q^T and dP^T = V dout_hi^T + V dout_lo^T (in chunks of
// 16 queries, which bounds the registers), p^T and ds^T in registers, then
// dV += p^T dout (three terms) and dK += ds^T Q (two).
template <typename T, int HD, int NW>
__global__ void __launch_bounds__(NW * 32, min_blocks(NW, HD))
dkv_mma_kernel(const float* __restrict__ dout, const float* __restrict__ delta,
               const float* __restrict__ m, const float* __restrict__ l,
               const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const int* __restrict__ pos_q, const int* __restrict__ pos_k,
               const int* __restrict__ row_tile, const int* __restrict__ qbt,
               const int* __restrict__ flg, float* __restrict__ part_dk,
               float* __restrict__ part_dv, float* __restrict__ dk_out,
               float* __restrict__ dv_out, MaskSpec ms, int nq, int bq, int nkb, int bk,
               int R, int steps, float scale) {
  using M = Mma16<T>;
  constexpr int LD = HD + 8, KB = 16 * NW, NT = 32 * NW, KC = HD / 8;
  constexpr int DC = acc_cols(HD);
  constexpr bool kStageOf = dkv_stages_dout(HD);
  constexpr int QC = 16;   // queries per score chunk: bounds the registers
  constexpr int STAGE = dkv_mma_stage_bytes<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);   // [KB][LD], resident
  T* Vs = Ks + KB * LD;
  T* Dh = Vs + KB * LD;                     // dout hi of the current sub-tile, [kSub][LD]
  T* Dl = Dh + kSub * LD;
  float* stat = reinterpret_cast<float*>(Dl + kSub * LD);   // [3][kSub]: shift2, 1/l, delta
  float* Of = stat + 3 * kSub;                              // dout of the next sub-tile, f32
  unsigned char* ring = reinterpret_cast<unsigned char*>(Of + (kStageOf ? kSub * HD : 0));
  auto q_at = [&](int st) { return reinterpret_cast<T*>(ring + st * STAGE); };
  auto s_at = [&](int st) {   // [3][kSub]: m, l, delta
    return reinterpret_cast<float*>(ring + st * STAGE + kSub * LD * 2);
  };

  const int kslices = bk / KB;
  const int r = blockIdx.x / kslices;
  const int kofs = (blockIdx.x % kslices) * KB;   // key offset inside the tile
  const int tile = row_tile[r];
  const int key0 = tile * bk + kofs;
  const int c0 = DC == HD ? 0 : blockIdx.z * DC;   // this block's dk, dv columns
  const int64_t bh = blockIdx.y;
  const int nQ = nq * bq, nK = nkb * bk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tg = lane & 3;
  const int qs = min(kSub, bq);
  const float scale2 = scale * kLog2e;
  LiveWalk<NW> walk(ring + 2 * STAGE, pos_q, qbt + r * steps, flg + r * steps, steps, bq, qs);
  float* red = reinterpret_cast<float*>(ring + 2 * STAGE + walk_smem_bytes<NW>());   // [NW]

  {
    const T* ksrc = k + (bh * nK + key0) * HD;
    const T* vsrc = v + (bh * nK + key0) * HD;
    for (int c = tid; c < KB * KC; c += NT) {
      const int o = (c / KC) * LD + (c % KC) * 8;
      cp16(Ks + o, ksrc + c * 8);
      cp16(Vs + o, vsrc + c * 8);
    }
    cp_commit();
    // the rows a 32-query block leaves empty stay zero, their stats neutral
    for (int c = tid; c < (kSub - qs) * KC; c += NT) {
      const int o = (qs + c / KC) * LD + (c % KC) * 8;
      zero16(q_at(0) + o);
      zero16(q_at(1) + o);
      zero16(Dh + o);
      zero16(Dl + o);
    }
    for (int c = tid; c < kSub; c += NT) {
      stat[c] = 0.f;
      stat[kSub + c] = 1.f;
      stat[2 * kSub + c] = 0.f;
    }
  }
  int pk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) pk[h] = pos_k[key0 + warp * 16 + g + 8 * h];
  float dk[DC / 8][4], dv[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[n][c] = dv[n][c] = 0.f;
  int ex = 0;   // dk, dv hold their sums times 2^-ex (uniform over the block)

  // The mask on this thread's 32 positions of S^T: bit 4j + 2h + e is key
  // g + 8h of the warp's 16, query 8j + 2t + e of the sub-tile.
  auto mask = [&](const int* ps, int fl) {
    int cp[16];
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j) {
      const int2 p = *reinterpret_cast<const int2*>(ps + 8 * j + 2 * tg);
      cp[2 * j] = p.x;
      cp[2 * j + 1] = p.y;
    }
    return mask_2x16<false>(ms, pk, cp, fl);
  };
  auto load_q = [&](int st, int q0) {
    T* Qd = q_at(st);
    float* Sd = s_at(st);
    const T* qsrc = q + (bh * nQ + q0) * HD;
    for (int c = tid; c < qs * KC; c += NT) cp16(Qd + (c / KC) * LD + (c % KC) * 8, qsrc + c * 8);
    if constexpr (kStageOf) {
      const float* osrc = dout + (bh * nQ + q0) * HD;
      for (int c = tid; c < qs * HD / 4; c += NT) cp16(Of + c * 4, osrc + c * 4);
    }
    const int64_t s0 = bh * nQ + q0;
    for (int c = tid; c < 3 * (qs / 4); c += NT) {
      const int a = c / (qs / 4), o = (c % (qs / 4)) * 4;
      cp16(Sd + a * kSub + o, (a == 0 ? m : a == 1 ? l : delta) + s0 + o);
    }
    cp_commit();
  };
  // The sub-tile just arrived (queries from qstart): dout -> 2^-e dout as hi/lo
  // (in f16 e = pow2_exp of its largest |element|, one scale for the
  // sub-tile since dV and dK sum over its queries; else 0), delta -> 2^-e
  // delta, (m, l) -> (shift * log2 e, 1 / l_safe). Returns e.
  auto split = [&](int st, int qstart) {
    const float* osrc = dout + (bh * nQ + qstart) * HD;
    auto of4 = [&](int c) {   // dout's 4 elements from c * 4 of the sub-tile
      if constexpr (kStageOf) return *reinterpret_cast<const float4*>(Of + c * 4);
      else return __ldg(reinterpret_cast<const float4*>(osrc + c * 4));
    };
    int e = 0;
    if constexpr (M::kScale) {
      float mx = 0.f;
      for (int c = tid; c < qs * HD / 4; c += NT) {
        const float4 x = of4(c);
        mx = fmaxf(mx, fmaxf(fmaxf(fabsf(x.x), fabsf(x.y)), fmaxf(fabsf(x.z), fabsf(x.w))));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane == 0) red[warp] = mx;
      __syncthreads();
#pragma unroll
      for (int x = 0; x < NW; ++x) mx = fmaxf(mx, red[x]);
      e = pow2_exp(mx);
    }
    const float sc = pow2(-e);
    for (int c = tid; c < qs * HD / 4; c += NT) {
      const float4 x = of4(c);
      const int o = (c / (HD / 4)) * LD + (c % (HD / 4)) * 4;
      uint32_t h0, l0, h1, l1;
      split2<T>(x.x * sc, x.y * sc, h0, l0);
      split2<T>(x.z * sc, x.w * sc, h1, l1);
      *reinterpret_cast<uint2*>(Dh + o) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(Dl + o) = make_uint2(l0, l1);
    }
    const float* Sd = s_at(st);
    for (int c = tid; c < qs; c += NT) {
      const float mr = Sd[c], lr = Sd[kSub + c];
      stat[c] = ((mr <= kNegInf / 2) ? 0.f : mr) * kLog2e;
      stat[kSub + c] = 1.f / ((lr == 0.f) ? 1.f : lr);
      stat[2 * kSub + c] = Sd[2 * kSub + c] * sc;
    }
    return e;
  };

  int q0 = 0, st = 0;
  uint32_t bits = 0;
  int u = walk.next(mask, q0, bits);
  if (u < walk.total) load_q(0, q0);
  while (u < walk.total) {
    cp_wait<0>();
    __syncthreads();   // sub-tile u has landed; every warp is done with the last one
    const int e = split(st, q0);
    if (M::kScale && e != ex) {   // dk, dv to the new scale (exact): like terms add
      const float ratio = pow2(ex - e);
#pragma unroll
      for (int n = 0; n < DC / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          dk[n][c] *= ratio;
          dv[n][c] *= ratio;
        }
      ex = e;
    }
    uint32_t bits1 = 0;
    const int u1 = walk.next(mask, q0, bits1);
    __syncthreads();   // the split is visible and the f32 dout buffer free
    if (u1 < walk.total) load_q(st ^ 1, q0);
    if (__any_sync(0xffffffffu, bits != 0u)) {
      const T* Qs = q_at(st);
#pragma unroll
      for (int c = 0; c < kSub / QC; ++c) {
        float sc[QC / 8][4], dp[QC / 8][4];
#pragma unroll
        for (int j = 0; j < QC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
        // at hd 256 a full unroll spills ~1 KB a thread (4 rolls: ~40 B,
        // and K3 at gemma-7b's shapes 20 % faster; tools/ab_backward.py)
#pragma unroll (HD > 128 ? 4 : HD / 16)
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int ao = (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
          uint32_t a[4], av[4];
          ldsm_x4(a, Ks + ao);
          ldsm_x4(av, Vs + ao);
#pragma unroll
          for (int jp = 0; jp < QC / 16; ++jp) {
            const int bo = (c * QC + jp * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                           ((lane >> 3) & 1) * 8;
            uint32_t b[4];
            ldsm_x4(b, Qs + bo);
            M::mma(sc[2 * jp], a, b[0], b[1]);
            M::mma(sc[2 * jp + 1], a, b[2], b[3]);
            ldsm_x4(b, Dh + bo);
            M::mma(dp[2 * jp], av, b[0], b[1]);
            M::mma(dp[2 * jp + 1], av, b[2], b[3]);
            ldsm_x4(b, Dl + bo);
            M::mma(dp[2 * jp], av, b[0], b[1]);
            M::mma(dp[2 * jp + 1], av, b[2], b[3]);
          }
        }
#pragma unroll
        for (int kk = 0; kk < QC / 16; ++kk) {
          uint32_t ph[4], pl[4], dh[4], dlo[4];   // p^T, ds^T over 16 queries: hi, lo
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int j = 2 * kk + (x >> 1), h = x & 1;
            const int qi = c * QC + 8 * j + 2 * tg;
            const float2 sh = *reinterpret_cast<const float2*>(stat + qi);
            const float2 rl = *reinterpret_cast<const float2*>(stat + kSub + qi);
            const float2 dl = *reinterpret_cast<const float2*>(stat + 2 * kSub + qi);
            const uint32_t bit = bits >> (4 * (c * (QC / 8) + j) + 2 * h);
            const float e0 = exp2f(fmaf(sc[j][2 * h], scale2, -sh.x)) * rl.x;
            const float e1 = exp2f(fmaf(sc[j][2 * h + 1], scale2, -sh.y)) * rl.y;
            const float p0 = bit & 1u ? e0 : 0.f, p1 = bit & 2u ? e1 : 0.f;
            const float d0 = p0 * (dp[j][2 * h] - dl.x), d1 = p1 * (dp[j][2 * h + 1] - dl.y);
            split2<T>(p0, p1, ph[x], pl[x]);
            split2<T>(d0, d1, dh[x], dlo[x]);
          }
#pragma unroll
          for (int np = 0; np < DC / 16; ++np) {
            const int bo = (c * QC + kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + c0 +
                           np * 16 + (lane >> 4) * 8;
            uint32_t fh[4], fl[4], fq[4];
            ldsm_x4_t(fh, Dh + bo);
            ldsm_x4_t(fl, Dl + bo);
            ldsm_x4_t(fq, Qs + bo);
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              M::mma(dv[2 * np + n], ph, fh[2 * n], fh[2 * n + 1]);
              M::mma(dk[2 * np + n], dh, fq[2 * n], fq[2 * n + 1]);
            }
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              M::mma(dv[2 * np + n], ph, fl[2 * n], fl[2 * n + 1]);
              M::mma(dk[2 * np + n], dlo, fq[2 * n], fq[2 * n + 1]);
            }
#pragma unroll
            for (int n = 0; n < 2; ++n) M::mma(dv[2 * np + n], pl, fh[2 * n], fh[2 * n + 1]);
          }
        }
      }
    }
    u = u1;
    bits = bits1;
    st ^= 1;
  }
  cp_wait<0>();
  // A tile with one packed row takes its sums here; the owner-tile sum
  // adds up the rest.
  int rows = 0;
  for (int x = 0; x < R; x += NT)
    rows += __syncthreads_count(x + tid < R && __ldg(row_tile + x + tid) == tile);
  float* odk = rows == 1 ? dk_out + (bh * nK + key0) * HD : part_dk + ((bh * R + r) * bk + kofs) * HD;
  float* odv = rows == 1 ? dv_out + (bh * nK + key0) * HD : part_dv + ((bh * R + r) * bk + kofs) * HD;
  const float un = pow2(ex);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int o = (warp * 16 + g + 8 * h) * HD + c0 + 2 * tg;
#pragma unroll
    for (int n = 0; n < DC / 8; ++n) {
      *reinterpret_cast<float2*>(odk + o + n * 8) =
          make_float2(dk[n][2 * h] * un * scale, dk[n][2 * h + 1] * un * scale);
      *reinterpret_cast<float2*>(odv + o + n * 8) =
          make_float2(dv[n][2 * h] * un, dv[n][2 * h + 1] * un);
    }
  }
}

// Owner-tile sum: dk[b, t] = sum of part_dk[b, r] over the rows r with
// row_tile[r] == t, in ascending r (a fixed order: deterministic). Grid
// (nkb, B); dynamic shared memory holds the matching row list (R ints).
// skip_single: a tile with one row was written by the row walk itself.
__global__ void __launch_bounds__(kThreads)
owner_sum_kernel(const float* __restrict__ part_dk, const float* __restrict__ part_dv,
                 const int* __restrict__ row_tile, float* __restrict__ dk,
                 float* __restrict__ dv, int R, int tile_elems, int skip_single) {
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
  if (skip_single && cnt == 1) return;   // the row walk wrote this tile itself
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

template <typename T, int HD, int NW>
cudaError_t launch_dq_mma(const float* dout, const float* delta, const float* m, const float* l,
                          const void* q, const void* k, const void* v, const int* pos_q,
                          const int* pos_k, const int* kvt, const int* flg, void* dq,
                          const MaskSpec& ms, int B, int nq, int bq, int nkb, int bk, int steps,
                          float scale, cudaStream_t stream) {
  auto kern = dq_mma_kernel<T, HD, NW>;
  constexpr int smem = dq_mma_smem_bytes<HD, NW>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(nq * (bq / (16 * NW)), B, HD / acc_cols(HD));
  kern<<<grid, 32 * NW, smem, stream>>>(
      dout, delta, m, l, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos_q, pos_k, kvt, flg, static_cast<T*>(dq), ms, nq, bq, nkb,
      bk, steps, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dq(const float* dout, const float* delta, const float* m, const float* l,
                      const void* q, const void* k, const void* v, const int* pos_q,
                      const int* pos_k, const int* kvt, const int* flg, void* dq,
                      const MaskSpec& ms, int B, int nq, int bq, int nkb, int bk, int steps,
                      float scale, cudaStream_t stream) {
  if constexpr (!std::is_same_v<T, float>) {
#define SALO_DQ_MMA(NW)                                                                     \
  launch_dq_mma<T, HD, NW>(dout, delta, m, l, q, k, v, pos_q, pos_k, kvt, flg, dq, ms, B, nq, \
                           bq, nkb, bk, steps, scale, stream)
    if constexpr (HD > 128) {
      return SALO_DQ_MMA(2);   // 189,976 bytes of shared memory
    } else {
      switch (warps_for(bq)) {
        case 2: return SALO_DQ_MMA(2);
        case 4: return SALO_DQ_MMA(4);
        default: return SALO_DQ_MMA(kMaxWarps);
      }
    }
#undef SALO_DQ_MMA
  } else {
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
}

template <typename T, int HD, int NW>
cudaError_t launch_dkv_mma(const float* dout, const float* delta, const float* m,
                           const float* l, const void* q, const void* k, const void* v,
                           const int* pos_q, const int* pos_k, const int* row_tile,
                           const int* qbt, const int* flg, float* part_dk, float* part_dv,
                           float* dk, float* dv, const MaskSpec& ms, int B, int nq, int bq,
                           int nkb, int bk, int R, int steps, float scale, cudaStream_t stream) {
  auto kern = dkv_mma_kernel<T, HD, NW>;
  constexpr int smem = dkv_mma_smem_bytes<HD, NW>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(R * (bk / (16 * NW)), B, HD / acc_cols(HD));
  kern<<<grid, 32 * NW, smem, stream>>>(
      dout, delta, m, l, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos_q, pos_k, row_tile, qbt, flg, part_dk, part_dv, dk, dv, ms,
      nq, bq, nkb, bk, R, steps, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const float* dout, const float* delta, const float* m, const float* l,
                       const void* q, const void* k, const void* v, const int* pos_q,
                       const int* pos_k, const int* row_tile, const int* qbt, const int* flg,
                       float* part_dk, float* part_dv, float* dk, float* dv,
                       const MaskSpec& ms, int B, int nq, int bq, int nkb, int bk, int R,
                       int steps, float scale, cudaStream_t stream) {
  cudaError_t e;
  if constexpr (!std::is_same_v<T, float>) {
#define SALO_DKV_MMA(NW)                                                                   \
  launch_dkv_mma<T, HD, NW>(dout, delta, m, l, q, k, v, pos_q, pos_k, row_tile, qbt, flg,  \
                            part_dk, part_dv, dk, dv, ms, B, nq, bq, nkb, bk, R, steps,   \
                            scale, stream)
    if constexpr (HD > 128)   // 4 warps at most: 211,256 bytes of shared memory
      e = warps_for(bk) == 2 ? SALO_DKV_MMA(2) : SALO_DKV_MMA(4);
    else
      switch (warps_for(bk)) {
        case 2: e = SALO_DKV_MMA(2); break;
        case 4: e = SALO_DKV_MMA(4); break;
        default: e = SALO_DKV_MMA(kMaxWarps);
      }
#undef SALO_DKV_MMA
  } else {
    auto kern = dkv_kernel<T, HD>;
    constexpr int smem = dkv_smem_bytes<HD>();
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    dim3 grid(R * (bk / min(kKeys, bk)), B);
    kern<<<grid, kThreads, smem, stream>>>(
        dout, delta, m, l, static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), pos_q, pos_k, row_tile, qbt, flg, part_dk, part_dv, ms, nq,
        bq, nkb, bk, R, steps, scale);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess) return e;
  const size_t rows_bytes = (size_t)R * sizeof(int);
  if (rows_bytes > 48 * 1024) return cudaErrorInvalidValue;
  owner_sum_kernel<<<dim3(nkb, B), kThreads, rows_bytes, stream>>>(
      part_dk, part_dv, row_tile, dk, dv, R, bk * HD, !std::is_same_v<T, float>);
  return cudaGetLastError();
}

bool block_ok(int b) { return b == 32 || b == 64 || b == 128 || b == 256; }

// The dynamic shared memory of K2 (kernel 0) or K3's row walk (kernel 1),
// as their launchers instantiate them: f32 (nw 0), or 16-bit with nw warps
// (2, 4, 8 up to hd 128; K2 2 and K3 2 or 4 at hd 256); -1 otherwise.
template <int HD>
int smem_of(int kernel, int dtype, int nw) {
  const bool wide = HD > 128;
  if (dtype == 0) {
    if (nw != 0) return -1;
    return kernel == 0 ? dq_smem_bytes<HD>() : dkv_smem_bytes<HD>();
  }
  if (dtype != 1 && dtype != 2) return -1;
  if (kernel == 0) {
    if (wide) return nw == 2 ? dq_mma_smem_bytes<HD, 2>() : -1;
    switch (nw) {
      case 2: return dq_mma_smem_bytes<HD, 2>();
      case 4: return dq_mma_smem_bytes<HD, 4>();
      case kMaxWarps: return dq_mma_smem_bytes<HD, kMaxWarps>();
      default: return -1;
    }
  }
  switch (nw) {
    case 2: return dkv_mma_smem_bytes<HD, 2>();
    case 4: return dkv_mma_smem_bytes<HD, 4>();
    case kMaxWarps: return wide ? -1 : dkv_mma_smem_bytes<HD, kMaxWarps>();
    default: return -1;
  }
}

// mask_2x16 against step_mask pair by pair, one thread per unit u: rows
// rp[2u..2u+1], columns cp[16u..16u+15], flags fl[u]. fast[u] gets
// mask_2x16's bits, ref[u] step_mask's in the same order.
template <bool kRowsQ>
__global__ void mask_check_kernel(MaskSpec ms, const int* __restrict__ rp,
                                  const int* __restrict__ cp, const int* __restrict__ fl, int n,
                                  uint32_t* __restrict__ fast, uint32_t* __restrict__ ref) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= n) return;
  int r[2], c[16];
#pragma unroll
  for (int h = 0; h < 2; ++h) r[h] = rp[2 * u + h];
#pragma unroll
  for (int j = 0; j < 16; ++j) c[j] = cp[16 * u + j];
  fast[u] = mask_2x16<kRowsQ>(ms, r, c, fl[u]);
  uint32_t b = 0;
  for (int j = 0; j < 16; ++j)
    for (int h = 0; h < 2; ++h) {
      const bool on = kRowsQ ? step_mask(ms, r[h], c[j], fl[u]) : step_mask(ms, c[j], r[h], fl[u]);
      b |= static_cast<uint32_t>(on) << (4 * (j >> 1) + 2 * h + (j & 1));
    }
  ref[u] = b;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (of q, k, v; dout, delta,
// m, l are f32); hd in {64, 128, 256}; block_q, block_k in {32, 64, 128, 256}.
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
#define SALO_DQ_HD(T) \
  (hd == 64 ? SALO_DQ(T, 64) : hd == 128 ? SALO_DQ(T, 128) : SALO_DQ(T, 256))
  if (hd != 64 && hd != 128 && hd != 256) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)SALO_DQ_HD(float);
    case 1: return (int)SALO_DQ_HD(__nv_bfloat16);
    case 2: return (int)SALO_DQ_HD(__half);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SALO_DQ_HD
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
#define SALO_DKV_HD(T) \
  (hd == 64 ? SALO_DKV(T, 64) : hd == 128 ? SALO_DKV(T, 128) : SALO_DKV(T, 256))
  if (hd != 64 && hd != 128 && hd != 256) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)SALO_DKV_HD(float);
    case 1: return (int)SALO_DKV_HD(__nv_bfloat16);
    case 2: return (int)SALO_DKV_HD(__half);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SALO_DKV_HD
#undef SALO_DKV
}

// The check of the 16-bit kernels' mask evaluator (tests/test_torch_cuda.py):
// n units of int32 rows rp (n, 2), columns cp (n, 16) and flags fl (n,);
// fast, ref: (n,) uint32 (see mask_check_kernel). rows_q: the rows are
// queries (as in dQ), else keys (as in dK/dV).
int salo_mask_2x16_check(const MaskSpec* ms, const void* rp, const void* cp, const void* fl,
                         void* fast, void* ref, int n, int rows_q, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int* r = static_cast<const int*>(rp);
  const int* c = static_cast<const int*>(cp);
  const int* f = static_cast<const int*>(fl);
  uint32_t* a = static_cast<uint32_t*>(fast);
  uint32_t* b = static_cast<uint32_t*>(ref);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + 127) / 128;
  if (rows_q)
    mask_check_kernel<true><<<blocks, 128, 0, st>>>(*ms, r, c, f, n, a, b);
  else
    mask_check_kernel<false><<<blocks, 128, 0, st>>>(*ms, r, c, f, n, a, b);
  return (int)cudaGetLastError();
}

// Shared memory, in bytes, of kernel 0 (K2, dynamic), 1 (K3's row walk,
// dynamic) or 2 (the owner-tile sum's static part, from the compiled
// kernel; its dynamic part is R ints, refused above 48 KiB) for dtype, hd
// and nw warps; -1 where none is instantiated or on an error.
// analysis/smem_budget.py mirrors these sizes (k2_bytes, k3_bytes,
// OWNER_SUM_STATIC).
int salo_table_backward_smem(int kernel, int dtype, int hd, int nw) {
  if (kernel == 2) {
    cudaFuncAttributes a;
    return cudaFuncGetAttributes(&a, owner_sum_kernel) == cudaSuccess ? (int)a.sharedSizeBytes
                                                                      : -1;
  }
  if (kernel != 0 && kernel != 1) return -1;
  switch (hd) {
    case 64: return smem_of<64>(kernel, dtype, nw);
    case 128: return smem_of<128>(kernel, dtype, nw);
    case 256: return smem_of<256>(kernel, dtype, nw);
    default: return -1;
  }
}

const char* salo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
