// SALO table-driven hybrid sparse attention, forward (K1), for Hopper
// (sm_90a), CUDA C++ with a plain C interface (loaded through ctypes by
// repro_torch/kernels/_build.py).
//
// Replaces the TPU kernel repro/kernels/salo_attention.py::
// salo_table_attention (body _kernel): one launch executes a whole
// ExecutionPlan. Query block i visits KV tile kvt[i*steps + s] at step s,
// masked by BandSchedule.step_mask on ORIGINAL positions (flag bit 1 =
// window, bit 2 = global column, 0 = padding, skipped), folded through the
// online softmax with the guarded NEG_INF/2 shift. p is rounded to V's type
// before the PV product while l sums the f32 p (as the TPU kernel does);
// the kernel writes out = acc / (l == 0 ? 1 : l) in q's type and the f32
// row stats m, l. A row that attends nothing gives (0, NEG_INF, 0).
//
// Bound on this card: operations. Each attended pair costs 4 x hd flops
// (q.k^T and p.v) against q, k, v, out read or written once; at the
// training shapes (hd 64, 256-wide tiles, ~1e3 attended keys a query) the
// flops at the 16-bit tensor rate take longer than the bytes at the memory
// rate. The 16-bit kernel runs both products on the tensor cores; it
// executes whole 16-row x 64-key warp sub-tiles, so on a band's edge it
// runs more flops than the pairs need. The f32 instantiation runs the
// exact CUDA-core kernel (f32 FMA, no TF32), far below that rate.
//
// Design, 16-bit inputs (table_attention_mma_kernel): FlashAttention-2's
// forward over the plan's step tables. A block owns 16 x NW rows of one
// plan query block (NW warps, a warp 16 rows; NW = 2, 4, 8 for blocks of
// 32, 64, >= 128) and never straddles it. Q's mma fragments are loaded once
// into registers (at hd <= 128). At hd 256 a warp's Q fragments (64
// registers) and its 16 x 256 accumulator (128) do not fit beside the
// scores, so the accumulated columns are split over blocks: blockIdx.z
// takes hd columns [128z, 128z + 128) of out (acc 64 registers), loads only
// those columns of V, and rereads Q's fragments from shared memory with
// ldmatrix per sub-tile, as FlashAttention-2 does at hd 256. Both blocks of
// a row compute the same scores and row stats in the same order (the
// z = 0 block writes m, l), so the split changes no number; it runs the
// score product and the fold twice. Each step's KV tile is walked in
// 64-key sub-tiles through a two-stage cp.async ring: the mask walk
// (LiveWalk, salo_mma.cuh)
// evaluates step_mask (as mask_2x16) on the 32 score positions each thread
// owns, from the positions alone, before the sub-tile's loads are issued,
// and the block skips a sub-tile in which no pair survives; the next live
// sub-tile loads while this one computes. A warp skips its products where
// none of its own pairs survives. Per sub-tile a warp runs S = Q.K^T on
// mma.sync.m16n8k16 (f32 accumulator) with K through ldmatrix, masks the C
// fragments (not at all where every pair of the warp survives, as inside a
// band), takes each row's max over the 4 lanes of a quad, and folds the
// sub-tile into (acc, m, l): 2^x on the special-function unit (ex2.approx)
// with log2(e) folded into the scale and the shift; the mask and the exp
// cost more than either product (PERF.md). p's C fragments, rounded
// to V's type and packed in pairs,
// become the A fragments of P.V (V through ldmatrix.trans), with no
// shared-memory round trip. Numerics as the reference's: m is kept in
// natural units (the max of the scaled scores: scale > 0, so max(rn(s *
// scale)) = rn(max(s) * scale)), l sums the f32 p (each thread its 16 keys
// of a sub-tile, the quad summed at the end), the PV product takes p
// rounded to V's type, and the guarded shift and correction leave a
// skipped sub-tile, or a row with no pair in it, exactly as it was.
//
// Design, f32 inputs (table_attention_kernel): a block takes a 64-row
// slice of a plan query block (grid: slices x nq x B·H) and walks each
// step's KV tile in 64-key sub-tiles, carrying (acc, m, l) across them in
// registers. The tables are read from global memory by the block itself
// (no scalar prefetch). Per sub-tile: stage K transposed and V row-major in
// shared memory; each of 256 threads owns a 4 x 4 block of the 64 x 64
// score tile (float4 reads of the transposed Q and K), evaluates the mask
// first and the block skips a sub-tile where no pair survives (the causal
// tile past the diagonal, the window's edge); the half-warp of a row
// reduces the row max and sum with shuffles; p goes through shared memory
// to the PV product, where each thread owns 4 rows x hd/16 columns of acc.
// The skip is exact: a masked sub-tile leaves (acc, m, l) unchanged. At hd
// 256 the staged tiles take 223,488 of the 232,448 bytes a block may have:
// one block an SM.
#include <type_traits>

#include "salo_mma.cuh"

namespace {

using namespace salo;

constexpr int kRowsPerBlock = 64;   // query rows of one block (a plan-block slice)
constexpr int kKeys = 64;           // keys per sub-tile
constexpr int kLdT = 68;            // leading dim of transposed / 64-wide tiles

template <int HD>
constexpr int smem_bytes() {
  return (2 * HD * kLdT + kKeys * (HD + 4) + kRowsPerBlock * kLdT) * 4 + kKeys * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
table_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ pos_q,
                       const int* __restrict__ pos_k, const int* __restrict__ kvt,
                       const int* __restrict__ flg, T* __restrict__ out,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       MaskSpec ms, int nq, int bq, int nkb, int bk, int steps,
                       float scale) {
  constexpr int LDR = HD + 4;
  constexpr int NU = HD / 64;             // float4 column groups per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                       // [HD][kLdT]
  float* Kt = Qt + HD * kLdT;             // [HD][kLdT]
  float* Vs = Kt + HD * kLdT;             // [kKeys][LDR]
  float* Ps = Vs + kKeys * LDR;           // [kRowsPerBlock][kLdT]
  int* pk = reinterpret_cast<int*>(Ps + kRowsPerBlock * kLdT);   // [kKeys]

  const int rq = min(kRowsPerBlock, bq);  // valid rows of this slice
  const int ks = min(kKeys, bk);          // valid keys of a sub-tile
  const int slices = bq / rq;
  const int i = blockIdx.x / slices;      // plan query block
  const int row0 = i * bq + (blockIdx.x % slices) * rq;
  const int64_t bh = blockIdx.y;
  const int nQ = nq * bq, nK = nkb * bk;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  stage_t<T, HD>(Qt, kLdT, q + (bh * nQ + row0) * HD, kRowsPerBlock, rq);
  int pq[4];
  float m_run[4], l_run[4], acc[4][4 * NU];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty * 4 + r;
    pq[r] = row < rq ? pos_q[row0 + row] : kBig;
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NU; ++c) acc[r][c] = 0.f;
  }

  for (int s = 0; s < steps; ++s) {
    const int fl = flg[i * steps + s];
    if (fl == 0) continue;                // padding step: a no-op
    const int tile = kvt[i * steps + s];
    for (int sub = 0; sub < bk / ks; ++sub) {
      const int key0 = tile * bk + sub * ks;
      __syncthreads();                    // the previous sub-tile is consumed
      stage_t<T, HD>(Kt, kLdT, k + (bh * nK + key0) * HD, kKeys, ks);
      stage_r<T, HD>(Vs, LDR, v + (bh * nK + key0) * HD, kKeys, ks);
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
      if (!__syncthreads_or(any)) continue;   // no pair survives: identity

      float sc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(Qt + d * kLdT + ty * 4);
        const float4 b = *reinterpret_cast<const float4*>(Kt + d * kLdT + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[r][c] = fmaf(av[r], bv[c], sc[r][c]);
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float mt = kNegInf;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          sc[r][c] = mk[r][c] ? sc[r][c] * scale : kNegInf;
          mt = fmaxf(mt, sc[r][c]);
        }
        mt = half_warp_max(mt);
        const float m_new = fmaxf(m_run[r], mt);
        const float shift = (m_new <= kNegInf / 2) ? 0.f : m_new;
        float sum = 0.f;
        float pr[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = mk[r][c] ? expf(sc[r][c] - shift) : 0.f;
          sum += p;
          pr[c] = to_f32(from_f32<T>(p));     // p in V's type for the PV product
        }
        sum = half_warp_sum(sum);
        const float corr = (m_run[r] <= kNegInf / 2) ? 0.f : expf(m_run[r] - shift);
        l_run[r] = l_run[r] * corr + sum;
        m_run[r] = m_new;
#pragma unroll
        for (int c = 0; c < 4 * NU; ++c) acc[r][c] *= corr;
        *reinterpret_cast<float4*>(Ps + (ty * 4 + r) * kLdT + tx * 4) =
            make_float4(pr[0], pr[1], pr[2], pr[3]);
      }
      __syncthreads();

      for (int j = 0; j < ks; ++j) {
        float pj[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) pj[r] = Ps[(ty * 4 + r) * kLdT + j];
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          const float4 vv = *reinterpret_cast<const float4*>(Vs + j * LDR + u * 64 + tx * 4);
          const float vf[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[r][u * 4 + e] = fmaf(pj[r], vf[e], acc[r][u * 4 + e]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty * 4 + r;
    if (row >= rq) continue;
    const int64_t g = bh * nQ + row0 + row;
    const float l = l_run[r] == 0.f ? 1.f : l_run[r];
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[g * HD + u * 64 + tx * 4 + e] = from_f32<T>(acc[r][u * 4 + e] / l);
    if (tx == 0) {
      m_out[g] = m_run[r];
      l_out[g] = l_run[r];
    }
  }
}

// ------------------- 16-bit inputs: the tensor-core path ------------------ //
template <int HD, int NW>
constexpr int mma_smem_bytes() {   // Q; 2 stages of K and V's columns; the walk
  return (16 * NW * (HD + 8) + 2 * kSub * (HD + 8) + 2 * kSub * (acc_cols(HD) + 8)) * 2 +
         walk_smem_bytes<NW>();
}

// 2^x on the special-function unit (results below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The forward on the tensor cores (see the note at the head of this file).
// Warp w owns rows 16w..16w+15 of the block; the thread holds, per sub-tile,
// the scores of rows g, g + 8 (h = 0, 1) at keys 8j + 2t + (0, 1), and acc
// of those rows at columns 8n + 2t + (0, 1).
template <typename T, int HD, int NW>
__global__ void __launch_bounds__(NW * 32, min_blocks(NW, HD))
table_attention_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const int* __restrict__ pos_q,
                           const int* __restrict__ pos_k, const int* __restrict__ kvt,
                           const int* __restrict__ flg, T* __restrict__ out,
                           float* __restrict__ m_out, float* __restrict__ l_out, MaskSpec ms,
                           int nq, int bq, int nkb, int bk, int steps, float scale) {
  using M = Mma16<T>;
  constexpr int LD = HD + 8, RB = 16 * NW, NT = 32 * NW, KC = HD / 8;
  constexpr int DC = acc_cols(HD), LDV = DC + 8, VC = DC / 8;
  constexpr bool kQRegs = DC == HD;   // else Q is reread from shared memory
  constexpr int STAGE = kSub * (LD + LDV);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [RB][LD]
  T* ring = Qs + RB * LD;   // stage st: K [kSub][LD], then V's columns [kSub][LDV]

  const int c0 = kQRegs ? 0 : blockIdx.z * DC;   // this block's out columns
  const int slices = bq / RB;
  const int i = blockIdx.x / slices;
  const int row0 = i * bq + (blockIdx.x % slices) * RB;
  const int64_t bh = blockIdx.y;
  const int nQ = nq * bq, nK = nkb * bk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tg = lane & 3;
  const int ks = min(kSub, bk);
  LiveWalk<NW> walk(reinterpret_cast<unsigned char*>(ring + 2 * STAGE), pos_k,
                    kvt + i * steps, flg + i * steps, steps, bk, ks);

  {
    const T* src = q + (bh * nQ + row0) * HD;
    for (int c = tid; c < RB * KC; c += NT) cp16(Qs + (c / KC) * LD + (c % KC) * 8, src + c * 8);
    cp_commit();
    // the rows a 32-key tile leaves empty stay zero (0 * 0, never 0 * NaN)
    if constexpr (kQRegs) {   // K and V rows alike: 4 tiles of [kSub][LD]
      const int tail = (kSub - ks) * KC;
      for (int c = tid; c < 4 * tail; c += NT)
        zero16(ring + (c / tail) * kSub * LD + (ks + (c % tail) / KC) * LD + (c % KC) * 8);
    } else {
      const int tail = kSub - ks;
      for (int c = tid; c < 2 * tail * KC; c += NT) {
        const int x = c % (tail * KC);
        zero16(ring + (c / (tail * KC)) * STAGE + (ks + x / KC) * LD + (x % KC) * 8);
      }
      for (int c = tid; c < 2 * tail * VC; c += NT) {
        const int x = c % (tail * VC);
        zero16(ring + (c / (tail * VC)) * STAGE + kSub * LD + (ks + x / VC) * LDV +
               (x % VC) * 8);
      }
    }
    cp_wait<0>();
    __syncthreads();
  }
  // the warp's Q as A fragments, over hd in steps of 16 (at hd <= 128)
  uint32_t qa[kQRegs ? HD / 16 : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ldsm_x4(qa[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
  }

  // p = exp(s * scale - shift) as 2^(s * scale2 - shift * log2(e))
  const float scale2 = scale * kLog2e;
  int pq[2];
  float m_run[2], l_run[2];   // l_run: the sum over this thread's keys only
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pq[h] = pos_q[row0 + warp * 16 + g + 8 * h];
    m_run[h] = kNegInf;
    l_run[h] = 0.f;
  }
  float acc[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

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
    T* Kd = ring + st * STAGE;
    T* Vd = Kd + kSub * LD;
    const T* ksrc = k + (bh * nK + key0) * HD;
    const T* vsrc = v + (bh * nK + key0) * HD + c0;
    if constexpr (kQRegs) {   // all of V's columns: one loop for K and V
      for (int c = tid; c < ks * KC; c += NT) {
        const int o = (c / KC) * LD + (c % KC) * 8;
        cp16(Kd + o, ksrc + c * 8);
        cp16(Vd + o, vsrc + c * 8);
      }
    } else {
      for (int c = tid; c < ks * KC; c += NT)
        cp16(Kd + (c / KC) * LD + (c % KC) * 8, ksrc + c * 8);
      for (int c = tid; c < ks * VC; c += NT)
        cp16(Vd + (c / VC) * LDV + (c % VC) * 8, vsrc + (c / VC) * HD + (c % VC) * 8);
    }
    cp_commit();
  };

  // Fold a sub-tile's scores sc into (acc, m, l) and leave p in sc: the
  // scores of the pairs whose bit is set, or of all pairs when kAll.
  auto fold = [&](float (&sc)[kSub / 8][4], uint32_t bits, auto all) {
    constexpr bool kAll = decltype(all)::value;
    const auto on = [&](int j, int c) { return kAll || ((bits >> (4 * j + c)) & 1u); };
    // each row's max over its surviving pairs, on the 4 lanes of a quad
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (on(j, c)) mx[c >> 1] = fmaxf(mx[c >> 1], sc[j][c]);
    float corr[2], shift2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mt = mx[h] == kNegInf ? kNegInf : mx[h] * scale;
      const float m_new = fmaxf(m_run[h], mt);
      const float shift = (m_new <= kNegInf / 2) ? 0.f : m_new;
      corr[h] = (m_run[h] <= kNegInf / 2) ? 0.f : ex2((m_run[h] - shift) * kLog2e);
      shift2[h] = shift * kLog2e;
      m_run[h] = m_new;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = c >> 1;
        const float p = on(j, c) ? ex2(fmaf(sc[j][c], scale2, -shift2[h])) : 0.f;
        sc[j][c] = p;
        ls[h] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * corr[h] + ls[h];
#pragma unroll
    for (int n = 0; n < DC / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
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
      const T* Ks = ring + st * STAGE;
      const T* Vs = Ks + kSub * LD;
      float sc[kSub / 8][4];
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[j][c] = 0.f;
      // S over hd in steps of 16, with the warp's Q fragment a for step kk
      auto scores = [&](const uint32_t(&a)[4], int kk) {
#pragma unroll
        for (int jp = 0; jp < kSub / 16; ++jp) {
          const int bo = (jp * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                         ((lane >> 3) & 1) * 8;
          uint32_t b[4];
          ldsm_x4(b, Ks + bo);
          M::mma(sc[2 * jp], a, b[0], b[1]);
          M::mma(sc[2 * jp + 1], a, b[2], b[3]);
        }
      };
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        if constexpr (kQRegs) {
          scores(qa[kk], kk);
        } else {
          uint32_t a[4];
          ldsm_x4(a, Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
          scores(a, kk);
        }
      }
      // inside a band every pair of the warp survives: no mask to apply
      if (__all_sync(0xffffffffu, bits == ~0u))
        fold(sc, bits, std::true_type{});
      else
        fold(sc, bits, std::false_type{});
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        uint32_t a[4];   // p over keys 16kk..16kk+15 in V's type
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int j = 2 * kk + (x >> 1), h = x & 1;
          a[x] = pack2<T>(sc[j][2 * h], sc[j][2 * h + 1]);
        }
#pragma unroll
        for (int np = 0; np < DC / 16; ++np) {
          const int bo = (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDV + np * 16 +
                         (lane >> 4) * 8;
          uint32_t b[4];
          ldsm_x4_t(b, Vs + bo);
          M::mma(acc[2 * np], a, b[0], b[1]);
          M::mma(acc[2 * np + 1], a, b[2], b[3]);
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
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_safe = l == 0.f ? 1.f : l;
    const int64_t gi = bh * nQ + row0 + warp * 16 + g + 8 * h;
#pragma unroll
    for (int n = 0; n < DC / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + gi * HD + c0 + n * 8 + 2 * tg) =
          pack2<T>(acc[n][2 * h] / l_safe, acc[n][2 * h + 1] / l_safe);
    if (tg == 0 && (kQRegs || blockIdx.z == 0)) {
      m_out[gi] = m_run[h];
      l_out[gi] = l;
    }
  }
}

template <typename T, int HD, int NW>
cudaError_t launch_mma(const T* q, const T* k, const T* v, const int* pos_q, const int* pos_k,
                       const int* kvt, const int* flg, T* out, float* m, float* l,
                       const MaskSpec& ms, int B, int nq, int bq, int nkb, int bk, int steps,
                       float scale, cudaStream_t stream) {
  auto kern = table_attention_mma_kernel<T, HD, NW>;
  constexpr int smem = mma_smem_bytes<HD, NW>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(nq * (bq / (16 * NW)), B, HD / acc_cols(HD));
  kern<<<grid, 32 * NW, smem, stream>>>(q, k, v, pos_q, pos_k, kvt, flg, out, m, l, ms, nq, bq,
                                        nkb, bk, steps, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pos_q,
                   const int* pos_k, const int* kvt, const int* flg, void* out,
                   float* m, float* l, const MaskSpec& ms, int B, int nq, int bq,
                   int nkb, int bk, int steps, float scale, cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  T* to = static_cast<T*>(out);
  if constexpr (!std::is_same_v<T, float>) {
#define SALO_MMA(NW)                                                                         \
  launch_mma<T, HD, NW>(tq, tk, tv, pos_q, pos_k, kvt, flg, to, m, l, ms, B, nq, bq, nkb, bk, \
                        steps, scale, stream)
    switch (warps_for(bq)) {
      case 2: return SALO_MMA(2);
      case 4: return SALO_MMA(4);
      default: return SALO_MMA(kMaxWarps);
    }
#undef SALO_MMA
  } else {
    auto kern = table_attention_kernel<T, HD>;
    constexpr int smem = smem_bytes<HD>();
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    dim3 grid(nq * (bq / min(kRowsPerBlock, bq)), B);
    kern<<<grid, kThreads, smem, stream>>>(tq, tk, tv, pos_q, pos_k, kvt, flg, to, m, l, ms, nq,
                                           bq, nkb, bk, steps, scale);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const int* pos_q, const int* pos_k, const int* kvt, const int* flg,
                        void* out, float* m, float* l, const MaskSpec& ms, int B, int nq,
                        int bq, int nkb, int bk, int steps, float scale, cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, pos_q, pos_k, kvt, flg, out, m, l, ms, B, nq, bq, nkb,
                           bk, steps, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, pos_q, pos_k, kvt, flg, out, m, l, ms, B, nq, bq, nkb,
                            bk, steps, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, pos_q, pos_k, kvt, flg, out, m, l, ms, B, nq, bq, nkb,
                            bk, steps, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

bool block_ok(int b) { return b == 32 || b == 64 || b == 128 || b == 256; }

template <int HD>
int smem_of(int dtype, int nw) {
  if (dtype == 0) return nw == 0 ? smem_bytes<HD>() : -1;
  if (dtype != 1 && dtype != 2) return -1;
  switch (nw) {
    case 2: return mma_smem_bytes<HD, 2>();
    case 4: return mma_smem_bytes<HD, 4>();
    case kMaxWarps: return mma_smem_bytes<HD, kMaxWarps>();
    default: return -1;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; hd in {64, 128, 256}; block_q,
// block_k in {32, 64, 128, 256}. q: (B, nq*bq, hd); k, v: (B, nkb*bk, hd);
// pos_q: (nq*bq,), pos_k: (nkb*bk,), kvt, flg: (nq*steps,) int32; out like
// q; m, l: (B, nq*bq) f32. All 16-byte aligned and contiguous (the wrapper
// checks). Returns cudaGetLastError() after the launch (0 = success); the
// launch is asynchronous on `stream`.
int salo_table_attention(int dtype, int hd, const void* q, const void* k, const void* v,
                         const void* pos_q, const void* pos_k, const void* kvt,
                         const void* flg, void* out, void* m, void* l, const MaskSpec* ms,
                         int B, int nq, int bq, int nkb, int bk, int steps, float scale,
                         void* stream) {
  if (B <= 0 || nq <= 0 || nkb <= 0 || steps <= 0 || !block_ok(bq) || !block_ok(bk))
    return (int)cudaErrorInvalidValue;
  const int* pq = static_cast<const int*>(pos_q);
  const int* pk = static_cast<const int*>(pos_k);
  const int* kt = static_cast<const int*>(kvt);
  const int* fl = static_cast<const int*>(flg);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch_hd<float>(hd, q, k, v, pq, pk, kt, fl, out, mf, lf, *ms, B, nq, bq,
                                     nkb, bk, steps, scale, s);
    case 1:
      return (int)dispatch_hd<__nv_bfloat16>(hd, q, k, v, pq, pk, kt, fl, out, mf, lf, *ms, B,
                                             nq, bq, nkb, bk, steps, scale, s);
    case 2:
      return (int)dispatch_hd<__half>(hd, q, k, v, pq, pk, kt, fl, out, mf, lf, *ms, B, nq,
                                      bq, nkb, bk, steps, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory one block of the forward asks for, in bytes:
// dtype 0 (f32, nw 0) smem_bytes<HD>; dtype 1 or 2 (16-bit) with nw warps
// in {2, 4, 8} mma_smem_bytes<HD, nw>; -1 where none is instantiated.
// analysis/smem_budget.py mirrors these sizes (k1_bytes).
int salo_table_attention_smem(int dtype, int hd, int nw) {
  switch (hd) {
    case 64: return smem_of<64>(dtype, nw);
    case 128: return smem_of<128>(dtype, nw);
    case 256: return smem_of<256>(dtype, nw);
    default: return -1;
  }
}

const char* salo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
