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
// Bound on this card: at the training shapes (hd 64, 256-wide tiles) the
// work is ~4*hd flops per attended pair over ~1e3 attended keys per query,
// far above the bytes of q, k, v, out (each read or written once): so
// operations. This first version does the products on the CUDA cores in
// f32 FMA (exact for f32 inputs, no TF32), so it runs far below the bf16
// tensor-core peak; a wgmma version is later work.
//
// Design: the TPU kernel keeps a whole 256 x 256 f32 score tile in VMEM;
// that is 256 KB, more than a block's 227 KB of shared memory. So a block
// takes a 64-row slice of a plan query block (grid: slices x nq x B·H) and
// walks each step's KV tile in 64-key sub-tiles, carrying (acc, m, l)
// across them in registers. The tables are read from global memory by the
// block itself (no scalar prefetch). Per sub-tile: stage K transposed and V
// row-major in shared memory as f32; each of 256 threads owns a 4 x 4
// block of the 64 x 64 score tile (float4 reads of the transposed Q and K),
// evaluates the mask first and the block skips a sub-tile where no pair
// survives (the causal tile past the diagonal, the window's edge); the
// half-warp of a row reduces the row max and sum with shuffles; p goes
// through shared memory to the PV product, where each thread owns 4 rows x
// hd/16 columns of acc. The skip is exact: a masked sub-tile leaves
// (acc, m, l) unchanged.
#include "salo_common.cuh"

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

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pos_q,
                   const int* pos_k, const int* kvt, const int* flg, void* out,
                   float* m, float* l, const MaskSpec& ms, int B, int nq, int bq,
                   int nkb, int bk, int steps, float scale, cudaStream_t stream) {
  auto kern = table_attention_kernel<T, HD>;
  constexpr int smem = smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int slices = bq / min(kRowsPerBlock, bq);
  dim3 grid(nq * slices, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos_q,
      pos_k, kvt, flg, static_cast<T*>(out), m, l, ms, nq, bq, nkb, bk, steps, scale);
  return cudaGetLastError();
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
    default:
      return cudaErrorInvalidValue;
  }
}

bool block_ok(int b) { return b == 32 || b == 64 || b == 128 || b == 256; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; hd in {64, 128}; block_q,
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

const char* salo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
