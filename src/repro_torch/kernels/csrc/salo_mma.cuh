// Warp-level tensor-core building blocks for the 16-bit training kernels
// (salo_table_attention.cu, salo_table_backward.cu): mma.sync m16n8k16 with
// an f32 accumulator, ldmatrix (plain and transposed), cp.async, the hi/lo
// split that carries an f32 operand through the 16-bit tensor cores and the
// power-of-two scaling ahead of it, the blocks' warp counts and the walk
// over the live sub-tiles of a table row.
//
// Fragment layout of mma.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4): A (16 x 16, row-major) a[0] = (g, 2t..2t+1), a[1] =
// (g+8, 2t..), a[2] = (g, 2t+8..), a[3] = (g+8, 2t+8..); B (16 x 8, k x n)
// b[0] = (k 2t..2t+1, n g), b[1] = (k 2t+8.., n g); C (16 x 8, f32) c[0..1]
// = (g, 2t..2t+1), c[2..3] = (g+8, 2t..). So the C fragments of two
// neighbouring n-tiles are, packed in pairs, the A fragment of a product
// over their 16 columns: the register reuse of FlashAttention-2.
#pragma once

#include "salo_common.cuh"

namespace salo {

// The 16-bit types as the tensor cores take them.
template <typename T> struct Mma16;

// kScale: whether the kernels scale dout by a power of two before the
// split (see pow2_exp below). bf16 has f32's exponent range, where the
// scale would give the same bits, so only f16 takes it.
template <> struct Mma16<__nv_bfloat16> {
  using T2 = __nv_bfloat162;
  static constexpr bool kScale = false;
  static __device__ __forceinline__ T2 rn2(float a, float b) { return __floats2bfloat162_rn(a, b); }
  static __device__ __forceinline__ float2 f2(T2 x) { return __bfloat1622float2(x); }
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <> struct Mma16<__half> {
  using T2 = __half2;
  static constexpr bool kScale = true;
  static __device__ __forceinline__ T2 rn2(float a, float b) { return __floats2half2_rn(a, b); }
  static __device__ __forceinline__ float2 f2(T2 x) { return __half22float2(x); }
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <typename T2>
__device__ __forceinline__ uint32_t as_u32(T2 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Two f32 values as one packed pair of T (low half = a), rounded to nearest.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return as_u32(Mma16<T>::rn2(a, b));
}

// The hi/lo split of an f32 pair: hi = rn(x), lo = rn(x - hi), both in T.
// hi + lo carries x to ~2^-16 (bf16) / ~2^-22 (f16) relative, so a product
// x * y with y exact in T is hi * y + lo * y on the tensor cores, summed in
// f32; a product of two f32 operands is hi*hi + hi*lo + lo*hi (lo*lo is
// below the f32 rounding of the sum).
template <typename T>
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const typename Mma16<T>::T2 h = Mma16<T>::rn2(a, b);
  const float2 hf = Mma16<T>::f2(h);
  hi = as_u32(h);
  lo = pack2<T>(a - hf.x, b - hf.y);
}

// Power-of-two scaling ahead of the split. An f32 operand as small as a
// train step's dout (~1e-6: the gradient of a mean over ~3e4 tokens) lies
// below f16's normal range (6.1e-5), where hi and lo keep a few bits or
// none. The f16 kernels therefore scale dout, and with it dp, delta and
// ds, by 2^-e, with e the binary exponent of the largest |element| in
// reach (pow2_exp: the scaled largest element lies in [0.5, 1)), and
// multiply the sums by 2^e after. Both multiplications are exact. e is 0
// for a zero or non-finite maximum and kept within +-kMaxExp, so 2^e and a
// ratio of two such scales are normal f32.
constexpr int kMaxExp = 60;

__device__ __forceinline__ int pow2_exp(float mx) {
  if (!(mx > 0.f) || !isfinite(mx)) return 0;
  int e;
  frexpf(mx, &e);   // mx = f * 2^e, f in [0.5, 1)
  return max(-kMaxExp, min(kMaxExp, e));
}

// 2^k as an f32, exactly, for |k| <= 126.
__device__ __forceinline__ float pow2(int k) { return __int_as_float((127 + k) << 23); }

// Four 8 x 8 matrices of 16-bit elements from shared memory: lane l gives
// the address of row l % 8 of matrix l / 8; r[i] is matrix i's fragment
// (thread gets row lane / 4, columns 2 * (lane % 4) .. + 1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The same, transposed: the thread gets rows 2 * (lane % 4) .. + 1 of
// column lane / 4.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 16 bytes global -> shared, asynchronously (bypassing L1).
__device__ __forceinline__ void cp16(void* s, const void* g) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(g) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// step_mask on the 2 x 16 pairs a thread owns in the 16-bit kernels' score
// fragments: rows rp[h], columns cp[c], bit 4 (c / 2) + 2 h + c % 2 (the C
// fragment order: column c is 8 (c / 2) + 2t + c % 2 of the tile). kRowsQ:
// the rows are queries (dQ) or keys (dK/dV). The same predicate as
// step_mask, with the pattern's branches taken once a call and the terms of
// one position computed once, which the kernels run measurably faster
// than step_mask per pair (tools/ab_backward.py; PERF.md, PR 14).
// tests/test_torch_cuda.py holds it equal to step_mask bit for bit
// (salo_mask_2x16_check in salo_table_backward.cu).
template <bool kRowsQ>
__device__ __forceinline__ uint32_t mask_2x16(const MaskSpec& s, const int (&rp)[2],
                                              const int (&cp)[16], int fl) {
  const bool won = (fl & 1) != 0, gon = (fl & 2) != 0 && s.n_global > 0;
  uint32_t b = 0;
  if (s.is2d) {
    int ry[2], rx[2], cy[16], cx[16];
    bool rin[2], cin[16];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = rp[h] - s.n_global;
      ry[h] = floordiv(d, s.grid_w);
      rx[h] = d - ry[h] * s.grid_w;
      rin[h] = rp[h] >= s.n_global && rp[h] < s.n;
    }
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int d = cp[c] - s.n_global;
      cy[c] = floordiv(d, s.grid_w);
      cx[c] = d - cy[c] * s.grid_w;
      cin[c] = cp[c] >= s.n_global && cp[c] < s.n;
    }
#pragma unroll
    for (int c = 0; c < 16; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pi = kRowsQ ? rp[h] : cp[c], pj = kRowsQ ? cp[c] : rp[h];
        const bool cz = !s.causal || pj <= pi;
        const bool w = abs(cy[c] - ry[h]) <= s.wh2 && abs(cx[c] - rx[h]) <= s.ww2 && rin[h] &&
                       cin[c] && cz;
        const bool gc = gon && pj < s.n_global && pi < s.n && !w && cz;
        b |= static_cast<uint32_t>((w && won) || gc) << (4 * (c >> 1) + 2 * h + (c & 1));
      }
  } else {
    if (s.dilation <= 1) {
      // Whole-grid answers from the ranges of the positions: most grids of
      // a band are all inside the window or all outside it.
      int cmin = cp[0], cmax = cp[0];
#pragma unroll
      for (int c = 1; c < 16; ++c) {
        cmin = min(cmin, cp[c]);
        cmax = max(cmax, cp[c]);
      }
      const int rmin = min(rp[0], rp[1]), rmax = max(rp[0], rp[1]);
      const int imin = kRowsQ ? rmin : cmin, imax = kRowsQ ? rmax : cmax;
      const int jmin = kRowsQ ? cmin : rmin, jmax = kRowsQ ? cmax : rmax;
      // |pj - pi| < 2^31: positions lie in [0, BIG]
      if (won && imax < s.n && jmax < s.n && jmin - imax >= s.a && jmax - imin <= s.b &&
          (!s.causal || jmax <= imin))
        return ~0u;
      if (!gon && (!won || jmin - imax > s.b || jmax - imin < s.a || (s.causal && jmin > imax)))
        return 0u;
    }
    // a <= rel <= b as one unsigned compare (wraps like int32; |rel| < 2^31)
    const unsigned span = static_cast<unsigned>(s.b) - static_cast<unsigned>(s.a);
    const bool some = s.a <= s.b;
#pragma unroll
    for (int c = 0; c < 16; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pi = kRowsQ ? rp[h] : cp[c], pj = kRowsQ ? cp[c] : rp[h];
        const int rel = pj - pi;
        const bool cz = !s.causal || pj <= pi;
        bool w = some && static_cast<unsigned>(rel) - static_cast<unsigned>(s.a) <= span &&
                 cz && pi < s.n && pj < s.n;
        if (s.dilation > 1) w = w && rel % s.dilation == 0;
        const bool gc = gon && pj < s.n_global && pi < s.n && !w && cz;
        b |= static_cast<uint32_t>((w && won) || gc) << (4 * (c >> 1) + 2 * h + (c & 1));
      }
  }
  return b;
}

// ------------- the 16-bit kernels' blocks and their mask walk ------------- //
// Rows of the 16-bit shared tiles are padded to HD + 8 elements (16 bytes),
// so the eight rows that one ldmatrix phase reads fall on distinct banks.
constexpr int kSub = 64;       // keys (forward, dQ) / queries (dK/dV) a sub-tile
constexpr int kBatch = 8;      // sub-tiles whose masks one pass evaluates
constexpr float kLog2e = 1.4426950408889634f;
// Warps of a block; each owns 16 rows (forward, dQ) / keys (dK/dV). At hd
// 64 the 8-warp blocks are held to 128 registers a thread, so two fit on an
// SM (a few hundred bytes of dK/dV spill, which cost less than one block an
// SM: measured on the H100, see PERF.md).
constexpr int kMaxWarps = 8;

__host__ __device__ constexpr int min_blocks(int nw, int hd) {
  return nw == 8 && hd == 64 ? 2 : 1;
}

// The hd columns of the accumulator (out, dq, or dk and dv) one block
// holds: all of them up to hd 128. At hd 256 a warp's 16 x 256 f32
// accumulators do not fit its registers beside the score fragments, so the
// kernels split the columns over blockIdx.z, two blocks of 128, each of
// which recomputes the scores over the full hd.
__host__ __device__ constexpr int acc_cols(int hd) { return hd > 128 ? 128 : hd; }

// Warps of a block over a plan block of b rows (forward, dQ) or keys
// (dK/dV): a block never straddles two plan blocks.
inline int warps_for(int b) { return min(b, 16 * kMaxWarps) / 16; }

__device__ __forceinline__ void zero16(void* p) {
  *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
}

// Shared memory of the mask walk below.
template <int NW>
__host__ __device__ constexpr int walk_smem_bytes() {
  return kBatch * kSub * 4 + kBatch * 32 * NW * 4 + 2 * NW * 4 + 8;
}

// The live sub-tiles of one table row, in order. Sub-tile u = step * nsub
// + sub starts at tiles[step] * blk + sub * len of the streamed array (keys
// for the forward and dQ, queries for dK/dV) and holds len <= kSub of its
// entries. A pass takes kBatch sub-tiles at once: their positions go to
// shared memory in one coalesced load (BIG past len and on padding steps),
// each thread keeps the mask bits mask(ps, fl) of the 32 pairs it owns in
// shared memory, and each warp reports the sub-tiles where any of its bits
// is set; a sub-tile is live when any warp's is. Two barriers a pass, and
// every thread takes the same path.
template <int NW>
struct LiveWalk {
  int* pos_s;        // [kBatch][kSub]
  uint32_t* bits_s;  // [kBatch][32 * NW]
  uint32_t* wl_s;    // [2][NW]
  const int* pos;    // positions of the streamed array
  const int* tiles;  // the row's step tables
  const int* flags;
  int total, nsub, blk, len;
  int c0 = 0, cnext = 0;
  uint32_t live = 0;

  __device__ LiveWalk(unsigned char* smem, const int* pos_, const int* tiles_,
                      const int* flags_, int steps, int blk_, int len_)
      : pos_s(reinterpret_cast<int*>(smem)),
        bits_s(reinterpret_cast<uint32_t*>(smem + kBatch * kSub * 4)),
        wl_s(reinterpret_cast<uint32_t*>(smem + kBatch * kSub * 4 + kBatch * 32 * NW * 4)),
        pos(pos_), tiles(tiles_), flags(flags_), total(steps * (blk_ / len_)),
        nsub(blk_ / len_), blk(blk_), len(len_) {}

  __device__ int start(int u) const { return __ldg(tiles + u / nsub) * blk + (u % nsub) * len; }

  // The next live sub-tile (its index, start and this thread's bits), or
  // total when none is left.
  template <class Mask>
  __device__ int next(const Mask& mask, int& s0, uint32_t& bits) {
    constexpr int NT = 32 * NW;
    const int tid = threadIdx.x;
    while (live == 0) {
      if (cnext >= total) return total;
      c0 = cnext;
      cnext = min(c0 + kBatch, total);
      const int n = cnext - c0;
      for (int x = tid; x < n * kSub; x += NT) {
        const int u = c0 + x / kSub, j = x % kSub;
        pos_s[x] = (j < len && __ldg(flags + u / nsub) != 0) ? __ldg(pos + start(u) + j) : kBig;
      }
      __syncthreads();
      uint32_t wm = 0;
      for (int c = 0; c < n; ++c) {
        const int fl = __ldg(flags + (c0 + c) / nsub);
        const uint32_t b = fl != 0 ? mask(pos_s + c * kSub, fl) : 0u;
        bits_s[c * NT + tid] = b;
        if (__any_sync(0xffffffffu, b != 0u)) wm |= 1u << c;
      }
      uint32_t* w = wl_s + ((c0 / kBatch) & 1) * NW;
      if ((tid & 31) == 0) w[tid >> 5] = wm;
      __syncthreads();
#pragma unroll
      for (int x = 0; x < NW; ++x) live |= w[x];
    }
    const int c = __ffs(live) - 1;
    live &= live - 1;
    s0 = start(c0 + c);
    bits = bits_s[c * NT + tid];
    return c0 + c;
  }
};

}  // namespace salo
