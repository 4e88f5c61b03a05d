// K5: SALO ragged decode over per-request contiguous caches, for Hopper
// (sm_90a), CUDA C++ with a plain C interface (loaded through ctypes by
// repro_torch/kernels/_build.py).
//
// Replaces the TPU kernel repro/kernels/salo_decode.py::salo_decode (body:
// _ragged_kernel + _tile_update): one new query token per request against
// its contiguous cache (B, Hkv, S, hd) — the lockstep engine's full cache
// (slot = position) or its ring layout (per-slot positions). The caches
// are read IN PLACE through their strides (the lockstep cache is
// (B, S, Hkv, hd) and the caller hands a transposed view, so a contiguous
// copy would move the whole cache every layer, every step); a ragged last
// tile is handled by bounds, positions (S,) are broadcast by a zero batch
// stride, and no positions at all means slot = position.
//
// The body, its bound and its design are in salo_decode_body.cuh (shared
// with K4, the paged-slab decode in salo_paged_decode.cu).
#include "salo_decode_body.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Strides in elements; the
// head dimension must be contiguous and every row 16-byte aligned (the
// wrapper checks). positions: null (slot = position) or rows of S int32
// with batch stride pos_sb (0 = one row shared by the batch). t: (B,)
// int32, or null and t_scalar for every row. n_split / split_len: the
// wrapper's split of the S slots; with n_split > 1, ws is the f32 workspace
// of the partials and counters the zeroed int32 ticket counters (one per
// (request, kv head, row group); the kernel leaves them 0). Returns
// cudaGetLastError() after the launch; the launch is asynchronous on
// `stream`.
int salo_decode(int dtype, int hd, const void* q, const void* k_cache,
                const void* v_cache, long long k_sb, long long k_sh, long long k_ss,
                long long v_sb, long long v_sh, long long v_ss, const void* positions,
                long long pos_sb, const void* t, int t_scalar, void* out, int B,
                int H, int Hkv, int S, int win_lo, int dilation, int n_global,
                float scale, int n_split, int split_len, void* ws, void* counters,
                void* stream) {
  decode_body::Params p = {};
  p.q = q;
  p.k = k_cache;
  p.v = v_cache;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_ss = k_ss;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_ss = v_ss;
  p.positions = static_cast<const int32_t*>(positions);
  p.pos_sb = pos_sb;
  p.t_vec = static_cast<const int32_t*>(t);
  p.t_scalar = t_scalar;
  p.out = out;
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.hd = hd;
  p.S = S;
  p.win_lo = win_lo;
  p.dilation = dilation;
  p.n_global = n_global;
  p.scale = scale;
  p.n_split = n_split;
  p.split_len = split_len;
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  return (int)decode_body::dispatch<false>(dtype, 0, p, static_cast<cudaStream_t>(stream));
}

// The static shared memory of the kernel for dtype and hd, in bytes
// (decode_body::smem_of); -1 where none is instantiated.
int salo_decode_smem(int dtype, int hd) { return decode_body::smem_of<false>(dtype, 0, hd); }

const char* salo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
