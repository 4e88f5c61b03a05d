// K4: SALO ragged paged decode for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded through ctypes by repro_torch/kernels/_build.py).
//
// Replaces the TPU kernel repro/kernels/salo_decode.py::salo_paged_decode
// (body: _make_paged_kernel + _tile_update), every variant: one new query
// token per request against the pooled paged ring-cache slab
// (n_pages, page, Hkv, hd), shared by every request, fp or int8 with f32
// per-page scales; optionally the f32 state (out, m, l) and the per-page
// max scores. The physical page of logical slot s of request b is
// page_tables[b, s / page], read from global memory inside the kernel; the
// slab is never gathered.
//
// The body, its bound and its design are in salo_decode_body.cuh (shared
// with K5, the contiguous-cache decode in salo_decode.cu).
#include "salo_decode_body.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q's type); kv_int8: the
// slab is int8 with k_scale/v_scale. Pointers of unused variants are null.
// n_split / split_len: the wrapper's split of the npp * page slots (whole
// pages); with n_split > 1, ws is the f32 workspace of the partials and
// counters the zeroed int32 ticket counters (one per (request, kv head, row
// group); the kernel leaves them 0). Returns cudaGetLastError() after the
// launch (0 = success); the launch is asynchronous on `stream`. q and the
// slabs must be 16-byte aligned.
int salo_paged_decode(int dtype, int kv_int8, int hd, const void* q,
                      const void* k_slab, const void* v_slab, const void* k_scale,
                      const void* v_scale, const void* page_tables,
                      const void* positions, const void* t, void* out, int out_f32,
                      void* m_out, void* l_out, void* pm_out, int B, int H, int Hkv,
                      int page, int npp, int win_lo, int dilation, int n_global,
                      float scale, int n_split, int split_len, void* ws,
                      void* counters, void* stream) {
  decode_body::Params p = {};
  p.q = q;
  p.k = k_slab;
  p.v = v_slab;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.page_tables = static_cast<const int32_t*>(page_tables);
  p.positions = static_cast<const int32_t*>(positions);
  p.t_vec = static_cast<const int32_t*>(t);
  p.out = out;
  p.out_f32 = out_f32;
  p.m_out = static_cast<float*>(m_out);
  p.l_out = static_cast<float*>(l_out);
  p.pm_out = static_cast<float*>(pm_out);
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.hd = hd;
  p.S = page * npp;
  p.page = page;
  p.npp = npp;
  p.win_lo = win_lo;
  p.dilation = dilation;
  p.n_global = n_global;
  p.scale = scale;
  p.n_split = n_split;
  p.split_len = split_len;
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  if (p.t_vec == nullptr || p.positions == nullptr || p.page_tables == nullptr ||
      (kv_int8 && (p.k_scale == nullptr || p.v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  return (int)decode_body::dispatch<true>(dtype, kv_int8, p,
                                          static_cast<cudaStream_t>(stream));
}

// The static shared memory of the kernel for dtype, kv_int8 and hd, in
// bytes (decode_body::smem_of); -1 where none is instantiated.
int salo_paged_decode_smem(int dtype, int kv_int8, int hd) {
  return decode_body::smem_of<true>(dtype, kv_int8, hd);
}

const char* salo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
