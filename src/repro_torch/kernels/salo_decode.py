"""SALO ragged paged decode: the CUDA kernel's wrapper and its plain version.

One new token per request against the pooled paged slab
``(n_pages, page, Hkv, hd)``, one launch for the whole continuous batch:
the per-request position vector ``t`` and page tables ride in as int32
tensors, so rows at different depths share one launch. The kernel,
``csrc/salo_paged_decode.cu``, replaces the TPU kernel
``repro/kernels/salo_decode.py::salo_paged_decode``
(``_make_paged_kernel`` + ``_tile_update``), fp-slab variant; its source
note gives its design and bound.

:func:`salo_paged_decode` takes the plain version
(:func:`salo_paged_decode_plain`: gather + the ragged decode twin, exactly
the reference's off-TPU path) ONLY for CPU tensors. For CUDA tensors it
launches the kernel or raises — no fallback.

Empty rows: the two versions disagree on a row with no live slot (the
plain version returns the mean of V, as the reference's twin does; the
kernel returns 0, as the Pallas kernel does). Only inactive engine rows
are empty and their logits are discarded, so kernel and plain version are
compared only on rows that attend at least one slot.

``salo_paged_decode.launches`` and ``salo_paged_decode_plain.calls`` are
plain integer counters: one per kernel launch and one per plain-version
call.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.patterns import HybridSparsePattern

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128, 256)


def _bind():
    from repro_torch.kernels._build import load

    lib = load("salo_paged_decode")
    fn = lib.salo_paged_decode
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci,
                       ci, ci, ci, ci, ctypes.c_float, vp]
        fn.restype = ci
        lib.salo_cuda_error_string.argtypes = [ci]
        lib.salo_cuda_error_string.restype = ctypes.c_char_p
    return lib


def salo_paged_decode_plain(q: torch.Tensor, k_slab: torch.Tensor,
                            v_slab: torch.Tensor, page_tables: torch.Tensor,
                            positions: torch.Tensor, t: torch.Tensor, *,
                            pattern: HybridSparsePattern,
                            scale: Optional[float] = None) -> torch.Tensor:
    """The plain version: gather every request's pages, then the ragged
    decode twin (``repro/kernels/salo_decode.py:284-298``)."""
    from repro_torch.core.attention import hybrid_decode_attention
    from repro_torch.serve.paged_cache import gather_view

    salo_paged_decode_plain.calls += 1
    k_req, v_req = gather_view(k_slab, v_slab, page_tables)
    return hybrid_decode_attention(
        q, k_req.transpose(1, 2), v_req.transpose(1, 2), t, pattern,
        scale=scale, cache_positions=positions)


salo_paged_decode_plain.calls = 0


def _check(q, k_slab, v_slab, page_tables, positions, t):
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"q must be (B, H, 1, hd), got {tuple(q.shape)}")
    B, H, _, hd = q.shape
    if k_slab.dim() != 4 or k_slab.shape != v_slab.shape:
        raise ValueError(f"slabs must be one (n_pages, page, Hkv, hd) shape, "
                         f"got {tuple(k_slab.shape)} / {tuple(v_slab.shape)}")
    _, page, Hkv, shd = k_slab.shape
    if shd != hd or H % Hkv:
        raise ValueError(f"q heads {H} x {hd} do not fit slab heads "
                         f"{Hkv} x {shd}")
    if k_slab.dtype != q.dtype or v_slab.dtype != q.dtype:
        raise TypeError(f"slab dtype {k_slab.dtype}/{v_slab.dtype} must "
                        f"equal q's {q.dtype}")
    for name, x in (("page_tables", page_tables), ("positions", positions),
                    ("t", t)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    if page_tables.dim() != 2 or page_tables.shape[0] != B:
        raise ValueError(f"page_tables must be (B={B}, npp), got "
                         f"{tuple(page_tables.shape)}")
    npp = page_tables.shape[1]
    if tuple(positions.shape) != (B, npp * page):
        raise ValueError(f"positions must be ({B}, {npp * page}), got "
                         f"{tuple(positions.shape)}")
    if tuple(t.shape) != (B,):
        raise ValueError(f"t must be ({B},), got {tuple(t.shape)}")
    devs = {x.device for x in (q, k_slab, v_slab, page_tables, positions, t)}
    if len(devs) != 1:
        raise ValueError(f"all operands must share one device, got {devs}")


def salo_paged_decode(q: torch.Tensor, k_slab: torch.Tensor,
                      v_slab: torch.Tensor, page_tables: torch.Tensor,
                      positions: torch.Tensor, t: torch.Tensor, *,
                      pattern: HybridSparsePattern,
                      scale: Optional[float] = None,
                      return_state: bool = False,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None,
                      return_page_stats: bool = False) -> torch.Tensor:
    """Ragged decode straight off the pooled paged slab.

    q: (B, H, 1, hd); slabs: (n_pages, page, Hkv, hd) shared by ALL
    requests; page_tables: (B, npp) int32 physical page per logical page;
    positions: (B, npp * page) int32 absolute position per logical slot;
    ``t``: (B,) int32 per-request position. Returns (B, H, 1, hd) in q's
    dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (f32 / bf16 / f16, hd in {64, 128, 256}) or raise.
    """
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "int8 slabs (k_scale/v_scale) are not ported yet: ROADMAP "
            "'K4 variants' (int8 dequant)")
    if return_state:
        raise NotImplementedError(
            "return_state is not ported yet: ROADMAP 'K4 variants' "
            "(return_state, for sequence-parallel decode)")
    if return_page_stats:
        raise NotImplementedError(
            "return_page_stats is not ported yet: ROADMAP 'K4 variants' "
            "(page stats + the engine's page sparsity)")
    _check(q, k_slab, v_slab, page_tables, positions, t)
    B, H, _, hd = q.shape
    _, page, Hkv, _ = k_slab.shape
    scale_ = (hd ** -0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        return salo_paged_decode_plain(q, k_slab, v_slab, page_tables,
                                       positions, t, pattern=pattern,
                                       scale=scale_)
    if q.device.type != "cuda":
        raise ValueError(f"salo_paged_decode runs on cpu or cuda, got "
                         f"{q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the kernel takes float32/bfloat16/float16, got "
                        f"{q.dtype}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {_HEAD_DIMS}, got "
                         f"{hd}")
    if pattern.is_2d or not pattern.causal:
        raise ValueError(f"paged decode needs a causal 1-D pattern, got "
                         f"{pattern}")
    ops = (q, k_slab, v_slab, page_tables, positions, t)
    if not all(x.is_contiguous() for x in ops):
        raise ValueError("the kernel needs contiguous operands")
    if k_slab.data_ptr() % 16 or v_slab.data_ptr() % 16:
        raise ValueError("the kernel reads the slabs in 16-byte loads; they "
                         "must start on a 16-byte boundary")
    lib = _bind()
    a, _ = pattern.window
    win_lo = max(a, -(2 ** 31 - 1))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.salo_paged_decode(
            _DTYPE_CODE[q.dtype], hd, q.data_ptr(), k_slab.data_ptr(),
            v_slab.data_ptr(), page_tables.data_ptr(), positions.data_ptr(),
            t.data_ptr(), out.data_ptr(), B, H, Hkv, page,
            page_tables.shape[1], win_lo, pattern.dilation, pattern.n_global,
            scale_, stream)
    if err != 0:
        msg = lib.salo_cuda_error_string(err).decode()
        raise RuntimeError(f"salo_paged_decode launch failed: {msg} ({err})")
    salo_paged_decode.launches += 1
    return out


salo_paged_decode.launches = 0
