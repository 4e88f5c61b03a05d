"""SALO ragged decode: the CUDA kernels' wrappers and their plain versions.

One new token per request, one launch for the whole batch: the
per-request position vector ``t`` (or a lockstep scalar) rides in as an
argument, so rows at different depths share one launch. Two cache layouts,
as in the reference's ``repro/kernels/salo_decode.py``:

* :func:`salo_paged_decode` (K4, ``csrc/salo_paged_decode.cu``) — the
  pooled paged slab ``(n_pages, page, Hkv, hd)`` shared by every request,
  chased through per-request page tables inside the kernel. Replaces the
  TPU kernel ``salo_paged_decode`` (``_make_paged_kernel`` +
  ``_tile_update``) with all its variants: the int8 slab with per-page f32
  scales, dequantized in the kernel; ``return_state`` (f32 ``out``, ``m``,
  ``l``); ``return_page_stats`` (per-(request, logical page) max scores).
* :func:`salo_decode` (K5, ``csrc/salo_decode.cu``) — per-request
  contiguous caches ``(B, Hkv, S, hd)`` (the lockstep engine's full cache
  or ring layout), read in place through their strides. Replaces the TPU
  kernel ``salo_decode`` (``_ragged_kernel``).

Both kernels share one body (``csrc/salo_decode_body.cuh``), whose note
gives the design and the bound: split-KV in one launch, each request's
slots split over several blocks whose partials the last block to finish
merges. :func:`plan_splits` picks the split from shapes alone.

Each wrapper takes its plain version (:func:`salo_paged_decode_plain`,
:func:`salo_decode_plain`: the ragged decode twin, exactly the
reference's off-TPU path) ONLY for CPU tensors. For CUDA tensors it
launches the kernel or raises — no fallback.

Empty rows: the two versions disagree on a row with no live slot (the
plain version returns the mean of V, as the reference's twin does; the
kernels return 0, as the Pallas kernels do). Only inactive engine rows
are empty and their logits are discarded, so kernel and plain version are
compared only on rows that attend at least one slot. With ``return_state``
both give the ``(0, NEG_INF, 0)`` identity there.

``salo_paged_decode.launches``, ``salo_decode.launches`` and the plain
versions' ``.calls`` are plain integer counters: one per kernel launch and
one per plain-version call.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.patterns import HybridSparsePattern

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128, 256)
_ROWS_PER_BLOCK = 4          # kRows of the kernel body: query rows per block
_MAX_SPLITS = 64             # kMaxSplits of the kernel body
_SPLIT_GRAIN = 16            # a split's length is a multiple of 16 slots
_BLOCKS_PER_SM = 2           # what the planner aims at


def plan_splits(S: int, units: int, n_sm: int,
                page: int = 1) -> Tuple[int, int]:
    """How the decode kernels split each request's ``S`` slots over
    blocks: returns ``(n_split, split_len)``.

    ``units`` is the number of (request, kv head, row group) triples, the
    grid's other dimension, and ``n_sm`` the card's SM count. The plan aims
    at about ``_BLOCKS_PER_SM`` blocks per SM, at most ``_MAX_SPLITS``
    splits, and a split length that is a multiple of 16 slots and of
    ``page`` (so a paged split owns whole pages). It reads shapes only,
    never ``t`` or positions, so a launch stays the same from step to step
    (and capturable in a CUDA graph). Every split is non-empty:
    ``(n_split - 1) * split_len < S <= n_split * split_len``.
    """
    if S <= 0 or units <= 0 or n_sm <= 0 or page <= 0:
        raise ValueError(f"plan_splits needs positive sizes, got S={S}, "
                         f"units={units}, n_sm={n_sm}, page={page}")
    grain = math.lcm(_SPLIT_GRAIN, page)
    want = -(-_BLOCKS_PER_SM * n_sm // units)
    n = max(1, min(want, -(-S // grain), _MAX_SPLITS))
    length = -(-(-(-S // n)) // grain) * grain
    return -(-S // length), length


_SM_COUNT: Dict[int, int] = {}                # device index -> SMs
_COUNTERS: Dict[int, torch.Tensor] = {}       # device index -> tickets


def _units(B: int, H: int, Hkv: int) -> int:
    """(request, kv head, row group) triples: the grid's other dimension."""
    return B * Hkv * -(-(H // Hkv) // _ROWS_PER_BLOCK)


def split_plan(device: torch.device, B: int, H: int, Hkv: int, S: int,
               page: int = 1) -> Tuple[int, int]:
    """:func:`plan_splits` for a call with these shapes on ``device``
    (a CUDA device: its SM count comes from the device properties)."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return plan_splits(S, _units(B, H, Hkv), _SM_COUNT[idx], page)


def _split_operands(device, B, H, Hkv, hd, n_split):
    """The workspace of the partials (``torch.empty``, f32) and the ticket
    counters for a split launch, or ``(None, None)`` for ``n_split == 1``.
    The counters are one int32 buffer per device, made zeroed once and
    grown (zeroed) when a grid needs more; every launch leaves them 0, so
    launches of this device must not run concurrently on two streams."""
    if n_split == 1:
        return None, None
    units = _units(B, H, Hkv)
    ws = torch.empty(units * n_split * _ROWS_PER_BLOCK * (hd + 2),
                     dtype=torch.float32, device=device)
    buf = _COUNTERS.get(device.index)
    if buf is None or buf.numel() < units:
        buf = torch.zeros(max(units, 2 * (0 if buf is None else buf.numel())),
                          dtype=torch.int32, device=device)
        _COUNTERS[device.index] = buf
    return ws, buf


def _bind(name: str, argtypes):
    from repro_torch.kernels._build import load

    lib = load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.salo_cuda_error_string.argtypes = [ctypes.c_int]
        lib.salo_cuda_error_string.restype = ctypes.c_char_p
    return lib


_VP, _CI, _CL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SPLIT_ARGS = [ctypes.c_float, _CI, _CI, _VP, _VP, _VP]
_PAGED_ARGS = [_CI, _CI, _CI] + [_VP] * 9 + [_CI] + [_VP] * 3 + [_CI] * 8 \
    + _SPLIT_ARGS
_CONTIG_ARGS = [_CI, _CI] + [_VP] * 3 + [_CL] * 6 + [_VP, _CL, _VP, _CI, _VP] \
    + [_CI] * 7 + _SPLIT_ARGS


def _pattern_args(pattern: HybridSparsePattern):
    if pattern.is_2d or not pattern.causal:
        raise ValueError(f"decode needs a causal 1-D pattern, got {pattern}")
    a, _ = pattern.window
    return max(a, -(2 ** 31 - 1)), pattern.dilation, pattern.n_global


def _check_q(q: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"q must be (B, H, 1, hd), got {tuple(q.shape)}")


def _check_kernel_q(name: str, q: torch.Tensor) -> None:
    """What both kernels need of q beyond the shared checks."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the kernel takes float32/bfloat16/float16, got "
                        f"{q.dtype}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {_HEAD_DIMS}, got "
                         f"{q.shape[-1]}")
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("the kernel needs a contiguous, 16-byte aligned q")


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _raise_on(lib, name: str, err: int) -> None:
    if err != 0:
        msg = lib.salo_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


# ----------------------------- K4: paged slab --------------------------- #
def salo_paged_decode_plain(q: torch.Tensor, k_slab: torch.Tensor,
                            v_slab: torch.Tensor, page_tables: torch.Tensor,
                            positions: torch.Tensor, t: torch.Tensor, *,
                            pattern: HybridSparsePattern,
                            scale: Optional[float] = None,
                            return_state: bool = False,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None,
                            return_page_stats: bool = False):
    """The plain version: gather (and dequantize) every request's pages,
    then the ragged decode twin (``repro/kernels/salo_decode.py:284-298``).
    Same outputs as :func:`salo_paged_decode`."""
    from repro_torch.core.attention import hybrid_decode_attention
    from repro_torch.serve.paged_cache import gather_view

    salo_paged_decode_plain.calls += 1
    B, npp = page_tables.shape
    page = k_slab.shape[1]
    quant = k_scale is not None
    k_req, v_req = gather_view(
        k_slab, v_slab, page_tables,
        *((k_scale, v_scale, q.dtype) if quant else ()))
    res = hybrid_decode_attention(
        q, k_req.transpose(1, 2), v_req.transpose(1, 2), t, pattern,
        scale=scale, cache_positions=positions, return_state=return_state,
        return_slot_m=return_page_stats)
    if not return_page_stats:
        return res
    parts, slot_m = res[:-1], res[-1]
    page_m = slot_m.reshape(B, npp, page).amax(dim=-1)
    return (*parts, page_m) if return_state else (parts[0], page_m)


salo_paged_decode_plain.calls = 0


def _check_paged(q, k_slab, v_slab, page_tables, positions, t, k_scale,
                 v_scale):
    _check_q(q)
    B, H, _, hd = q.shape
    if k_slab.dim() != 4 or k_slab.shape != v_slab.shape:
        raise ValueError(f"slabs must be one (n_pages, page, Hkv, hd) shape, "
                         f"got {tuple(k_slab.shape)} / {tuple(v_slab.shape)}")
    n_pages, page, Hkv, shd = k_slab.shape
    if shd != hd or H % Hkv:
        raise ValueError(f"q heads {H} x {hd} do not fit slab heads "
                         f"{Hkv} x {shd}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if k_scale is None:
        if k_slab.dtype != q.dtype or v_slab.dtype != q.dtype:
            raise TypeError(f"slab dtype {k_slab.dtype}/{v_slab.dtype} must "
                            f"equal q's {q.dtype}")
    else:
        if k_slab.dtype != torch.int8 or v_slab.dtype != torch.int8:
            raise TypeError(f"a slab with scales must be int8, got "
                            f"{k_slab.dtype}/{v_slab.dtype}")
        for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
            if x.dtype != torch.float32 or tuple(x.shape) != (n_pages,):
                raise ValueError(f"{name} must be float32 ({n_pages},), got "
                                 f"{x.dtype} {tuple(x.shape)}")
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
    ops = [q, k_slab, v_slab, page_tables, positions, t]
    ops += [x for x in (k_scale, v_scale) if x is not None]
    devs = {x.device for x in ops}
    if len(devs) != 1:
        raise ValueError(f"all operands must share one device, got {devs}")
    return ops


def salo_paged_decode(q: torch.Tensor, k_slab: torch.Tensor,
                      v_slab: torch.Tensor, page_tables: torch.Tensor,
                      positions: torch.Tensor, t: torch.Tensor, *,
                      pattern: HybridSparsePattern,
                      scale: Optional[float] = None,
                      return_state: bool = False,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None,
                      return_page_stats: bool = False):
    """Ragged decode straight off the pooled paged slab.

    q: (B, H, 1, hd); slabs: (n_pages, page, Hkv, hd) shared by ALL
    requests; page_tables: (B, npp) int32 physical page per logical page;
    positions: (B, npp * page) int32 absolute position per logical slot;
    ``t``: (B,) int32 per-request position. Returns (B, H, 1, hd) in q's
    dtype.

    **int8 slab**: pass the layer's ``k_scale``/``v_scale`` (n_pages,) f32
    with int8 slabs; each K/V row is dequantized by its page's scale and
    rounded to q's dtype before the products.

    ``return_state=True`` returns ``(out, m, l)``: out in f32, unrounded,
    and the row stats m, l (B, H, 1) f32 — the partial a sequence shard
    contributes to a cross-shard merge; a row with no live slot gives
    ``(0, NEG_INF, 0)``. ``return_page_stats=True`` appends ``page_m``
    (B, npp) f32: the max masked score of each request against each of
    its logical pages this step (``NEG_INF`` where every slot is masked).
    Outputs are ``out[, m, l][, page_m]`` in that order.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (f32 / bf16 / f16 q, hd in {64, 128, 256}, causal 1-D patterns) or
    raise.
    """
    ops = _check_paged(q, k_slab, v_slab, page_tables, positions, t,
                       k_scale, v_scale)
    B, H, _, hd = q.shape
    _, page, Hkv, _ = k_slab.shape
    npp = page_tables.shape[1]
    scale_ = (hd ** -0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        return salo_paged_decode_plain(
            q, k_slab, v_slab, page_tables, positions, t, pattern=pattern,
            scale=scale_, return_state=return_state, k_scale=k_scale,
            v_scale=v_scale, return_page_stats=return_page_stats)
    _check_kernel_q("salo_paged_decode", q)
    win_lo, dil, n_global = _pattern_args(pattern)
    if not all(x.is_contiguous() for x in ops):
        raise ValueError("the kernel needs contiguous operands")
    if k_slab.data_ptr() % 16 or v_slab.data_ptr() % 16:
        raise ValueError("the kernel reads the slabs in 16-byte loads; they "
                         "must start on a 16-byte boundary")
    lib = _bind("salo_paged_decode", _PAGED_ARGS)
    out = torch.empty(q.shape, dtype=torch.float32 if return_state
                      else q.dtype, device=q.device)
    m = l = pm = None
    if return_state:
        m = torch.empty((B, H, 1), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    if return_page_stats:
        n_rg = -(-(H // Hkv) // _ROWS_PER_BLOCK)
        pm = torch.empty((B, Hkv, n_rg, npp), dtype=torch.float32,
                         device=q.device)

    n_split, split_len = split_plan(q.device, B, H, Hkv, npp * page, page)
    ws, counters = _split_operands(q.device, B, H, Hkv, hd, n_split)

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.salo_paged_decode(
            _DTYPE_CODE[q.dtype], int(k_scale is not None), hd, q.data_ptr(),
            k_slab.data_ptr(), v_slab.data_ptr(), _ptr(k_scale),
            _ptr(v_scale), page_tables.data_ptr(), positions.data_ptr(),
            t.data_ptr(), out.data_ptr(), int(return_state), _ptr(m), _ptr(l),
            _ptr(pm), B, H, Hkv, page, npp, win_lo, dil, n_global, scale_,
            n_split, split_len, _ptr(ws), _ptr(counters), stream)
    _raise_on(lib, "salo_paged_decode", err)
    salo_paged_decode.launches += 1
    res = (out, m, l) if return_state else (out,)
    if return_page_stats:
        res = (*res, pm.amax(dim=(1, 2)))
    return res if len(res) > 1 else out


salo_paged_decode.launches = 0


# -------------------------- K5: contiguous caches ----------------------- #
def salo_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor,
                      positions: Optional[torch.Tensor], t, *,
                      pattern: HybridSparsePattern,
                      scale: Optional[float] = None,
                      slice_window: bool = False) -> torch.Tensor:
    """The plain version: the ragged decode twin with the slots' positions
    (the reference's off-TPU path, ``repro/kernels/salo_decode.py:187-190``).
    ``slice_window`` reads only the window slice and the sinks, as the
    reference's lockstep ``attn_decode`` does (slot = position layout and
    a scalar ``t`` only)."""
    from repro_torch.core.attention import hybrid_decode_attention

    salo_decode_plain.calls += 1
    return hybrid_decode_attention(q, k_cache, v_cache, t, pattern,
                                   scale=scale, cache_positions=positions,
                                   slice_window=slice_window)


salo_decode_plain.calls = 0


def _check_contig(q, k_cache, v_cache, positions, t):
    _check_q(q)
    B, H, _, hd = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"caches must be one (B, Hkv, S, hd) shape, got "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    cb, Hkv, S, chd = k_cache.shape
    if cb != B or chd != hd or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit caches "
                         f"{tuple(k_cache.shape)}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"cache dtype {k_cache.dtype}/{v_cache.dtype} must "
                        f"equal q's {q.dtype}")
    ops = [q, k_cache, v_cache]
    if positions is not None:
        if positions.dtype != torch.int32:
            raise TypeError(f"positions must be int32, got {positions.dtype}")
        if tuple(positions.shape) not in ((S,), (B, S)):
            raise ValueError(f"positions must be ({S},) or ({B}, {S}), got "
                             f"{tuple(positions.shape)}")
        ops.append(positions)
    if torch.is_tensor(t):
        if t.dtype != torch.int32:
            raise TypeError(f"t must be int32, got {t.dtype}")
        if tuple(t.shape) not in ((), (B,)):
            raise ValueError(f"t must be a scalar or ({B},), got "
                             f"{tuple(t.shape)}")
        ops.append(t)
    devs = {x.device for x in ops}
    if len(devs) != 1:
        raise ValueError(f"all operands must share one device, got {devs}")


def salo_decode(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, positions: Optional[torch.Tensor], t,
                *, pattern: HybridSparsePattern,
                scale: Optional[float] = None,
                slice_window: bool = False) -> torch.Tensor:
    """Ragged decode over per-request contiguous caches.

    q: (B, H, 1, hd); caches: (B, Hkv, S, hd), any strides with a
    contiguous head dimension (the lockstep engine passes a transposed view
    of its (B, S, Hkv, hd) cache; it is read in place); positions: (S,)
    shared or (B, S) per-request int32 absolute position per slot
    (``PAD_SENTINEL`` = empty), or ``None`` for slot = position; ``t``: an
    int (lockstep) or a (B,) int32 tensor. Returns (B, H, 1, hd) in q's
    dtype.

    ``slice_window`` only changes the plain version (which then reads the
    window slice and the sinks, as the reference's ``attn_decode`` asks);
    the kernel reads only live slots whatever it is.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (f32 / bf16 / f16, hd in {64, 128, 256}, causal 1-D patterns, 16-byte
    aligned rows) or raise.
    """
    _check_contig(q, k_cache, v_cache, positions, t)
    B, H, _, hd = q.shape
    _, Hkv, S, _ = k_cache.shape
    scale_ = (hd ** -0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        return salo_decode_plain(q, k_cache, v_cache, positions, t,
                                 pattern=pattern, scale=scale_,
                                 slice_window=slice_window)
    _check_kernel_q("salo_decode", q)
    win_lo, dil, n_global = _pattern_args(pattern)
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        es = x.element_size()
        if x.stride(-1) != 1 or x.data_ptr() % 16 or any(
                (st * es) % 16 for st in x.stride()[:3]):
            raise ValueError(f"the kernel reads {name} rows in 16-byte "
                             f"loads: its head dimension must be contiguous "
                             f"and every row 16-byte aligned, got strides "
                             f"{x.stride()}")
    pos_sb = 0
    if positions is not None:
        if positions.stride(-1) != 1:
            raise ValueError("positions must be contiguous along the slots")
        pos_sb = positions.stride(0) if positions.dim() == 2 else 0
    t_vec, t_scalar = None, 0
    if torch.is_tensor(t) and t.dim() == 1:
        t_vec = t.contiguous()
    else:
        t_scalar = int(t)
    lib = _bind("salo_decode", _CONTIG_ARGS)
    out = torch.empty_like(q)
    ks, vs = k_cache.stride(), v_cache.stride()
    n_split, split_len = split_plan(q.device, B, H, Hkv, S)
    ws, counters = _split_operands(q.device, B, H, Hkv, hd, n_split)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.salo_decode(
            _DTYPE_CODE[q.dtype], hd, q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
            _ptr(positions), pos_sb, _ptr(t_vec), t_scalar, out.data_ptr(), B,
            H, Hkv, S, win_lo, dil, n_global, scale_, n_split, split_len,
            _ptr(ws), _ptr(counters), stream)
    _raise_on(lib, "salo_decode", err)
    salo_decode.launches += 1
    return out


salo_decode.launches = 0
