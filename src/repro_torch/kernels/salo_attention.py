"""SALO table-driven hybrid sparse attention, forward (K1): the CUDA
kernel's wrapper and its plain version.

One launch executes a whole :class:`~repro_torch.core.scheduler
.ExecutionPlan`: query block ``i`` visits KV tile ``kv_blocks[i, s]`` at
each step ``s``, masked by ``BandSchedule.step_mask`` on ORIGINAL positions
(flag bits window / global column, 0 = padding), folded through the
guarded online softmax. It emits the normalized ``out`` plus the f32 row
stats ``m``, ``l`` — the backward's residuals. Rows that attend nothing
give ``(0, NEG_INF, 0)``. The kernel, ``csrc/salo_table_attention.cu``,
replaces the TPU kernel ``repro/kernels/salo_attention.py::
salo_table_attention`` (body ``_kernel``); its source note gives its
design and bound.

:func:`salo_table_attention` takes the plain version
(:func:`salo_table_attention_plain`, which is
:func:`repro_torch.core.blockwise.table_attention_scan`) ONLY for CPU
tensors. For CUDA tensors it launches the kernel or raises — no fallback.
``salo_table_attention.launches`` counts kernel launches and
``salo_table_attention_plain.calls`` plain-version calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.blockwise import plan_tables, table_attention_scan
from repro_torch.core.scheduler import BandSchedule, ExecutionPlan

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (64, 128, 256)
BLOCKS = (32, 64, 128, 256)
_I32_MAX = 2 ** 31 - 1
# The kernel against its plain version, abs and rel. f32: the same
# arithmetic in another order (1e-5). 16-bit out 8e-3, two bf16 ulps at
# |out| near 0.5: out is returned in the 16-bit type, and the kernel rounds
# p to it relative to a 64-key sub-tile's running max (the plain version:
# the plan tile's), so the two may round one element one ulp apart. The
# row stats m, l are f32 in every case (STATS_TOL): the kernel sums the f32
# p into l, as the reference does (tests/test_torch_forward_numerics.py
# shows that summing the rounded p misses it).
OUT_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3, torch.float16: 8e-3}
STATS_TOL = 1e-5


class MaskSpec(ctypes.Structure):
    """The pattern fields ``step_mask`` reads, as the kernels take them
    (``struct MaskSpec`` in ``csrc/salo_mask.cuh``)."""
    _fields_ = [(name, ctypes.c_int) for name in
                ("a", "b", "dilation", "n_global", "causal", "n", "is2d",
                 "grid_w", "wh2", "ww2")]


def mask_spec(sched: BandSchedule) -> MaskSpec:
    """The schedule's mask fields; the window is clamped into int32 (the
    ``full()`` pattern uses a window of +-2**30 and may be wider)."""
    p = sched.pattern
    a, b = p.window
    gw, wh2, ww2 = 1, 0, 0
    if p.is_2d:
        gw = p.grid2d[1]
        wh2, ww2 = p.window2d[0] // 2, p.window2d[1] // 2
    return MaskSpec(max(a, -_I32_MAX), min(b, _I32_MAX), p.dilation,
                    p.n_global, int(sched.causal), sched.n, int(p.is_2d),
                    gw, wh2, ww2)


def bind(name: str, fn_name: str, n_ptr: int, n_int: int):
    """The library ``csrc/<name>.cu``, with ``fn_name``'s argument types
    set: ``n_ptr`` pointers, a ``MaskSpec*``, ``n_int`` ints, the scale
    and the stream."""
    from repro_torch.kernels._build import load

    lib = load(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([ci, ci] + [vp] * n_ptr + [ctypes.POINTER(MaskSpec)]
                       + [ci] * n_int + [ctypes.c_float, vp])
        fn.restype = ci
        lib.salo_cuda_error_string.argtypes = [ci]
        lib.salo_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def check_kernel_operands(what: str, tensors, *, dtype, hd: int,
                          block_q: int, block_k: int) -> None:
    """What every training kernel takes: one CUDA device, contiguous
    16-byte aligned operands, a supported type, head dim and block size."""
    if dtype not in DTYPE_CODE:
        raise TypeError(f"{what}: the kernel takes float32/bfloat16/float16, "
                        f"got {dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: the kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {hd}")
    if block_q not in BLOCKS or block_k not in BLOCKS:
        raise ValueError(f"{what}: the kernel takes block_q/block_k in "
                         f"{BLOCKS}, got {block_q}/{block_k}")
    devs = {x.device for x in tensors}
    if len(devs) != 1:
        raise ValueError(f"{what}: all operands must share one device, got "
                         f"{devs}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{what}: the kernel needs contiguous operands")
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError(f"{what}: the kernel reads in 16-byte loads; every "
                         f"operand must start on a 16-byte boundary")


def check_tables(what: str, *tables) -> None:
    for t in tables:
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: tables and positions must be int32, "
                            f"got {t.dtype}")


def raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.salo_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def salo_table_attention_plain(q, k, v, pos_q, pos_k, kv_blocks, flags, *,
                               sched: BandSchedule, scale: float):
    """The plain version: :func:`repro_torch.core.blockwise
    .table_attention_scan`."""
    salo_table_attention_plain.calls += 1
    return table_attention_scan(q, k, v, pos_q, pos_k, kv_blocks, flags,
                                sched, scale)


salo_table_attention_plain.calls = 0


def salo_table_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos_q: torch.Tensor, pos_k: torch.Tensor,
                         kv_blocks: torch.Tensor, flags: torch.Tensor, *,
                         sched: BandSchedule, scale: float):
    """The table-driven forward launch.

    q: (B, nq*block_q, D); k/v: (B, nkb*block_k, D) (the q and KV sides may
    differ in length); pos_q: (nq, block_q) and pos_k: (nkb, block_k)
    int32 ORIGINAL positions; kv_blocks/flags: (nq, W) int32 step tables.
    Returns ``(out, m, l)``: out (B, nq*block_q, D) in q's dtype, m/l
    (B, nq*block_q) f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (f32 / bf16 / f16, hd in {64, 128, 256}, blocks in {32, 64, 128, 256}) or
    raise.
    """
    B, nQ, D = q.shape
    nq, bq = pos_q.shape
    nkb, bk = pos_k.shape
    if (nq * bq != nQ or k.shape != (B, nkb * bk, D) or v.shape != k.shape
            or kv_blocks.shape != flags.shape or kv_blocks.shape[0] != nq):
        raise ValueError(
            f"salo_table_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, pos_q {tuple(pos_q.shape)}, pos_k "
            f"{tuple(pos_k.shape)}, tables {tuple(kv_blocks.shape)}/"
            f"{tuple(flags.shape)} do not fit")
    check_tables("salo_table_attention", pos_q, pos_k, kv_blocks, flags)
    if q.device.type == "cpu":
        return salo_table_attention_plain(q, k, v, pos_q, pos_k, kv_blocks,
                                          flags, sched=sched, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"salo_table_attention runs on cpu or cuda, got "
                         f"{q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"salo_table_attention: k/v dtype {k.dtype}/"
                        f"{v.dtype} must equal q's {q.dtype}")
    ops = (q, k, v, pos_q, pos_k, kv_blocks, flags)
    check_kernel_operands("salo_table_attention", ops, dtype=q.dtype, hd=D,
                          block_q=bq, block_k=bk)
    lib, fn = bind("salo_table_attention", "salo_table_attention", 10, 6)
    out = torch.empty_like(q)
    m = torch.empty((B, nQ), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    spec = mask_spec(sched)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(DTYPE_CODE[q.dtype], D, *(x.data_ptr() for x in ops),
                 out.data_ptr(), m.data_ptr(), l.data_ptr(),
                 ctypes.byref(spec), B, nq, bq, nkb, bk, kv_blocks.shape[1],
                 float(scale), stream)
    raise_on(lib, err, "salo_table_attention")
    salo_table_attention.launches += 1
    return out, m, l


salo_table_attention.launches = 0


def salo_plan_attention(q, k, v, pos, *, plan: ExecutionPlan, scale: float,
                        tables=None):
    """The whole hybrid pattern (all bands + global column) in ONE launch.

    q/k/v: (B, n_pad, D) padded working-space inputs; pos: (n_pad,)
    original positions; ``tables``: the plan's device tables
    (:func:`repro_torch.core.blockwise.plan_tables`). Returns
    ``(out, m, l)``.
    """
    if q.shape[1] != plan.n_pad:
        raise ValueError(f"q has {q.shape[1]} rows, the plan {plan.n_pad}")
    t = tables if tables is not None else plan_tables(plan, q.device)
    return salo_table_attention(
        q.contiguous(), k.contiguous(), v.contiguous(),
        pos.reshape(plan.nq, plan.block_q),
        pos.reshape(plan.nkb, plan.block_k), t.kv_blocks, t.flags,
        sched=plan.sched, scale=scale)
