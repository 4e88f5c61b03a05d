"""SALO table-driven backward: the dQ (K2) and dK/dV (K3) CUDA kernels'
wrappers and their plain versions.

Both recompute the attention probabilities from the forward's saved row
stats (``p = exp(s - m) / l``, guarded so rows that attend nothing give
exactly zero). The plain versions do their arithmetic in f32: q, k, v are
widened on load, so the score product of the 16-bit q and k is exact
products summed in f32, as the TPU kernels' f32-accumulated score
product; their other products take f32 operands.

The kernels (``csrc/salo_table_backward.cu``, whose header gives the
design) keep that precision two ways:

* **f32 inputs** — the exact path: every product in f32 FMA on the CUDA
  cores (no TF32).
* **bf16 / f16 inputs** — every product on the tensor cores
  (``mma.sync.m16n8k16``, f32 accumulators). The score product takes q and
  k as they are. Each f32 operand (dout, p, ds) is split into a 16-bit
  ``hi = rn(x)`` and ``lo = rn(x - hi)`` and the partial products are
  summed in f32: ``hi @ b + lo @ b`` against a 16-bit v, k or q, and
  ``hi @ hi + hi @ lo + lo @ hi`` for ``p^T @ dout``. No f32 operand is
  rounded to 16 bits once, so dk/dv stay within ~1e-5 of f32 arithmetic
  (one rounding would move them by ~5e-3 in bf16;
  ``tests/test_torch_backward_numerics.py``). With f16 inputs dout is
  first scaled by an exact power of two that brings its largest element
  near 1 (per query row for dQ, per 64-query sub-tile for dK/dV), dQ's ds
  by one that brings its largest element near 2^15, and the sums are
  scaled back: a train step's dout (~1e-6), and the ds of far keys, lie
  below f16's normal range (bf16 has f32's). :data:`DKV_TOL`, :data:`DQ_OFF_SHARE` and :func:`dq_off_share`
  state what the card checks hold them to. Bound on the card:
  operations, each product once at the 16-bit tensor rate (6 x hd flops
  per attended pair for dQ, 8 x hd for dK/dV); the split runs 10 x hd and
  16 x hd.

* **dQ** (:func:`salo_table_backward_dq`, ``csrc/salo_table_backward.cu``)
  replays the FORWARD tables: ``ds = p * (dout.v - delta)``,
  ``dq_i = scale * sum_j ds_ij k_j``. Replaces the TPU kernel
  ``repro/kernels/salo_backward.py::salo_table_backward_dq``
  (body ``_dq_kernel``).
* **dK/dV** (:func:`salo_table_backward_dkv`) walks the PACKED transposed
  tables with the owner KV tile resident: ``dv_j = sum_i p_ij dout_i``,
  ``dk_j = scale * sum_i ds_ij q_i``. Per-row partials are summed per
  owner tile in ascending row order — a fixed order, so two runs give
  bitwise-equal dK/dV (on the 16-bit path a tile with one packed row is
  written by the row walk itself). Replaces ``salo_table_backward_dkv``
  (body ``_dkv_kernel`` and the scatter-add after it).

The ``delta = sum(dout * out)`` precompute and the host-step adjoints live
in :func:`repro_torch.core.blockwise.plan_backward`.

Each wrapper takes its plain version (``table_dq_scan`` /
``table_dkv_scan`` of :mod:`repro_torch.core.blockwise`) ONLY for CPU
tensors; for CUDA tensors it launches the kernel or raises. ``.launches``
counts kernel launches (two per dK/dV call: the row walk and the owner-tile
sum), ``_plain.calls`` plain-version calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.blockwise import (plan_tables, table_dkv_scan,
                                        table_dq_scan)
from repro_torch.core.scheduler import BandSchedule, ExecutionPlan
from repro_torch.kernels.salo_attention import (DTYPE_CODE, bind,
                                                check_kernel_operands,
                                                check_tables, mask_spec,
                                                raise_on)


# What the kernels are held to against the f32 plain versions, on the card
# (chip_smoke.py, tests/test_torch_cuda.py) and in the CPU emulation of the
# 16-bit split (tests/test_torch_backward_numerics.py), which shows one
# 16-bit rounding of dout, p and ds outside both. dk/dv (f32 outputs):
# DKV_TOL, abs and rel. dq, returned in the inputs' type: with 16-bit
# inputs, equal to the plain f32 dq rounded to that type on all but
# DQ_OFF_SHARE of its elements (the split leaves ~0.5 % a rounding apart,
# one rounding ~50 %).
DKV_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3, torch.float16: 1e-4}
DQ_OFF_SHARE = 0.02


def dq_off_share(dq: torch.Tensor, dq_f32: torch.Tensor) -> float:
    """The share of the elements of ``dq`` that differ from the f32
    ``dq_f32`` rounded to ``dq``'s type."""
    return float((dq != dq_f32.to(dq.dtype)).float().mean())


def _check_shapes(what, dout, delta, m, l, q, k, v, pos_q, pos_k):
    B, nQ, D = q.shape
    nq, bq = pos_q.shape
    nkb, bk = pos_k.shape
    if (nq * bq != nQ or dout.shape != q.shape
            or any(x.shape != (B, nQ) for x in (delta, m, l))
            or k.shape != (B, nkb * bk, D) or v.shape != k.shape):
        raise ValueError(
            f"{what}: dout {tuple(dout.shape)}, delta/m/l "
            f"{tuple(delta.shape)}/{tuple(m.shape)}/{tuple(l.shape)}, q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
            f"pos_q {tuple(pos_q.shape)}, pos_k {tuple(pos_k.shape)} do not "
            f"fit")


def _check_cuda(what, q, k, v, dout, delta, m, l, tensors, bq, bk):
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, got {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: k/v dtype {k.dtype}/{v.dtype} must equal "
                        f"q's {q.dtype}")
    if any(x.dtype != torch.float32 for x in (dout, delta, m, l)):
        raise TypeError(f"{what}: dout/delta/m/l must be float32")
    check_kernel_operands(what, tensors, dtype=q.dtype, hd=q.shape[2],
                          block_q=bq, block_k=bk)


# ------------------------------- dQ (K2) ------------------------------- #
def salo_table_backward_dq_plain(dout, delta, m, l, q, k, v, pos_q, pos_k,
                                 kv_blocks, flags, *, sched: BandSchedule,
                                 scale: float) -> torch.Tensor:
    """The plain version: :func:`repro_torch.core.blockwise.table_dq_scan`
    (returns f32)."""
    salo_table_backward_dq_plain.calls += 1
    return table_dq_scan(dout, delta, m, l, q, k, v, pos_q, pos_k,
                         kv_blocks, flags, sched, scale)


salo_table_backward_dq_plain.calls = 0


def salo_table_backward_dq(dout, delta, m, l, q, k, v, pos_q, pos_k,
                           kv_blocks, flags, *, sched: BandSchedule,
                           scale: float) -> torch.Tensor:
    """dQ in ONE launch over forward step tables.

    q-side: q (B, nq*bq, D) in the compute dtype, dout f32 of q's shape,
    delta/m/l f32 (B, nq*bq); KV side: k/v (B, nkb*bk, D); pos_q (nq, bq),
    pos_k (nkb, bk), kv_blocks/flags (nq, W) int32. Returns dq in q's
    dtype.
    """
    what = "salo_table_backward_dq"
    _check_shapes(what, dout, delta, m, l, q, k, v, pos_q, pos_k)
    check_tables(what, pos_q, pos_k, kv_blocks, flags)
    if kv_blocks.shape != flags.shape or kv_blocks.shape[0] != pos_q.shape[0]:
        raise ValueError(f"{what}: tables {tuple(kv_blocks.shape)}/"
                         f"{tuple(flags.shape)} do not fit pos_q "
                         f"{tuple(pos_q.shape)}")
    if q.device.type == "cpu":
        return salo_table_backward_dq_plain(
            dout, delta, m, l, q, k, v, pos_q, pos_k, kv_blocks, flags,
            sched=sched, scale=scale).to(q.dtype)
    ops = (dout, delta, m, l, q, k, v, pos_q, pos_k, kv_blocks, flags)
    nq, bq = pos_q.shape
    nkb, bk = pos_k.shape
    _check_cuda(what, q, k, v, dout, delta, m, l, ops, bq, bk)
    lib, fn = bind("salo_table_backward", "salo_table_backward_dq", 12, 6)
    dq = torch.empty_like(q)
    spec = mask_spec(sched)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(DTYPE_CODE[q.dtype], q.shape[2],
                 *(x.data_ptr() for x in ops), dq.data_ptr(),
                 ctypes.byref(spec), q.shape[0], nq, bq, nkb, bk,
                 kv_blocks.shape[1], float(scale), stream)
    raise_on(lib, err, what)
    salo_table_backward_dq.launches += 1
    return dq


salo_table_backward_dq.launches = 0


def salo_plan_backward_dq(dout, delta, m, l, q, k, v, pos, *,
                          plan: ExecutionPlan, scale: float) -> torch.Tensor:
    """dQ over the forward plan. All arrays working-space padded:
    q/k/v/dout (B, n_pad, D); delta/m/l (B, n_pad); pos (n_pad,)."""
    t = plan_tables(plan, q.device)
    return salo_table_backward_dq(
        dout.contiguous(), delta.contiguous(), m, l, q.contiguous(),
        k.contiguous(), v.contiguous(), pos.reshape(plan.nq, plan.block_q),
        pos.reshape(plan.nkb, plan.block_k), t.kv_blocks, t.flags,
        sched=plan.sched, scale=scale)


# ------------------------------ dK/dV (K3) ------------------------------ #
def salo_table_backward_dkv_plain(dout, delta, m, l, q, k, v, pos_q, pos_k,
                                  row_tile, q_blocks, flags, *,
                                  sched: BandSchedule, scale: float):
    """The plain version: :func:`repro_torch.core.blockwise.table_dkv_scan`
    (the packed-row walk plus the owner-tile sum)."""
    salo_table_backward_dkv_plain.calls += 1
    return table_dkv_scan(dout, delta, m, l, q, k, v, pos_q, pos_k,
                          row_tile, q_blocks, flags, sched, scale)


salo_table_backward_dkv_plain.calls = 0


def salo_table_backward_dkv(dout, delta, m, l, q, k, v, pos_q, pos_k,
                            row_tile, q_blocks, flags, *,
                            sched: BandSchedule, scale: float):
    """dK and dV in ONE wrapper call over PACKED transposed tables.

    Shapes as :func:`salo_table_backward_dq`, plus row_tile (R,) and
    q_blocks/flags (R, W) int32. Returns ``(dk, dv)``, both
    (B, nkb*bk, D) float32. On the card the call runs the row walk and
    then the fixed-order owner-tile sum, two launches on one stream, and
    adds 2 to ``.launches``.
    """
    what = "salo_table_backward_dkv"
    _check_shapes(what, dout, delta, m, l, q, k, v, pos_q, pos_k)
    check_tables(what, pos_q, pos_k, row_tile, q_blocks, flags)
    R = row_tile.shape[0]
    if row_tile.dim() != 1 or q_blocks.shape != flags.shape \
            or q_blocks.shape[0] != R:
        raise ValueError(f"{what}: row_tile {tuple(row_tile.shape)} and "
                         f"tables {tuple(q_blocks.shape)}/"
                         f"{tuple(flags.shape)} do not fit")
    if q.device.type == "cpu":
        return salo_table_backward_dkv_plain(
            dout, delta, m, l, q, k, v, pos_q, pos_k, row_tile, q_blocks,
            flags, sched=sched, scale=scale)
    ops = (dout, delta, m, l, q, k, v, pos_q, pos_k, row_tile, q_blocks,
           flags)
    B, _, D = q.shape
    nq, bq = pos_q.shape
    nkb, bk = pos_k.shape
    _check_cuda(what, q, k, v, dout, delta, m, l, ops, bq, bk)
    lib, fn = bind("salo_table_backward", "salo_table_backward_dkv", 16, 7)
    f32 = dict(dtype=torch.float32, device=q.device)
    part_dk = torch.empty((B, R * bk, D), **f32)
    part_dv = torch.empty((B, R * bk, D), **f32)
    dk = torch.empty((B, nkb * bk, D), **f32)
    dv = torch.empty((B, nkb * bk, D), **f32)
    spec = mask_spec(sched)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(DTYPE_CODE[q.dtype], D, *(x.data_ptr() for x in ops),
                 part_dk.data_ptr(), part_dv.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), ctypes.byref(spec), B, nq, bq, nkb, bk, R,
                 q_blocks.shape[1], float(scale), stream)
    raise_on(lib, err, what)
    salo_table_backward_dkv.launches += 2      # row walk + owner-tile sum
    return dk, dv


salo_table_backward_dkv.launches = 0


def salo_plan_backward_dkv(dout, delta, m, l, q, k, v, pos, *,
                           plan: ExecutionPlan, scale: float):
    """dK and dV over the packed transposed plan. Returns ``(dk, dv)``,
    both (B, n_pad, D) f32, working-space padded."""
    t = plan_tables(plan, q.device)
    return salo_table_backward_dkv(
        dout.contiguous(), delta.contiguous(), m, l, q.contiguous(),
        k.contiguous(), v.contiguous(), pos.reshape(plan.nq, plan.block_q),
        pos.reshape(plan.nkb, plan.block_k), t.row_tile, t.q_blocks,
        t.pk_flags, sched=plan.sched, scale=scale)
