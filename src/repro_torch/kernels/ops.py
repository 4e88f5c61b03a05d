"""``salo_attention``: the hybrid sparse attention op of the training path,
forward AND backward on the table-driven kernels.

The lowering pipeline (core/scheduler.py): pattern -> BandSchedule ->
ExecutionPlan. This op only does what a host must:

1. data reordering (dilation) + padding to the plan's tile grid
   (:func:`repro_torch.core.blockwise.working_stream`),
2. ONE forward launch executing the plan's step tables — every band and
   the global column fused (:func:`~repro_torch.kernels.salo_attention
   .salo_plan_attention`, K1),
3. global rows (global queries attend everything) as a tiny g-row dense
   epilogue (not a kernel launch),
4. a ``torch.autograd.Function`` whose forward saves the launch's partial
   triple ``(out_w, m, l)`` and whose backward is exactly TWO launches
   (K2: dQ over the forward tables, K3: dK/dV over the packed transposed
   tables) inside :func:`~repro_torch.core.blockwise.plan_backward`, with
   ``p`` recomputed from ``(m, l)`` — the backward never re-runs the
   forward.

The tensors' device picks the kernels (CUDA) or their plain versions
(CPU); nothing falls back. Every call books its launches into the obs
registry (``kernel_launches``, ``kernel_tiles``, ``kernel_est_hbm_bytes``
by kernel name): counted per call, as eager PyTorch has no trace time.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core.blockwise import (_global_rows, plan_backward,
                                        plan_tables, undo_working,
                                        working_stream)
from repro_torch.core.patterns import HybridSparsePattern
from repro_torch.core.scheduler import schedule
from repro_torch.kernels.salo_attention import salo_plan_attention
from repro_torch.kernels.salo_backward import (salo_plan_backward_dkv,
                                               salo_plan_backward_dq)
from repro_torch.obs.metrics import global_registry

# ONE forward launch (the paper's single-launch claim) and THREE for a
# training step's gradient under remat "full" or "dots" (forward replay for the
# residuals + dQ + dK/dV — a fourth would mean the backward re-ran the
# forward).
LAUNCH_CONTRACT = {"forward": 1, "grad": 3}


def _launch_accounting(kernel: str, plan, q, tiles: int) -> None:
    """Launch / deduplicated-tile / estimated-HBM-byte counters per call.
    Byte estimate per launch: every executed tile streams one K and one V
    tile, every query block streams its Q tile in and its output tile out.
    """
    B, _, D = q.shape
    est = B * q.element_size() * D * (2 * tiles * plan.block_k
                                      + 2 * plan.nq * plan.block_q)
    reg = global_registry()
    reg.inc("kernel_launches", kernel=kernel)
    reg.inc("kernel_tiles", B * tiles, kernel=kernel)
    reg.inc("kernel_est_hbm_bytes", est, kernel=kernel)


def _forward(q, k, v, pattern, block_q, block_k, scale):
    """One fused launch + host steps. Returns ``(out, (out_w, m, l))`` —
    the working-space partial triple, kept as backward residuals."""
    B, N, D = q.shape
    sched = schedule(pattern, N)
    plan = sched.plan(block_q, block_k)
    _launch_accounting("salo_table_attention", plan, q,
                       int(plan.num_steps.sum()))
    t = plan_tables(plan, q.device)
    qw = working_stream(q, sched, plan)
    kw = working_stream(k, sched, plan)
    vw = working_stream(v, sched, plan)
    out_w, m, l = salo_plan_attention(qw, kw, vw, t.pos, plan=plan,
                                      scale=scale, tables=t)
    out = undo_working(out_w, sched, N, plan)
    if sched.n_global > 0 and sched.global_rows:
        rows = _global_rows(q, k, v, sched, scale, q.dtype)
        out = torch.cat([rows, out[:, sched.n_global:]], dim=1)
    return out, (out_w, m, l)


class _SaloAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pattern, block_q, block_k, scale):
        out, (out_w, m, l) = _forward(q, k, v, pattern, block_q, block_k,
                                      scale)
        ctx.save_for_backward(q, k, v, out_w, m, l)
        ctx.cfg = (pattern, block_q, block_k, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out_w, m, l = ctx.saved_tensors
        pattern, block_q, block_k, scale = ctx.cfg
        plan = schedule(pattern, q.shape[1]).plan(block_q, block_k)
        _launch_accounting("salo_table_backward_dq", plan, q,
                           int(plan.num_steps.sum()))
        _launch_accounting("salo_table_backward_dkv", plan, q,
                           int(plan.transposed().num_steps.sum()))
        dq, dk, dv = plan_backward(
            g, q, k, v, out_w, m, l, plan, scale,
            functools.partial(salo_plan_backward_dq, plan=plan, scale=scale),
            functools.partial(salo_plan_backward_dkv, plan=plan,
                              scale=scale))
        return dq, dk, dv, None, None, None, None


def salo_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   pattern: HybridSparsePattern, block_q: int = 128,
                   block_k: int = 128,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Hybrid sparse attention on the table-driven kernels. q/k/v:
    (B, N, D) with B folding batch*heads; differentiable."""
    scale_ = (q.shape[-1] ** -0.5) if scale is None else float(scale)
    return _SaloAttention.apply(q, k, v, pattern, block_q, block_k, scale_)
