"""Runtime ExecutionPlans: content-based step tables built on the device.

The port of :mod:`repro.core.dynamic`. The static scheduler decides from
the pattern alone which KV tiles each query block visits; this module
predicts it from the *content* (Dynamic Sparse Attention,
arXiv:2110.11299; the estimator follows SEA's pooled-score idea): estimate
every (q-block, kv-tile) pair's attention mass from pooled q·k scores,
keep the top-``keep`` tiles per query block, and emit ``(kv_blocks,
flags)`` as int32 tensors on the inputs' device that honour the contract
of :mod:`repro_torch.core.plan_contract` — so the table-driven kernels
(K1 forward, K2 dQ) run query-adaptive sparsity on tables they have never
seen on the host.

Three load-bearing properties, as in the reference:

* **Selection is a subset of the static plan's visits.** Candidates are
  the static plan's steps, and a selected step keeps its ORIGINAL flags,
  so ``step_mask`` applies the same union mask; full keep (``keep >=
  max_steps``) reproduces the static tables exactly.
* **The never-drop guarantee.** Steps whose tile is causal-local to the
  row (within ``local_window`` original positions) or carries global/sink
  columns (``STEP_GLOBAL``) get ``+inf`` selection score. ``keep`` must
  cover the worst-case always-kept count (checked, raises).
* **The selector is gradient-free.** q and k enter the estimator detached
  and under ``torch.no_grad()``; training treats the selected table like
  the static one. The forward saves the ``(nq, keep)`` int32 tables for
  the backward (the reference replays the deterministic selection from
  its residuals; the tables are the same): dQ runs K2 on them, dK/dV the
  scatter twin :func:`repro_torch.core.blockwise.table_dkv_scatter_scan`,
  since the host-packed transposed walk K3 consumes cannot be built for
  device tables.

One table serves every flat head and batch row: :func:`block_scores`
averages the estimate over the flat batch, so one K1 launch and one K2
launch carry the whole call.

Selected rows are re-sorted into ascending-tile order with right-aligned
padding, the static builder's layout. Ties in the top-k break as
``jax.lax.top_k`` breaks them (lower step first): a stable descending
sort, since ``torch.topk`` leaves the order of ties unspecified.

The registry counters ``dynamic_plan_builds`` and ``dynamic_plan_keep_ratio``
are booked per call (eager PyTorch has no trace time), from host-side
numbers only: the static candidate flags and ``keep``. No table value is
read back on the call path; :func:`dynamic_tables` (inspection) runs the
full value check of the table contract.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.blockwise import (_global_rows, plan_backward,
                                        plan_tables, table_dkv_scatter_scan,
                                        undo_working, working_stream)
from repro_torch.core.patterns import HybridSparsePattern
from repro_torch.core.plan_contract import (PAD_SENTINEL, STEP_GLOBAL,
                                            validate_tables)
from repro_torch.core.scheduler import ExecutionPlan, schedule
from repro_torch.kernels.ops import _launch_accounting
from repro_torch.kernels.salo_attention import salo_table_attention
from repro_torch.kernels.salo_backward import salo_table_backward_dq
from repro_torch.obs.metrics import global_registry

_I32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class DynamicConfig:
    """How to select: ``keep`` tiles per query block.

    ``local_window``: original-position distance under which a tile is
    causal-local and therefore always kept (default: one tile span,
    ``max(block_q, block_k)``). ``pool_k``: key-side pooling granularity
    for the mass estimator — keys are mean-pooled per ``pool_k``-slot
    group and groups reduce by logsumexp, so ``None`` (= whole tile) is
    the cheapest plain block-mean while small values track a tile's
    exp-mass closely; must divide ``block_k``.
    """
    keep: int
    local_window: Optional[int] = None
    pool_k: Optional[int] = None


def _resolve_window(cfg: DynamicConfig, block_q: int, block_k: int) -> int:
    if cfg.local_window is not None:
        return int(cfg.local_window)
    return max(block_q, block_k)


def always_keep_mask(kv_blocks: np.ndarray, flags: np.ndarray,
                     pos_q: np.ndarray, pos_k: np.ndarray,
                     local_window: int, causal: bool) -> np.ndarray:
    """The never-drop set, on the host: which steps of a candidate table
    are exempt from selection. A step is always kept when its tile carries
    global columns (``STEP_GLOBAL``) or is local to the row — the tile's
    original-position range overlaps ``[row_min - local_window, row_max]``
    (``row_max + local_window`` when not causal). Ranges are taken over
    valid (non-``PAD_SENTINEL``) slots; all-padding tiles/rows never
    match. Returns a boolean (nq, W) mask; padding steps are False.
    """
    kv_blocks = np.asarray(kv_blocks)
    flags = np.asarray(flags)
    vq = pos_q < PAD_SENTINEL
    pq = pos_q.astype(np.int64)
    qlo = np.where(vq, pq, np.iinfo(np.int64).max).min(axis=1)
    qhi = np.where(vq, pq, -1).max(axis=1)
    vk = pos_k < PAD_SENTINEL
    pk = pos_k.astype(np.int64)
    klo = np.where(vk, pk, np.iinfo(np.int64).max).min(axis=1)
    khi = np.where(vk, pk, -1).max(axis=1)

    tlo = klo[kv_blocks]                                   # (nq, W)
    thi = khi[kv_blocks]
    lo_q = qlo[:, None]
    hi_q = qhi[:, None]
    reach = hi_q if causal else hi_q + local_window
    local = (thi >= lo_q - local_window) & (tlo <= reach)
    local &= (thi >= 0) & (hi_q >= 0)      # all-padding tile / row: never
    keep = ((flags & STEP_GLOBAL) != 0) | local
    return keep & (flags != 0)


@functools.lru_cache(maxsize=256)
def _plan_always_keep(plan: ExecutionPlan, local_window: int) -> np.ndarray:
    pos = plan.positions_padded()
    return always_keep_mask(
        plan.kv_blocks, plan.flags,
        pos.reshape(plan.nq, plan.block_q),
        pos.reshape(plan.nkb, plan.block_k),
        local_window, plan.sched.causal)


def plan_always_keep(plan: ExecutionPlan, local_window: int) -> np.ndarray:
    """The (nq, max_steps) never-drop mask of a static plan."""
    return _plan_always_keep(plan, int(local_window))


@functools.lru_cache(maxsize=64)
def _always_on(plan: ExecutionPlan, local_window: int,
               device: torch.device) -> torch.Tensor:
    """The never-drop mask uploaded to ``device`` once per (plan, window,
    device), as :func:`~repro_torch.core.blockwise.plan_tables` does for
    the static tables."""
    return torch.as_tensor(_plan_always_keep(plan, local_window)).to(device)


def check_keep(keep: int, always: np.ndarray, what: str = "plan") -> None:
    """The never-drop guarantee needs room: ``keep`` must cover the largest
    per-row always-kept count, else top-k would be forced to drop a
    correctness-critical tile. Host check — raises ValueError."""
    need = int(np.asarray(always).sum(axis=-1).max()) if always.size else 0
    if keep < need:
        raise ValueError(
            f"dynamic keep={keep} is below the {what}'s worst-case "
            f"always-kept count {need} (causal-local + global tiles); "
            f"raise keep or shrink local_window")


def _kept_steps(flags, keep: int) -> Tuple[int, int]:
    """(candidate steps, steps the selected tables execute), from the
    static candidate flags: a row keeps ``min(real steps, keep)``."""
    real = (np.asarray(flags) != 0).sum(axis=-1)
    return int(real.sum()), int(np.minimum(real, keep).sum())


def _account_build(flags, keep: int) -> int:
    """Keep-ratio accounting per call, from host-side numbers only (no
    table value is read). Returns the executed step count."""
    total, kept = _kept_steps(flags, keep)
    reg = global_registry()
    reg.inc("dynamic_plan_builds")
    reg.observe("dynamic_plan_keep_ratio", kept / max(total, 1))
    return kept


def block_scores(q, k, pos_q, pos_k, scale: float,
                 pool_k: Optional[int] = None) -> torch.Tensor:
    """Pooled per-(q-block, kv-tile) attention-mass estimate, (nq, nkb) f32.

    Queries are mean-pooled per block over valid slots — by linearity the
    pooled score IS the exact mean of the block's pairwise scores. Keys
    are mean-pooled per ``pool_k``-slot group and the groups reduce by
    logsumexp (with the whole tile as one group this is the plain block
    mean). The flat batch (batch x heads) reduces by mean, so one table
    serves every head. Cost is ``N^2 D / (block_q * pool_k)``.
    q: (B, nq*bq, D); k: (B, nkb*bk, D); pos_q (nq, bq), pos_k (nkb, bk)
    int tensors on q's device.
    """
    B, _, D = q.shape
    nq, bq = pos_q.shape
    nkb, bk = pos_k.shape
    pk = bk if pool_k is None else int(pool_k)
    if bk % pk:
        raise ValueError(f"pool_k={pk} must divide block_k={bk}")
    S = bk // pk
    vq = pos_q < PAD_SENTINEL                                   # (nq, bq)
    vk = (pos_k < PAD_SENTINEL).reshape(nkb, S, pk)
    qf = q.float().reshape(B, nq, bq, D)
    kf = k.float().reshape(B, nkb, S, pk, D)
    qp = (qf * vq[None, :, :, None]).sum(2) \
        / vq.sum(1).clamp(min=1)[None, :, None]                 # (B, nq, D)
    kcnt = vk.sum(2)                                            # (nkb, S)
    kp = (kf * vk[None, :, :, :, None]).sum(3) \
        / kcnt.clamp(min=1)[None, :, :, None]                   # (B,nkb,S,D)
    s = torch.einsum("bqd,bksd->bqks", qp, kp) * scale
    s = torch.where((kcnt > 0)[None, None], s, -torch.inf)
    est = torch.logsumexp(s, dim=-1)                            # (B,nq,nkb)
    return est.mean(0)


def select_steps(q, k, kv_blocks, flags, pos_q, pos_k, always, keep: int,
                 scale: float, pool_k: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``keep`` content selection over a candidate step table.

    ``always`` steps score ``+inf`` (never dropped), padding steps
    ``-inf`` (picked only when a row has fewer than ``keep`` real steps,
    and re-emitted as contract padding: flags 0, tile 0). Ties break to
    the lower step, as ``jax.lax.top_k``. Output rows are ascending-tile,
    right-padded. The candidate tables (int32), the (nq, W) bool mask
    ``always`` and the positions are tensors on q's device. Returns
    ``(kv_blocks, flags)``, contiguous int32 (nq, keep) tensors.
    """
    with torch.no_grad():
        est = block_scores(q.detach(), k.detach(), pos_q, pos_k, scale,
                           pool_k)                             # (nq, nkb)
        kvb = kv_blocks.long()
        step_est = torch.gather(est, 1, kvb)                   # (nq, W)
        score = torch.where(always, torch.inf, step_est)
        score = torch.where(flags != 0, score, -torch.inf)
        vals, idx = torch.sort(score, dim=1, descending=True, stable=True)
        vals, idx = vals[:, :keep], idx[:, :keep]
        sel_f = torch.where(vals > -torch.inf, torch.gather(flags, 1, idx),
                            0)
        sel_t = torch.where(sel_f != 0, torch.gather(kvb, 1, idx), 0)
        order = torch.argsort(torch.where(sel_f != 0, sel_t, _I32_MAX),
                              dim=1, stable=True)
        sel_t = torch.gather(sel_t, 1, order)
        sel_f = torch.gather(sel_f, 1, order)
    return (sel_t.to(torch.int32).contiguous(),
            sel_f.to(torch.int32).contiguous())


def _prep(pattern: HybridSparsePattern, N: int, cfg: DynamicConfig,
          block_q: int, block_k: int):
    sched = schedule(pattern, N)
    plan = sched.plan(block_q, block_k)
    window = _resolve_window(cfg, block_q, block_k)
    always = _plan_always_keep(plan, window)
    keep = min(int(cfg.keep), plan.max_steps)
    check_keep(keep, always)
    return sched, plan, window, keep


def _selected(qw, kw, plan: ExecutionPlan, cfg: DynamicConfig, window: int,
              keep: int, scale: float):
    """The selected tables for working-layout q/k, built on their device
    from the cached static tables."""
    t = plan_tables(plan, qw.device)
    return select_steps(
        qw, kw, t.kv_blocks, t.flags, t.pos.reshape(plan.nq, plan.block_q),
        t.pos.reshape(plan.nkb, plan.block_k),
        _always_on(plan, window, qw.device), keep, scale, cfg.pool_k)


def dynamic_tables(q, k, pattern: HybridSparsePattern, cfg: DynamicConfig,
                   *, block_q: int = 128, block_k: int = 128,
                   scale: Optional[float] = None):
    """Materialize the selected tables for inspection (tests, the card
    smoke). q/k: (B, N, D) flat. Returns ``(plan, kv_blocks, flags,
    always)``: int32 (nq, keep) tensors on q's device on the plan's working
    grid, checked against the full table contract, and the (nq, max_steps)
    numpy never-drop mask."""
    B, N, D = q.shape
    scale = (D ** -0.5) if scale is None else scale
    sched, plan, window, keep = _prep(pattern, N, cfg, block_q, block_k)
    kvt, flg = _selected(working_stream(q, sched, plan),
                         working_stream(k, sched, plan), plan, cfg, window,
                         keep, scale)
    validate_tables(kvt, flg, nkb=plan.nkb, name="dynamic tables")
    return plan, kvt, flg, _plan_always_keep(plan, window)


def _dyn_forward(q, k, v, pattern, cfg, block_q, block_k, scale):
    """Selection on the device, then ONE K1 launch on the selected tables.
    Returns ``(out, (out_w, m, l), (kvt, flg))``."""
    B, N, D = q.shape
    sched, plan, window, keep = _prep(pattern, N, cfg, block_q, block_k)
    qw = working_stream(q, sched, plan).contiguous()
    kw = working_stream(k, sched, plan).contiguous()
    vw = working_stream(v, sched, plan).contiguous()
    kvt, flg = _selected(qw, kw, plan, cfg, window, keep, scale)
    # shapes and dtypes only: a value check would copy the tables to the
    # host on every call
    validate_tables(kvt, flg, nkb=plan.nkb, name="dynamic tables",
                    values=False)
    kept = _account_build(plan.flags, keep)
    _launch_accounting("salo_table_attention", plan, q, kept)
    pos = plan_tables(plan, q.device).pos
    out_w, m, l = salo_table_attention(
        qw, kw, vw, pos.reshape(plan.nq, plan.block_q),
        pos.reshape(plan.nkb, plan.block_k), kvt, flg, sched=sched,
        scale=scale)
    out = undo_working(out_w, sched, N, plan)
    if sched.n_global > 0 and sched.global_rows:
        rows = _global_rows(q, k, v, sched, scale, q.dtype)
        out = torch.cat([rows, out[:, sched.n_global:]], dim=1)
    return out, (out_w, m, l), (kvt, flg)


class _DynamicAttention(torch.autograd.Function):
    """The reference's ``custom_vjp``: the forward saves the selected
    tables beside the partial triple, the backward is the shared
    :func:`~repro_torch.core.blockwise.plan_backward` with K2 on those
    tables (dQ) and the scatter twin (dK/dV)."""

    @staticmethod
    def forward(ctx, q, k, v, pattern, cfg, block_q, block_k, scale):
        out, (out_w, m, l), (kvt, flg) = _dyn_forward(
            q, k, v, pattern, cfg, block_q, block_k, scale)
        ctx.save_for_backward(q, k, v, out_w, m, l, kvt, flg)
        ctx.cfg = (pattern, cfg, block_q, block_k, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out_w, m, l, kvt, flg = ctx.saved_tensors
        pattern, cfg, block_q, block_k, scale = ctx.cfg
        sched, plan, _, keep = _prep(pattern, q.shape[1], cfg, block_q,
                                     block_k)
        _launch_accounting("salo_table_backward_dq", plan, q,
                           _kept_steps(plan.flags, keep)[1])
        pos = plan_tables(plan, q.device).pos
        pos_q = pos.reshape(plan.nq, plan.block_q)
        pos_k = pos.reshape(plan.nkb, plan.block_k)

        def dq_engine(dout, delta, m_, l_, qw, kw, vw, _pos):
            return salo_table_backward_dq(
                dout.contiguous(), delta.contiguous(), m_, l_,
                qw.contiguous(), kw.contiguous(), vw.contiguous(), pos_q,
                pos_k, kvt, flg, sched=sched, scale=scale)

        def dkv_engine(dout, delta, m_, l_, qw, kw, vw, _pos):
            return table_dkv_scatter_scan(dout, delta, m_, l_, qw, kw, vw,
                                          pos_q, pos_k, kvt, flg, sched,
                                          scale)

        dq, dk, dv = plan_backward(g, q, k, v, out_w, m, l, plan, scale,
                                   dq_engine, dkv_engine)
        return dq, dk, dv, None, None, None, None, None


def dynamic_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      pattern: HybridSparsePattern, cfg: DynamicConfig, *,
                      block_q: int = 128, block_k: int = 128,
                      scale: Optional[float] = None,
                      impl: str = "blockwise") -> torch.Tensor:
    """Content-based dynamically-sparse attention. q/k/v: (B, N, D), B
    folding batch*heads; differentiable.

    The static plan supplies the candidate visits and masks; per query
    block only the ``cfg.keep`` highest estimated-mass tiles execute
    (never dropping causal-local/global tiles). ``impl`` ``"blockwise"``
    and ``"pallas"`` are the same here: the tensors' device picks K1/K2 or
    their plain versions.
    """
    if impl not in ("blockwise", "pallas"):
        raise ValueError(
            f"plan='dynamic' needs a table-driven engine, got impl={impl!r}")
    scale_ = (q.shape[-1] ** -0.5) if scale is None else float(scale)
    return _DynamicAttention.apply(q, k, v, pattern, cfg, block_q, block_k,
                                   scale_)
