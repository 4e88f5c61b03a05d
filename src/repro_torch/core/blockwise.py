"""Plan-driven blockwise attention in plain torch.

The port of :mod:`repro.core.blockwise`: the plain engines that walk the
same :class:`repro_torch.core.scheduler.ExecutionPlan` step tables with the
same per-step masks (``sched.step_mask``) as the kernels, folded through
the same guarded online softmax. They are what the kernel wrappers run for
CPU tensors, and what ``chip_smoke.py`` holds the kernels against on the
card.

* :func:`working_stream` / :func:`undo_working` — dilation reorder + pad
  to the tile grid, and back;
* :func:`table_attention_scan` — the table-driven forward, emitting the
  normalized partial triple ``(out, m, l)``;
* :func:`_global_rows` — the dense g-row epilogue (global queries attend
  every key);
* :func:`table_dq_scan` / :func:`table_dkv_scan` — the two gradient
  passes, recomputing ``p`` from the saved ``(m, l)`` (:func:`p_from_stats`);
* :func:`table_dkv_scatter_scan` — the dK/dV pass over forward-shaped
  tables built on the device (runtime plans, :mod:`repro_torch.core
  .dynamic`), which have no packed transposed walk;
* :func:`plan_backward` — THE backward contract: host-step adjoints around
  two plan-walking gradient passes, parameterized over the engines;
* :func:`chunk_attention` — the serving prefill engine.

Each table walk is a Python loop over the table width (the reference's
``lax.scan``). The XLA-only fast path of the reference's ``_plan_partial``
is not ported: it visits the same tiles in the same order as the general
table walk, which gives the same result.

Shapes: q, k, v are ``(B, N, D)`` where ``B`` folds batch*heads.
"""
from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import renorm
from repro_torch.core.patterns import HybridSparsePattern
from repro_torch.core.scheduler import (BandSchedule, ExecutionPlan,
                                        causal_step_mask)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b^T`` over the last axis, in f32 from exact f32 copies of the
    operands (the reference's ``preferred_element_type=f32`` contraction)."""
    return torch.matmul(a.float(), b.float().transpose(-1, -2))


class PlanTables(NamedTuple):
    """A plan's tables as int32 tensors on one device."""
    pos: torch.Tensor         # (n_pad,) original position per working slot
    kv_blocks: torch.Tensor   # (nq, W) forward tables
    flags: torch.Tensor       # (nq, W)
    row_tile: torch.Tensor    # (R,) packed transposed tables
    q_blocks: torch.Tensor    # (R, Wt)
    pk_flags: torch.Tensor    # (R, Wt)
    perm: Optional[torch.Tensor]      # (n_work,) working slot -> position
    inv_perm: Optional[torch.Tensor]  # (n,) position -> working slot


@functools.lru_cache(maxsize=64)
def plan_tables(plan: ExecutionPlan, device: torch.device) -> PlanTables:
    """The plan's host-built tables uploaded to ``device`` once per
    (plan, device) and cached, so a train step copies no table per layer."""
    pk = plan.transposed_packed()
    sched = plan.sched

    def t(a):
        return torch.as_tensor(a, dtype=torch.int32).to(device)

    return PlanTables(
        pos=t(plan.positions_padded()), kv_blocks=t(plan.kv_blocks),
        flags=t(plan.flags), row_tile=t(pk.row_tile), q_blocks=t(pk.q_blocks),
        pk_flags=t(pk.flags),
        perm=None if sched.perm is None else t(sched.perm),
        inv_perm=None if sched.perm is None else t(sched.inverse_perm()))


# ---------------------------------------------------------------------- #
# Working-stream host steps (shared by both engines, forward AND backward)
# ---------------------------------------------------------------------- #
def working_stream(x: torch.Tensor, sched: BandSchedule,
                   plan: ExecutionPlan) -> torch.Tensor:
    """Original order -> working layout: dilation reorder + pad to n_pad.

    ``x``: (B, N, ...) along axis 1. The reorder is a permutation, so this
    transform is also the ADJOINT of the output un-reordering — the same
    function maps inputs forward and output-cotangents backward.
    """
    N = x.shape[1]
    if sched.reordered:
        perm = plan_tables(plan, x.device).perm
        take = perm.clamp(0, N - 1)
        valid = (perm < N).reshape((1, -1) + (1,) * (x.ndim - 2))
        x = torch.where(valid, x.index_select(1, take), 0).to(x.dtype)
    pad = plan.n_pad - x.shape[1]
    if pad:
        x = F.pad(x, [0, 0] * (x.ndim - 2) + [0, pad])
    return x


def undo_working(x_w: torch.Tensor, sched: BandSchedule, n: int,
                 plan: ExecutionPlan) -> torch.Tensor:
    """Working layout -> original order (inverse of :func:`working_stream`)."""
    if sched.reordered:
        return x_w.index_select(1, plan_tables(plan, x_w.device).inv_perm)
    return x_w[:, :n]


# ---------------------------------------------------------------------- #
# The forward
# ---------------------------------------------------------------------- #
def _table_fold(state, q_blk, k_r, v_r, pos_q, pos_k, kv_blocks, flags,
                sched: BandSchedule, scale: float):
    """Fold step tables into a renorm state, one table column per step,
    gathering each step's KV tile.

    q_blk: (B, nq, Bq, D); k_r/v_r: (B, nkb, Bk, D); pos_q: (nq, Bq);
    pos_k: (nkb, Bk); kv_blocks/flags: (nq, W) int32 tensors.
    """
    for s in range(kv_blocks.shape[1]):
        blk = kv_blocks[:, s]                                  # (nq,)
        fl = flags[:, s]
        k_blk = k_r.index_select(1, blk)                       # (B,nq,Bk,D)
        v_blk = v_r.index_select(1, blk)
        pos_kb = pos_k.index_select(0, blk)                    # (nq, Bk)
        scores = _dot(q_blk, k_blk) * scale
        mask = sched.step_mask(pos_q[:, :, None], pos_kb[:, None, :],
                               fl[:, None, None])
        state = renorm.update(state, scores, v_blk, mask[None])
    return state


def table_attention_scan(q, k, v, pos_q, pos_k, kv_blocks, flags,
                         sched: BandSchedule, scale: float):
    """Table-driven forward: q (B, nq*Bq, D); k/v (B, nkb*Bk, D); pos_q
    (nq, Bq); pos_k (nkb, Bk) ORIGINAL positions; kv_blocks/flags (nq, W).
    Returns the normalized partial triple ``(out, m, l)`` — out in q's
    dtype, m/l (B, nq*Bq) f32; rows that attend nothing give
    ``(0, NEG_INF, 0)``."""
    B, nQ, D = q.shape
    nq, bq = pos_q.shape
    nkb, bk = pos_k.shape
    st = renorm.empty_state((B, nq, bq), D, q.device)
    st = _table_fold(st, q.reshape(B, nq, bq, D), k.reshape(B, nkb, bk, D),
                     v.reshape(B, nkb, bk, D), pos_q, pos_k, kv_blocks,
                     flags, sched, scale)
    out = renorm.finalize(st, q.dtype).reshape(B, nQ, D)
    return out, st.m.reshape(B, nQ), st.l.reshape(B, nQ)


def _global_rows(q_orig, k_orig, v_orig, sched: BandSchedule, scale: float,
                 out_dtype):
    """Global-row pass: the first n_global queries attend ALL keys (original
    order) — SALO's global PE row. Returns (B, g, D). Differentiable."""
    g, n = sched.n_global, sched.n
    scores = _dot(q_orig[:, :g], k_orig[:, :n]) * scale         # (B, g, n)
    if sched.causal:
        dev = q_orig.device
        mask = (torch.arange(n, device=dev)[None, :]
                <= torch.arange(g, device=dev)[:, None])[None]
        scores = torch.where(mask, scores, renorm.NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.matmul(p, v_orig[:, :n].float()).to(out_dtype)


# ---------------------------------------------------------------------- #
# The backward contract: shared host steps + the plain gradient engines
# ---------------------------------------------------------------------- #
def p_from_stats(scores, mask, m, l):
    """Recompute normalized attention probabilities from saved row stats:
    ``p = exp(s - m) / l`` on the masked scaled score. Empty rows (every
    step masked; the forward emitted ``(0, NEG_INF, 0)``) take the guarded
    branch (shift 0, l 1) and end at exactly ``p == 0`` via the mask."""
    l_safe = torch.where(l == 0.0, 1.0, l)
    shift = torch.where(m <= renorm.NEG_INF / 2, 0.0, m)
    p = torch.exp(scores - shift[..., None]) / l_safe[..., None]
    return torch.where(mask, p, 0.0)


def table_dq_scan(dout, delta, m, l, q, k, v, pos_q, pos_k, kv_blocks,
                  flags, sched: BandSchedule, scale: float) -> torch.Tensor:
    """dQ pass over FORWARD step tables:
    ``ds = p * (dout.v - delta);  dq_i += scale * sum_j ds_ij k_j``.

    q-side arrays (dout/delta/m/l/q) are (B, nq*Bq, ...), KV-side (k/v)
    (B, nkb*Bk, D); pos_q (nq, Bq); pos_k (nkb, Bk); kv_blocks/flags
    (nq, W). Returns (B, nq*Bq, D) f32.
    """
    B, nQ, D = q.shape
    nq, bq = pos_q.shape
    nkb, bk = pos_k.shape
    q_blk = q.reshape(B, nq, bq, D)
    do_blk = dout.reshape(B, nq, bq, D)
    m_blk, l_blk = m.reshape(B, nq, bq), l.reshape(B, nq, bq)
    dl_blk = delta.reshape(B, nq, bq)
    k_r = k.reshape(B, nkb, bk, D)
    v_r = v.reshape(B, nkb, bk, D)
    dq = torch.zeros((B, nq, bq, D), dtype=torch.float32, device=q.device)
    for s in range(kv_blocks.shape[1]):
        blk = kv_blocks[:, s]
        fl = flags[:, s]
        k_b = k_r.index_select(1, blk)                         # (B,nq,Bk,D)
        v_b = v_r.index_select(1, blk)
        pos_kb = pos_k.index_select(0, blk)                    # (nq, Bk)
        scores = _dot(q_blk, k_b) * scale
        mask = sched.step_mask(pos_q[:, :, None], pos_kb[:, None, :],
                               fl[:, None, None])[None]
        p = p_from_stats(scores, mask, m_blk, l_blk)
        ds = p * (_dot(do_blk, v_b) - dl_blk[..., None])
        dq = dq + torch.matmul(ds, k_b.float()) * scale
    return dq.reshape(B, nQ, D)


def table_dkv_scan(dout, delta, m, l, q, k, v, pos_q, pos_k, row_tile,
                   q_blocks, flags, sched: BandSchedule, scale: float):
    """dK/dV pass over PACKED transposed tables: each packed row keeps its
    owner KV tile (``row_tile``) while its slice of visiting query blocks
    streams past; per-row partials are summed per owner tile.

    ``dv_j += sum_i p_ij dout_i;  dk_j += scale * sum_i ds_ij q_i``.
    Shapes as :func:`table_dq_scan`, plus row_tile (R,), q_blocks/flags
    (R, W). Returns ``(dk, dv)``, both (B, nkb*Bk, D) f32.
    """
    B, nQ, D = q.shape
    nq, bq = pos_q.shape
    nkb, bk = pos_k.shape
    R, W = q_blocks.shape
    q_r = q.reshape(B, nq, bq, D)
    do_r = dout.reshape(B, nq, bq, D)
    m_r, l_r = m.reshape(B, nq, bq), l.reshape(B, nq, bq)
    dl_r = delta.reshape(B, nq, bq)
    k_rt = k.reshape(B, nkb, bk, D).index_select(1, row_tile)  # (B,R,Bk,D)
    v_rt = v.reshape(B, nkb, bk, D).index_select(1, row_tile)
    pos_kr = pos_k.index_select(0, row_tile)                    # (R, Bk)
    dk_r = torch.zeros((B, R, bk, D), dtype=torch.float32, device=q.device)
    dv_r = torch.zeros_like(dk_r)
    for s in range(W):
        qb = q_blocks[:, s]
        fl = flags[:, s]
        q_b = q_r.index_select(1, qb)                           # (B,R,Bq,D)
        do_b = do_r.index_select(1, qb)
        m_b, l_b = m_r.index_select(1, qb), l_r.index_select(1, qb)
        dl_b = dl_r.index_select(1, qb)
        pos_qb = pos_q.index_select(0, qb)                      # (R, Bq)
        scores = _dot(q_b, k_rt) * scale
        mask = sched.step_mask(pos_qb[:, :, None], pos_kr[:, None, :],
                               fl[:, None, None])[None]
        p = p_from_stats(scores, mask, m_b, l_b)
        ds = p * (_dot(do_b, v_rt) - dl_b[..., None])
        dv_r = dv_r + torch.matmul(p.transpose(-1, -2), do_b)
        dk_r = dk_r + torch.matmul(ds.transpose(-1, -2), q_b.float()) * scale
    zt = torch.zeros((B, nkb, bk, D), dtype=torch.float32, device=q.device)
    dk = zt.index_add(1, row_tile, dk_r).reshape(B, nkb * bk, D)
    dv = zt.index_add(1, row_tile, dv_r).reshape(B, nkb * bk, D)
    return dk, dv


@contextlib.contextmanager
def _full_f32_products():
    """f32 products in full f32 on the card while inside (no TF32)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def table_dkv_scatter_scan(dout, delta, m, l, q, k, v, pos_q, pos_k,
                           kv_blocks, flags, sched: BandSchedule,
                           scale: float):
    """dK/dV pass over (possibly runtime-valued) FORWARD step tables.

    The packed transposed walk (:func:`table_dkv_scan`, K3) is built on the
    host from a static plan; tables computed on the device
    (:mod:`repro_torch.core.dynamic`) have none. This twin walks the
    forward table width instead: at step ``s`` every query block computes
    its (dk, dv) contribution to its step-``s`` tile, and the contributions
    are summed into the tiles. Same visits, same masks, same ``p``
    recompute; padding steps (flags 0) mask to nothing and add zeros to
    tile 0.

    Query blocks of one step may share a tile. The reference adds them with
    a scatter (``.at[:, blk].add``); ``index_add_`` would use atomics on
    the card, whose f32 sums change from run to run. Here each step's
    contributions go through a ``(nkb, nq)`` one-hot product in full f32:
    a fixed summation order, so two runs give bitwise-equal dK/dV, as K3's
    do.

    Shapes as :func:`table_dq_scan`. Returns ``(dk, dv)``, both
    (B, nkb*Bk, D) f32.
    """
    B, nQ, D = q.shape
    nq, W = kv_blocks.shape
    bq = nQ // nq
    nkb, bk = pos_k.shape
    q_blk = q.reshape(B, nq, bq, D)
    qf_blk = q_blk.float()
    do_blk = dout.reshape(B, nq, bq, D)
    m_blk, l_blk = m.reshape(B, nq, bq), l.reshape(B, nq, bq)
    dl_blk = delta.reshape(B, nq, bq)
    k_r = k.reshape(B, nkb, bk, D)
    v_r = v.reshape(B, nkb, bk, D)
    tiles = torch.arange(nkb, dtype=kv_blocks.dtype, device=q.device)
    dk = torch.zeros((B, nkb, bk * D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    with _full_f32_products():
        for s in range(W):
            blk = kv_blocks[:, s]
            fl = flags[:, s]
            k_b = k_r.index_select(1, blk)                     # (B,nq,Bk,D)
            v_b = v_r.index_select(1, blk)
            pos_kb = pos_k.index_select(0, blk)                # (nq, Bk)
            scores = _dot(q_blk, k_b) * scale
            mask = sched.step_mask(pos_q[:, :, None], pos_kb[:, None, :],
                                   fl[:, None, None])[None]
            p = p_from_stats(scores, mask, m_blk, l_blk)
            ds = p * (_dot(do_blk, v_b) - dl_blk[..., None])
            dv_s = torch.matmul(p.transpose(-1, -2), do_blk)   # (B,nq,Bk,D)
            dk_s = torch.matmul(ds.transpose(-1, -2), qf_blk) * scale
            onehot = (tiles[:, None] == blk[None, :]).float()  # (nkb, nq)
            dv = dv + torch.matmul(onehot, dv_s.reshape(B, nq, bk * D))
            dk = dk + torch.matmul(onehot, dk_s.reshape(B, nq, bk * D))
    return dk.reshape(B, nkb * bk, D), dv.reshape(B, nkb * bk, D)


def plan_backward(g, q, k, v, out_w, m, l, plan: ExecutionPlan, scale: float,
                  dq_engine, dkv_engine):
    """THE backward contract of every engine: host-step adjoints around two
    plan-walking gradient passes.

    Engines take ``(dout, delta, m, l, qw, kw, vw, pos)`` in the padded
    working layout and return working-layout gradients. Everything else —
    the global-rows epilogue VJP, cotangent reorder/pad, the ``delta``
    precompute, gradient un-reordering — is this one code path.
    """
    sched = plan.sched
    B, N, D = q.shape
    # 1. Global-rows epilogue: the forward overwrote rows [:g] with the
    #    dense g-row pass on ORIGINAL-order tensors; its VJP is dense but
    #    tiny (g rows), and those rows' main-path cotangent is zeroed.
    if sched.n_global > 0 and sched.global_rows:
        ng = sched.n_global
        with torch.enable_grad():
            qe, ke, ve = (x.detach().requires_grad_() for x in (q, k, v))
            rows = _global_rows(qe, ke, ve, sched, scale, g.dtype)
            dq_rows, dk_rows, dv_rows = torch.autograd.grad(
                rows, (qe, ke, ve), g[:, :ng])
        g = torch.cat([torch.zeros_like(g[:, :ng]), g[:, ng:]], dim=1)
    else:
        dq_rows = dk_rows = dv_rows = None
    # 2. The output reorder is a permutation: the cotangent takes the SAME
    #    working-stream transform as the inputs did.
    dout = working_stream(g, sched, plan).float()
    qw = working_stream(q, sched, plan)
    kw = working_stream(k, sched, plan)
    vw = working_stream(v, sched, plan)
    pos = plan_tables(plan, q.device).pos
    # 3. delta = rowwise dout . out — the flash-backward precompute.
    delta = (dout * out_w.float()).sum(dim=-1)
    # 4. The two plan walks.
    dq_w = dq_engine(dout, delta, m, l, qw, kw, vw, pos)
    dk_w, dv_w = dkv_engine(dout, delta, m, l, qw, kw, vw, pos)
    # 5. Back to original order (+ the epilogue contributions).
    dq = undo_working(dq_w, sched, N, plan)
    dk = undo_working(dk_w, sched, N, plan)
    dv = undo_working(dv_w, sched, N, plan)
    if dq_rows is not None:
        dq = dq + dq_rows
        dk = dk + dk_rows
        dv = dv + dv_rows
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------- #
# Serving prefill
# ---------------------------------------------------------------------- #
def chunk_attention(q: torch.Tensor, k_view: torch.Tensor,
                    v_view: torch.Tensor, pos_q: torch.Tensor,
                    pos_k: torch.Tensor, kv_blocks: torch.Tensor,
                    flags: torch.Tensor, pattern: HybridSparsePattern, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Plan-driven chunked-prefill attention: one table-driven pass.

    The port of :func:`repro.core.blockwise.chunk_attention`, an XLA
    ``lax.scan`` in the reference, not a Pallas kernel. On the card it runs
    once per layer per prefill chunk, so instead of one tiny launch group
    per table column it gathers every column's KV tile at once
    (``index_select`` on the tile axis) and folds the gathered keys through
    ONE :func:`repro_torch.core.renorm.update` — the same masks on original
    positions, the same guarded online softmax.

    q: (..., Cp, D) chunk queries; k_view/v_view: (..., Vp, D) the
    request's paged KV view (sinks + ring) with the fresh chunk appended;
    pos_q: (..., Cp) and pos_k: (..., Vp) ORIGINAL positions (``BIG`` =
    empty/pad), int32; kv_blocks/flags: (nq, W) int32 ChunkPlan step
    tables. Leading dims broadcast between the query and KV operands
    (GQA passes a size-1 group axis on K/V — no KV copy). Returns
    (..., Cp, D) in q's dtype.
    """
    *lead, Cp, D = q.shape
    nq, W = kv_blocks.shape
    block = Cp // nq
    Vp = k_view.shape[-2]
    nkb = Vp // block
    scale_ = (D ** -0.5) if scale is None else scale
    idx = kv_blocks.reshape(-1)                                # (nq*W,)

    def gather(x: torch.Tensor, tail: tuple) -> torch.Tensor:
        # (..., Vp, *tail) -> (..., nq, W*block, *tail): every step's tile
        xr = x.reshape(*x.shape[:-1 - len(tail)], nkb, block, *tail)
        xg = xr.index_select(xr.dim() - 2 - len(tail), idx)
        return xg.reshape(*xg.shape[:-2 - len(tail)], nq, W * block, *tail)

    k_g = gather(k_view, (D,))
    v_g = gather(v_view, (D,))
    pos_g = gather(pos_k, ())                                  # (.., nq, WB)
    q_blk = q.reshape(*lead, nq, block, D)
    pos_qb = pos_q.reshape(*pos_q.shape[:-1], nq, block)
    fl = flags.repeat_interleave(block, dim=1)                 # (nq, WB)

    scores = _dot(q_blk, k_g) * scale_
    mask = causal_step_mask(pattern, pos_qb[..., :, :, None],
                            pos_g[..., :, None, :], fl[:, None, :])
    state = renorm.empty_state(scores.shape[:-1], D, q.device)
    state = renorm.update(state, scores, v_g, mask)
    out = renorm.finalize(state, q.dtype)
    return out.reshape(*out.shape[:-3], Cp, D)
