"""Renormalized online softmax (paper Eq. 2 / App. A), in torch.

A partial is the online-softmax triple over the keys folded so far:

    state = (acc, m, l)     acc = sum_j exp(S_ij - m) * v_j     (unnormalized)
                            m   = max_j S_ij
                            l   = sum_j exp(S_ij - m)

The port of :mod:`repro.core.renorm`: ``empty_state``, ``merge`` (two
disjoint-key partials combined), ``update`` (one KV tile folded in) and
``finalize``. ``weights`` comes with sequence-parallel training.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps 0*inf NaNs away


class PartialState(NamedTuple):
    """Partial attention for a block of queries. Shapes:
    acc: (..., q, d) f32, m: (..., q) f32, l: (..., q) f32.

    **Empty-row contract.** A row that attended nothing carries exactly
    ``(acc=0, m=NEG_INF, l=0)`` and finalizes to a zero output row.
    """
    acc: torch.Tensor
    m: torch.Tensor
    l: torch.Tensor


def empty_state(q_shape, d: int, device,
                dtype=torch.float32) -> PartialState:
    """Identity element of the merge (zero weight, -inf max)."""
    return PartialState(
        acc=torch.zeros((*q_shape, d), dtype=dtype, device=device),
        m=torch.full(tuple(q_shape), NEG_INF, dtype=dtype, device=device),
        l=torch.zeros(tuple(q_shape), dtype=dtype, device=device),
    )


def merge(a: PartialState, b: PartialState) -> PartialState:
    """Exact merge of two disjoint-key partials (paper Eq. 2, stabilized)."""
    m = torch.maximum(a.m, b.m)
    ca = torch.exp(a.m - m)
    cb = torch.exp(b.m - m)
    return PartialState(
        acc=a.acc * ca[..., None] + b.acc * cb[..., None],
        m=m,
        l=a.l * ca + b.l * cb,
    )


def update(state: PartialState, scores: torch.Tensor, v: torch.Tensor,
           mask: Optional[torch.Tensor] = None) -> PartialState:
    """Fold one KV tile into the running state.

    scores: (..., q, k) f32 logits; v: (..., k, d); mask True = attend.
    """
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    m_tile = scores.amax(dim=-1)
    m_new = torch.maximum(state.m, m_tile)
    # Guard: if a row has no valid key anywhere yet, m_new stays NEG_INF and
    # exp(scores - m_new) could overflow; clamp the shift.
    shift = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
    p = torch.exp(scores - shift[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    empty = state.m <= NEG_INF / 2
    corr = torch.exp(torch.where(empty, NEG_INF, state.m) - shift)
    corr = torch.where(empty, 0.0, corr)
    # PV contraction with p rounded to V's dtype, accumulated and returned
    # in f32 (the reference's preferred_element_type=f32): the rounded
    # operands are exact in f32, so an f32 product reproduces it.
    pv = torch.matmul(p.to(v.dtype).float(), v.float())
    return PartialState(
        acc=state.acc * corr[..., None] + pv,
        m=m_new,
        l=state.l * corr + p.sum(dim=-1),
    )


def finalize(state: PartialState, dtype=None) -> torch.Tensor:
    """Normalize: out = acc / l. Rows that attended nothing produce zeros."""
    l = torch.where(state.l == 0.0, 1.0, state.l)
    out = state.acc / l[..., None]
    return out.to(dtype) if dtype is not None else out
