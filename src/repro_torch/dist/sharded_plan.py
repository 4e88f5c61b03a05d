"""Cross-shard softmax merge of the sequence-parallel serving engine.

The port of :func:`repro.dist.sharded_plan.masked_psum_merge`. The
training side of the reference's module (``ShardedPlan``, ``shard_plan``,
the halo exchange and its reverse on the backward) comes in a later slice
(ROADMAP queue 1, item 3).
"""
from __future__ import annotations

import torch

from repro_torch.core.renorm import NEG_INF


def masked_psum_merge(out: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                      group) -> torch.Tensor:
    """Combine per-shard finalized attention partials across a group.

    The sharded paged slab gives each shard a disjoint slice of every
    request's cache, so decode and chunked prefill run one launch per shard
    over the owned slots, and the partials are merged here. ``out``:
    (..., d) = acc / l (guarded); ``m``/``l``: (...) f32 row stats. Each
    shard's contribution is weighted by ``c = l * exp(m - M)`` with ``M``
    the max of ``m`` over the shards; the empty-row identity ``(0,
    NEG_INF, 0)`` gives ``c == 0``, so a shard that holds no valid slot for
    a row (inactive request, slot owned elsewhere, ring not yet reaching
    the shard) contributes exactly nothing.

    ``group``: a :class:`~repro_torch.dist.group.SeqGroup` (or a
    :class:`~repro_torch.dist.group.StackedGroup`, whose tensors lead with
    the shard axis). Two collectives, both ``all_reduce``: MAX over ``m``,
    then ONE SUM over ``out * c`` and ``c`` stacked on the last axis. All
    in f32; returns the merged (..., d) f32 output, which the caller rounds
    once to its compute dtype."""
    M = group.pmax_(m.float().clone())
    shift = torch.where(M <= NEG_INF / 2, 0.0, M)
    c = l.float() * torch.exp(m.float() - shift)   # empty rows: l == 0
    buf = torch.cat([out.float() * c[..., None], c[..., None]], dim=-1)
    group.psum_(buf)
    den = buf[..., -1]
    return buf[..., :-1] / torch.where(den == 0.0, 1.0, den)[..., None]
