"""Plan-driven chunked-prefill attention in plain torch.

The port of :func:`repro.core.blockwise.chunk_attention`, the serving
prefill engine. In the reference this is an XLA ``lax.scan`` over the
ChunkPlan step-table columns, not a Pallas kernel, so plain torch is its
faithful counterpart. On the card it runs once per layer per prefill
chunk, so instead of one tiny launch group per table column it gathers
every column's KV tile at once (``index_select`` on the tile axis) and
folds the gathered keys through ONE :func:`repro_torch.core.renorm.update`
— the same masks on original positions, the same guarded online softmax,
just a single fold of all ``W`` tiles instead of ``W`` sequential folds.

The training engines of the reference module (table scans, the
plan-driven backward) belong to the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import renorm
from repro_torch.core.patterns import HybridSparsePattern
from repro_torch.core.scheduler import causal_step_mask


def chunk_attention(q: torch.Tensor, k_view: torch.Tensor,
                    v_view: torch.Tensor, pos_q: torch.Tensor,
                    pos_k: torch.Tensor, kv_blocks: torch.Tensor,
                    flags: torch.Tensor, pattern: HybridSparsePattern, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Plan-driven chunked-prefill attention: one table-driven pass.

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

    # scores in f32 from exact f32 copies of the operands (the reference's
    # preferred_element_type=f32 contraction)
    scores = torch.matmul(q_blk.float(),
                          k_g.float().transpose(-1, -2)) * scale_
    mask = causal_step_mask(pattern, pos_qb[..., :, :, None],
                            pos_g[..., :, None, :], fl[:, None, :])
    state = renorm.empty_state(scores.shape[:-1], D, q.device)
    state = renorm.update(state, scores, v_g, mask)
    out = renorm.finalize(state, q.dtype)
    return out.reshape(*out.shape[:-3], Cp, D)
