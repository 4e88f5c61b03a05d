"""Model-facing hybrid-sparse-attention entry points.

The port of :mod:`repro.core.attention`, in the reference's model-facing
layout (batch, heads, seq, head_dim):

* :func:`hybrid_attention` — the full-sequence (training) op on the
  static ExecutionPlan;
* :func:`hybrid_chunk_attention` — chunked prefill over ChunkPlan tables;
* :func:`hybrid_decode_attention` — the ragged one-token decode against
  per-request caches with per-slot positions (the plain version the
  paged-decode kernel is held against).

The serving paths never copy KV for GQA: the ``rep = H / Hkv`` query
heads of a group meet their KV head through a size-1 broadcast axis.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import renorm
from repro_torch.core.blockwise import chunk_attention
from repro_torch.core.patterns import HybridSparsePattern
from repro_torch.core.scheduler import (STEP_GLOBAL, STEP_WINDOW,
                                        causal_step_mask)


IMPLS = ("dense_ref", "blockwise", "pallas")


def hybrid_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pattern: HybridSparsePattern, *,
                     impl: str = "blockwise", block_q: int = 128,
                     block_k: int = 128, scale: Optional[float] = None,
                     plan: str = "static") -> torch.Tensor:
    """Hybrid sparse attention (training / full sequence). q: (B, H, N, D);
    k/v: (B, Hkv, N, D). Differentiable.

    ``impl="dense_ref"`` is the O(n^2) masked oracle. ``impl="blockwise"``
    and ``impl="pallas"`` both run :func:`repro_torch.kernels.ops
    .salo_attention` on the static plan; the tensors' device picks the
    CUDA kernels or their plain versions. ``plan="dynamic"`` (runtime
    plans, and the reference's ``dynamic_*`` knobs with it) is not ported
    yet; sequence parallelism is not either (the train CLI raises for
    ``--data``/``--model`` > 1).

    GQA: KV heads are expanded to H by ``expand(...).reshape`` — a copy of
    K/V ``rep`` times in torch (the reference's broadcast is free in XLA).
    """
    if plan == "dynamic":
        raise NotImplementedError(
            "plan='dynamic' is not ported yet: ROADMAP item 5 (runtime "
            "plans, core/dynamic.py)")
    if plan != "static":
        raise ValueError(f"unknown plan {plan!r}; choose static or dynamic")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; choose from {IMPLS}")
    B, H, N, D = q.shape
    Hkv = k.shape[1]
    if Hkv != H:
        if H % Hkv:
            raise ValueError(f"GQA heads {H} not divisible by kv heads {Hkv}")
        rep = H // Hkv
        k = k[:, :, None].expand(B, Hkv, rep, N, D).reshape(B, H, N, D)
        v = v[:, :, None].expand(B, Hkv, rep, N, D).reshape(B, H, N, D)
    qf = q.reshape(B * H, N, D)
    kf = k.reshape(B * H, N, D)
    vf = v.reshape(B * H, N, D)
    if impl == "dense_ref":
        from repro_torch.kernels.ref import reference_attention
        out = reference_attention(qf, kf, vf, pattern, scale=scale)
    else:
        from repro_torch.kernels.ops import salo_attention
        out = salo_attention(qf, kf, vf, pattern, block_q, block_k, scale)
    return out.reshape(B, H, N, D)


def hybrid_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, t,
                            pattern: HybridSparsePattern, *,
                            scale: Optional[float] = None,
                            cache_positions: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Single-token decode, ragged aware. q: (B, H, 1, D); caches:
    (B, Hkv, S, D); ``t``: a (B,) int32 tensor (one position per request)
    or an int; ``cache_positions``: (S,) or (B, S) int32 absolute position
    per slot (``PAD_SENTINEL`` = empty), default ``arange(S)``.

    A row with no live slot takes the softmax of all-``NEG_INF`` scores
    and returns the mean of V, exactly as the reference's XLA twin does
    (the paged kernel returns 0 there; only inactive engine rows are
    empty, and their logits are discarded).
    """
    B, H, _, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    rep = H // Hkv
    scale_ = (D ** -0.5) if scale is None else scale
    dev = q.device
    qg = q.reshape(B, Hkv, rep, D)
    s = torch.einsum("bgrd,bgsd->bgrs", qg.float(), k_cache.float()) * scale_
    pos_i = torch.as_tensor(t, dtype=torch.int32, device=dev).expand(B)
    pos_k = (torch.arange(S, dtype=torch.int32, device=dev)
             if cache_positions is None else cache_positions)
    pos_k = pos_k.expand(B, S)
    m = causal_step_mask(pattern, pos_i[:, None], pos_k,
                         STEP_WINDOW | STEP_GLOBAL)              # (B, S)
    s = torch.where(m[:, None, None, :], s, renorm.NEG_INF)
    wts = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrs,bgsd->bgrd", wts, v_cache.float())
    return out.to(q.dtype).reshape(B, H, 1, D)


def hybrid_chunk_attention(q: torch.Tensor, k_view: torch.Tensor,
                           v_view: torch.Tensor, pos_q: torch.Tensor,
                           pos_k: torch.Tensor, kv_blocks: torch.Tensor,
                           flags: torch.Tensor,
                           pattern: HybridSparsePattern, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Chunked-prefill attention: one fused pass of a prompt chunk against
    the request's paged KV view + the chunk itself.

    q: (B, H, Cp, D); k_view/v_view: (B, Hkv, Vp, D); pos_q: (B, Cp);
    pos_k: (B, Vp) original positions; kv_blocks/flags: (nq, W) ChunkPlan
    step tables. Returns (B, H, Cp, D).
    """
    B, H, Cp, D = q.shape
    Hkv = k_view.shape[1]
    rep = H // Hkv
    # GQA: K/V get a size-1 group axis that broadcasts against the rep
    # query heads (a stride-0 expand inside the matmuls, never a copy).
    out = chunk_attention(q.reshape(B, Hkv, rep, Cp, D),
                          k_view[:, :, None], v_view[:, :, None],
                          pos_q[:, None, None], pos_k[:, None, None],
                          kv_blocks, flags, pattern, scale=scale)
    return out.reshape(B, H, Cp, D)
