"""Model-facing hybrid-sparse-attention entry points.

The port of :mod:`repro.core.attention`, in the reference's model-facing
layout (batch, heads, seq, head_dim):

* :func:`hybrid_attention` — the full-sequence (training) op on the
  static ExecutionPlan or on runtime plans built on the device;
* :func:`hybrid_chunk_attention` — chunked prefill over ChunkPlan tables;
* :func:`hybrid_decode_attention` — the ragged one-token decode against
  per-request caches with per-slot positions (the plain version the
  decode kernels K4 and K5 are held against).

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
                     plan: str = "static",
                     dynamic_keep: Optional[int] = None,
                     dynamic_local_window: Optional[int] = None,
                     dynamic_pool_k: Optional[int] = None) -> torch.Tensor:
    """Hybrid sparse attention (training / full sequence). q: (B, H, N, D);
    k/v: (B, Hkv, N, D). Differentiable.

    ``impl="dense_ref"`` is the O(n^2) masked oracle. ``impl="blockwise"``
    and ``impl="pallas"`` both run the table-driven kernels; the tensors'
    device picks the CUDA kernels or their plain versions.

    ``plan`` selects how step tables are built: ``"static"`` lowers the
    pattern alone (:func:`repro_torch.kernels.ops.salo_attention`);
    ``"dynamic"`` routes through :mod:`repro_torch.core.dynamic` — per
    query block only the ``dynamic_keep`` highest estimated-mass candidate
    tiles execute (causal-local and global/sink tiles are never dropped;
    see the DynamicConfig knobs ``dynamic_local_window`` /
    ``dynamic_pool_k``), on tables built on the device at run time.
    Dynamic plans need a table-driven engine (any ``impl`` but
    ``dense_ref``). Sequence parallelism is not ported (the train CLI
    raises for ``--data``/``--model`` > 1).

    GQA: KV heads are expanded to H by ``expand(...).reshape`` — a copy of
    K/V ``rep`` times in torch (the reference's broadcast is free in XLA).
    """
    if plan not in ("static", "dynamic"):
        raise ValueError(f"unknown plan {plan!r}; choose static or dynamic")
    dcfg = None
    if plan == "dynamic":
        if impl == "dense_ref":
            raise ValueError("plan='dynamic' needs a table-driven engine "
                             "(impl != 'dense_ref')")
        if dynamic_keep is None:
            raise ValueError("plan='dynamic' requires dynamic_keep")
        from repro_torch.core.dynamic import DynamicConfig
        dcfg = DynamicConfig(keep=int(dynamic_keep),
                             local_window=dynamic_local_window,
                             pool_k=dynamic_pool_k)
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
    if dcfg is not None:
        from repro_torch.core.dynamic import dynamic_attention
        out = dynamic_attention(qf, kf, vf, pattern, dcfg, block_q=block_q,
                                block_k=block_k, scale=scale, impl=impl)
    elif impl == "dense_ref":
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
                            cache_positions: Optional[torch.Tensor] = None,
                            slice_window: bool = False,
                            return_state: bool = False,
                            return_slot_m: bool = False):
    """Single-token decode, ragged aware. q: (B, H, 1, D); caches:
    (B, Hkv, S, D); ``t``: an int (lockstep batch) or a (B,) int32 tensor
    (one position per request); ``cache_positions``: (S,) or (B, S) int32
    absolute position per slot (``PAD_SENTINEL`` = empty), default
    ``arange(S)``.

    A row with no live slot takes the softmax of all-``NEG_INF`` scores
    and returns the mean of V, exactly as the reference's XLA twin does
    (the decode kernels return 0 there; only inactive engine rows are
    empty, and their logits are discarded).

    ``slice_window=True`` reads only the last ``window`` cache slots and
    the global-token prefix (the reference's windowed decode). It needs
    the slot == position layout (``cache_positions is None``) and a
    scalar ``t``; otherwise the whole cache is read.

    ``return_state=True`` returns ``(out, m, l)`` in f32 (out unrounded,
    m and l (B, H, 1)); a row with no live slot gives the ``(0, NEG_INF,
    0)`` identity. ``return_slot_m=True`` appends ``slot_m`` (B, S), each
    request's max masked score against each slot (``NEG_INF`` where
    masked). Both read the whole cache.
    """
    B, H, _, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    rep = H // Hkv
    scale_ = (D ** -0.5) if scale is None else scale
    dev = q.device
    qg = q.reshape(B, Hkv, rep, D).float()
    a, _ = pattern.window
    g = pattern.n_global
    # an int t becomes a fill on the device, not a host-to-device copy
    # (which would wait for the work queued before it)
    pos_i = (t.to(torch.int32).expand(B) if torch.is_tensor(t) else
             torch.full((B,), int(t), dtype=torch.int32, device=dev))

    def grouped(kc, pos_k, extra_mask=None):
        """kc: (B, Hkv, L, D); pos_k: (L,) or (B, L) -> masked scores."""
        s = torch.einsum("bgrd,bgsd->bgrs", qg, kc.float()) * scale_
        pos_kb = pos_k.expand(B, kc.shape[2])
        m = causal_step_mask(pattern, pos_i[:, None], pos_kb,
                             STEP_WINDOW | STEP_GLOBAL)         # (B, L)
        if extra_mask is not None:
            m = m & extra_mask
        return torch.where(m[:, None, None, :], s, renorm.NEG_INF)

    def all_slots():
        return (torch.arange(S, dtype=torch.int32, device=dev)
                if cache_positions is None else cache_positions)

    if return_state:
        s = grouped(k_cache, all_slots())                 # (B, Hkv, rep, S)
        m = s.amax(dim=-1)
        # masked entries sit at NEG_INF: exp(NEG_INF - shift) underflows to
        # exactly 0, and an all-masked row keeps (0, NEG_INF, 0)
        shift = torch.where(m <= renorm.NEG_INF / 2, 0.0, m)
        p = torch.exp(s - shift[..., None])
        l = p.sum(dim=-1)
        acc = torch.einsum("bgrs,bgsd->bgrd", p, v_cache.float())
        out = acc / torch.where(l == 0.0, 1.0, l)[..., None]
        res = (out.reshape(B, H, 1, D), m.reshape(B, H, 1),
               l.reshape(B, H, 1))
        return (*res, s.amax(dim=(1, 2))) if return_slot_m else res

    vc = v_cache
    if return_slot_m:
        s = grouped(k_cache, all_slots())
    elif slice_window and cache_positions is None and a > -(1 << 29) \
            and not (torch.is_tensor(t) and t.dim() > 0):
        L = min(S, -a + 1)
        start = min(max(int(t) - (L - 1), 0), S - L)
        pos_win = start + torch.arange(L, dtype=torch.int32, device=dev)
        parts_s = [grouped(k_cache[:, :, start:start + L], pos_win)]
        parts_v = [v_cache[:, :, start:start + L]]
        if g > 0:
            gp = min(g, S)
            pos_sink = torch.arange(gp, dtype=torch.int32, device=dev)
            # exclude sink slots already inside the window slice
            parts_s.insert(0, grouped(k_cache[:, :, :gp], pos_sink,
                                      extra_mask=pos_sink < start))
            parts_v.insert(0, v_cache[:, :, :gp])
        s = torch.cat(parts_s, dim=-1)
        vc = torch.cat(parts_v, dim=2)
    else:
        s = grouped(k_cache, all_slots())
    wts = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrs,bgsd->bgrd", wts, vc.float())
    out = out.to(q.dtype).reshape(B, H, 1, D)
    return (out, s.amax(dim=(1, 2))) if return_slot_m else out


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
