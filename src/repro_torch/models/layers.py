"""Shared layer library: norms, RoPE, MLP, attention, embedding, loss.

The port of :mod:`repro.models.layers` as plain functions on tensors:
``*_init(generator, ...) -> params dict`` and ``*_apply(params, x, ...)``.
Parameter names and orientations are the reference's — weights are
``(d_in, d_out)`` so ``x @ w`` reads the same, and converted reference
parameters are a copy (:mod:`repro_torch.convert`).

The attention layer is where the paper's technique enters the model:
QKV projection -> RoPE -> hybrid sparse attention with the arch's
:class:`SALOConfig` pattern -> output projection. Four paths: the
full-sequence training forward (:func:`attn_apply`, through
:func:`repro_torch.core.attention.hybrid_attention`), plan-driven chunked
prefill, the ragged paged decode (always through
:func:`repro_torch.kernels.salo_decode.salo_paged_decode`) and the
lockstep decode on contiguous caches (always through
:func:`repro_torch.kernels.salo_decode.salo_decode`). The tensors' device
picks kernel or plain version.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SALOConfig
from repro_torch.core.attention import (hybrid_attention,
                                        hybrid_chunk_attention)
from repro_torch.core.patterns import (HybridSparsePattern,
                                       causal_sliding_window, full,
                                       longformer)
from repro_torch.core.scheduler import PAD_SENTINEL
from repro_torch.kernels.salo_decode import salo_decode, salo_paged_decode
from repro_torch.serve.paged_cache import quant_slab_write, slab_write


def dt(cfg: ModelConfig, kind: str = "param") -> torch.dtype:
    name = cfg.param_dtype if kind == "param" else cfg.compute_dtype
    return getattr(torch, name)


# --------------------------- init helpers ------------------------------ #
def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               scale: float = 1.0) -> torch.Tensor:
    std = scale / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device) * std
    return w.to(device=device, dtype=dtype)


# ------------------------------ norms ---------------------------------- #
def rmsnorm_init(d: int, device):
    # gemma-style (1 + scale), kept in f32
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + p["scale"])
    return y.to(x.dtype)


# ------------------------------- RoPE ----------------------------------- #
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding, half-split rotation. x: (B, S, H, D); positions:
    (B, S) int. M-RoPE comes with the VLM family."""
    D = x.shape[-1]
    half = D // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[..., None] * freqs             # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------- MLPs ----------------------------------- #
def mlp_init(gen, cfg: ModelConfig, device, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"w_in": dense_init(gen, d, f, dt(cfg), device),
         "w_out": dense_init(gen, f, d, dt(cfg), device)}
    if cfg.act in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, d, f, dt(cfg), device)
    return p


def mlp_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    # GELU is tanh-approximate, as the reference's jax.nn.gelu defaults to
    h = x @ p["w_in"].to(x.dtype)
    if cfg.act == "swiglu":
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * h
    elif cfg.act == "geglu":
        h = F.gelu(x @ p["w_gate"].to(x.dtype), approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["w_out"].to(x.dtype)


# ---------------------------- attention --------------------------------- #
def salo_pattern(cfg: ModelConfig, causal: bool = True,
                 salo: Optional[SALOConfig] = None) -> HybridSparsePattern:
    """The pattern this architecture's attention layers run."""
    s = salo or cfg.salo
    if not s.enabled:
        return full(causal=causal)
    if s.bidirectional and not causal:
        return longformer(s.window, n_global=s.n_global)
    return causal_sliding_window(s.window, n_sinks=s.n_global,
                                 dilation=s.dilation)


def attn_init(gen, cfg: ModelConfig, device):
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"wq": dense_init(gen, d, H * hd, dt(cfg), device),
            "wk": dense_init(gen, d, Hkv * hd, dt(cfg), device),
            "wv": dense_init(gen, d, Hkv * hd, dt(cfg), device),
            "wo": dense_init(gen, H * hd, d, dt(cfg), device)}


def attn_qkv(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, H, hd)
    k = (x @ p["wk"].to(x.dtype)).reshape(B, S, Hkv, hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(B, S, Hkv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_apply(p, x: torch.Tensor, cfg: ModelConfig,
               pattern: HybridSparsePattern,
               positions: Optional[torch.Tensor] = None):
    """Full-sequence attention (train). x: (B, S, d); returns (B, S, d).
    (The reference also returns (k, v) for its prefill-to-cache path; the
    port prefills through :func:`attn_chunk_prefill`.)

    The (B, S, H, hd) -> (B*H, S, hd) layout change is a copy in torch
    (a free transpose in XLA)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = attn_qkv(p, x, cfg, positions)
    out = hybrid_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), pattern,
        impl=cfg.salo.impl, block_q=cfg.salo.block_q,
        block_k=cfg.salo.block_k)
    out = out.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.hd)
    return out @ p["wo"].to(x.dtype)


# ------------------- continuous-batching serve paths -------------------- #
def attn_chunk_prefill(p, x_chunk, ctx_k, ctx_v, ctx_pos, pos_q, kv_blocks,
                       flags, cfg: ModelConfig,
                       pattern: HybridSparsePattern):
    """One prompt chunk through a layer's attention (plan-driven prefill).

    x_chunk: (1, Cp, d); ctx_k/ctx_v: (1, S_req, Hkv, hd) the request's
    paged KV view; ctx_pos: (1, S_req) live slot positions; pos_q: (1, Cp)
    chunk positions (PAD_SENTINEL on padded rows); kv_blocks/flags:
    (nq, W) ChunkPlan step tables. Returns (out, k_chunk, v_chunk) — the
    fresh chunk KV for the caller's slab write-back."""
    B, Cp, _ = x_chunk.shape
    rope_pos = torch.where(pos_q < PAD_SENTINEL, pos_q, 0)
    q, k, v = attn_qkv(p, x_chunk, cfg, rope_pos)
    k_view = torch.cat([ctx_k.to(k.dtype), k], dim=1)
    v_view = torch.cat([ctx_v.to(v.dtype), v], dim=1)
    pos_k = torch.cat([ctx_pos, pos_q], dim=1)
    out = hybrid_chunk_attention(
        q.transpose(1, 2), k_view.transpose(1, 2), v_view.transpose(1, 2),
        pos_q, pos_k, kv_blocks, flags, pattern)
    out = out.transpose(1, 2).reshape(B, Cp, cfg.n_heads * cfg.hd)
    return out @ p["wo"].to(x_chunk.dtype), k, v


def attn_decode_paged(p, x_t, k_slab, v_slab, page_tables, slot_pos, t_vec,
                      phys_w, off_w, cfg: ModelConfig,
                      pattern: HybridSparsePattern, k_scale=None,
                      v_scale=None, want_page_stats: bool = False):
    """Ragged one-token decode against ONE layer's pooled paged slab.

    x_t: (R, 1, d) — one token per engine row; k_slab/v_slab:
    (n_pages, page, Hkv, hd); page_tables: (R, npp) int32; slot_pos:
    (R, S_req) int32 live positions (already updated for this step's
    writes); t_vec: (R,) int32 per-request positions; phys_w/off_w: (R,)
    int32 slab write targets (null page for inactive rows).

    The new token's KV is written into the slab IN PLACE first, then the
    token attends — so it attends itself, as in the reference.

    ``k_scale``/``v_scale``: the layer's (n_pages,) f32 dequant scales,
    present iff the slab is int8. The new KV is quantized into its page
    (:func:`~repro_torch.serve.paged_cache.quant_slab_write`, monotone
    scale growth, in place) and the read dequantizes per page inside the
    decode. ``want_page_stats=True`` makes ``page_m`` (R, npp) the max
    masked score of each request against each of its logical pages
    (``NEG_INF`` where fully masked); otherwise it is ``None``.

    Returns the reference's ``(out, k_slab, v_slab, k_scale, v_scale,
    page_m)``; the slab and scale tensors are the ones passed in, updated
    in place. (The reference's sequence-parallel ``axis`` comes with
    multi-GPU serving.)"""
    R = x_t.shape[0]
    q, k, v = attn_qkv(p, x_t, cfg, t_vec[:, None])
    if k_scale is not None:
        quant_slab_write(k_slab, v_slab, k_scale, v_scale, phys_w, off_w,
                         k[:, 0], v[:, 0])
    else:
        slab_write(k_slab, v_slab, phys_w, off_w, k[:, 0], v[:, 0])
    qt = q.transpose(1, 2).contiguous()                   # (R, H, 1, hd)
    res = salo_paged_decode(qt, k_slab, v_slab, page_tables, slot_pos,
                            t_vec, pattern=pattern, k_scale=k_scale,
                            v_scale=v_scale,
                            return_page_stats=want_page_stats)
    out, page_m = res if want_page_stats else (res, None)
    out = out.transpose(1, 2).reshape(R, 1, cfg.n_heads * cfg.hd)
    return (out @ p["wo"].to(x_t.dtype), k_slab, v_slab, k_scale, v_scale,
            page_m)


# -------------------------- lockstep serve path ------------------------- #
@functools.lru_cache(maxsize=8)
def _ring_positions(t: int, n_slots: int, window: int, n_global: int,
                    device: torch.device) -> torch.Tensor:
    """Absolute position held by each slot of the lockstep SALO ring cache
    at step ``t``: slot ``j < g`` holds position ``j``; ring slot ``j >= g``
    the latest ``p <= t`` with ``(p - g) % w == j - g``; ring slots not
    written yet (``p < g``) get ``PAD_SENTINEL``. Read-only; shared by the
    layers of one step."""
    j = np.arange(n_slots, dtype=np.int64)
    pos = np.where(j < n_global, j, t - np.mod(t - j, window))
    pos = np.where((j >= n_global) & (pos < n_global), PAD_SENTINEL, pos)
    return torch.from_numpy(pos.astype(np.int32)).to(device)


def attn_decode(p, x_t, cache_k, cache_v, t: int, cfg: ModelConfig,
                pattern: HybridSparsePattern):
    """One-token lockstep decode. x_t: (B, 1, d); caches: (B, S, Hkv, hd),
    written IN PLACE; ``t``: the batch's position (an int).

    Full cache (slot = position): the new KV goes to slot ``t``. SALO ring
    cache (``cfg.salo.ring_cache``): slots ``[0, g)`` hold the sinks and
    ``[g, g + w)`` a ring keyed by ``(t - g) % w``; the slots' positions
    are recomputed per step (``PAD_SENTINEL`` for ring slots not written
    yet). The token then attends through
    :func:`repro_torch.kernels.salo_decode.salo_decode` on the caches'
    (B, Hkv, S, hd) transposed views — the kernel reads them in place on
    the card, the plain version runs on the CPU (windowed when
    ``cfg.salo.decode_slice``). Returns (out, cache_k, cache_v), the
    caches being the ones passed in. M-RoPE decode comes with the VLM
    family."""
    if cfg.mrope_sections is not None:
        raise NotImplementedError(
            "M-RoPE decode is not ported yet: ROADMAP 'other model "
            "families' (qwen2-vl)")
    B = x_t.shape[0]
    t = int(t)
    positions = torch.full((B, 1), t, dtype=torch.int32, device=x_t.device)
    q, k, v = attn_qkv(p, x_t, cfg, positions)
    cache_positions = None
    if cfg.salo.ring_cache:
        w_, g_ = cfg.salo.window, max(cfg.salo.n_global, 0)
        slot = t if t < g_ else g_ + (t - g_) % w_
        cache_positions = _ring_positions(t, cache_k.shape[1], w_, g_,
                                          x_t.device)
    else:
        slot = t
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    out = salo_decode(q.transpose(1, 2).contiguous(),
                      cache_k.transpose(1, 2), cache_v.transpose(1, 2),
                      cache_positions, t, pattern=pattern,
                      slice_window=(cfg.salo.decode_slice
                                    and not cfg.salo.ring_cache))
    out = out.transpose(1, 2).reshape(B, 1, cfg.n_heads * cfg.hd)
    return out @ p["wo"].to(x_t.dtype), cache_k, cache_v


# ------------------------------ embedding -------------------------------- #
def embed_init(gen, cfg: ModelConfig, device):
    # std 1/sqrt(d): embed_apply rescales by sqrt(d) to unit variance, and
    # the (tied) readout keeps logits O(1) at init.
    std = cfg.d_model ** -0.5
    w = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                    device=gen.device) * std
    return {"w": w.to(device=device, dtype=dt(cfg))}


def embed_apply(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = p["w"][tokens].to(dt(cfg, "compute"))
    # a Python float keeps bf16 activations bf16 (gemma-style scaling)
    return x * float(math.sqrt(cfg.d_model))


def logits_apply(p_embed, p_head, x: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    w = (p_embed["w"] if cfg.tie_embeddings else p_head["w"]).to(x.dtype)
    logits = x @ w.T
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B, S, V), targets (B, S) int. Mean NLL over mask, in f32."""
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
