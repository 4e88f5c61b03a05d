"""Shared layer library: norms, RoPE, MLP, attention, embedding, loss.

The port of :mod:`repro.models.layers` as plain functions on tensors:
``*_init(generator, ...) -> params dict`` and ``*_apply(params, x, ...)``.
Parameter names and orientations are the reference's — weights are
``(d_in, d_out)`` so ``x @ w`` reads the same, and converted reference
parameters are a copy (:mod:`repro_torch.convert`).

The attention layer is where the paper's technique enters the model:
QKV projection -> RoPE (M-RoPE for the VLM) -> hybrid sparse attention
with the arch's :class:`SALOConfig` pattern -> output projection. Four
paths: the full-sequence training forward (:func:`attn_apply`, through
:func:`repro_torch.core.attention.hybrid_attention`), plan-driven chunked
prefill, the ragged paged decode (always through
:func:`repro_torch.kernels.salo_decode.salo_paged_decode`) and the
lockstep decode on contiguous caches (always through
:func:`repro_torch.kernels.salo_decode.salo_decode`). The tensors' device
picks kernel or plain version. Whisper's cross attention (dense over the
encoder output) and sinusoidal positions are plain torch, as the
reference's are plain XLA.

Tensor parallelism (``model=``, a :class:`~repro_torch.dist.group
.ModelGroup`, the reference's "model" mesh axis): the attention (self and
cross) and MLP products, the embedding and the LM head take the split
weights of :func:`repro_torch.dist.sharding.mesh_placements`,
Megatron-style. A column-split product's input passes ``model.enter``
(its gradient summed over the group); a row-split product's partial
outputs are summed by ``model.reduce``. The sums run in the activations'
dtype, as GSPMD sums a bf16 dot's partials. ``model=None`` is the
single-device code. A model group runs every block kind of the 11
archs.
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
from repro_torch.dist.sharding import split_axes
from repro_torch.dist.sharded_plan import masked_psum_merge
from repro_torch.kernels.salo_decode import salo_decode, salo_paged_decode
from repro_torch.serve.paged_cache import quant_slab_write, slab_write


def dt(cfg: ModelConfig, kind: str = "param") -> torch.dtype:
    name = cfg.param_dtype if kind == "param" else cfg.compute_dtype
    return getattr(torch, name)


def _split(cfg: ModelConfig, model) -> frozenset:
    """The logical axes split over the model group (none without one)."""
    return frozenset() if model is None else split_axes(cfg, model.size)


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
@functools.lru_cache(maxsize=16)
def _rope_tables(half: int, theta: float, sections, device: torch.device):
    """RoPE's frequencies (half,) f32 and, with M-RoPE ``sections``, each
    frequency pair's position component (half,) int64, made once per
    shape and device (no host-to-device copy on the call path). The
    frequencies are f32 exponents raised in f64 and rounded once to f32,
    which gives XLA's f32 ``pow`` (``torch.pow`` in f32 is an ulp off on
    some, which moves the angle at positions in the thousands)."""
    expo = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    freqs = torch.pow(theta, expo.double()).float()
    if sections is None:
        return freqs, None
    t, h, _ = sections
    j = torch.arange(half, device=device)
    return freqs, (j >= t).long() + (j >= t + h).long()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
         sections: Optional[tuple] = None) -> torch.Tensor:
    """Rotary embedding, half-split rotation. x: (B, S, H, D); positions:
    (B, S) int, or (3, B, S) for M-RoPE with ``sections=(t, h, w)``
    splitting the D/2 frequency pairs: pair ``i`` takes the position
    component of its section (temporal, height, width)."""
    D = x.shape[-1]
    half = D // 2
    if sections is not None:
        assert sum(sections) == half, (sections, half)
    freqs, sec = _rope_tables(half, float(theta), sections, x.device)
    if sec is None:
        ang = positions.float()[..., None] * freqs         # (B, S, half)
    else:
        pos = positions.float().permute(1, 2, 0)            # (B, S, 3)
        pos = torch.gather(pos, -1, sec.expand(*pos.shape[:2], half))
        ang = pos * freqs
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


def mlp_apply(p, x: torch.Tensor, cfg: ModelConfig, model=None,
              d_ff: Optional[int] = None) -> torch.Tensor:
    """The MLP (``d_ff``: its ffn width, as ``mlp_init``'s). Under a
    ``model`` group whose size divides the width, ``w_in``/``w_gate``
    hold this rank's ffn columns and ``w_out`` its rows: the rank's
    partial output is summed over the group (one ``all_reduce`` in the
    activations' dtype)."""
    split = model is not None and "ffn" in split_axes(cfg, model.size,
                                                      d_ff or cfg.d_ff)
    if split:
        x = model.enter(x)
    # GELU is tanh-approximate, as the reference's jax.nn.gelu defaults to
    h = x @ p["w_in"].to(x.dtype)
    if cfg.act == "swiglu":
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * h
    elif cfg.act == "geglu":
        h = F.gelu(x @ p["w_gate"].to(x.dtype), approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    out = h @ p["w_out"].to(x.dtype)
    return model.reduce(out) if split else out


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


def attn_qkv(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
             mrope=None, model=None):
    """q (B, S, H, hd), k and v (B, S, Hkv, hd), RoPE applied. Under a
    ``model`` group that splits the heads, the rank's H / n query heads
    and the KV heads they read: its Hkv / n own where the group splits
    the KV heads too, else the replicated ``wk``/``wv`` (their gradient
    summed over the group, each rank's holding only its query heads'
    share) give all Hkv heads, of which query head ``j`` of rank ``r``
    reads head ``(r * H / n + j) // rep``: k and v come back with H / n
    heads then."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    wk, wv = p["wk"], p["wv"]
    split = _split(cfg, model)
    if "heads" in split:
        H //= model.size
        if "kv_heads" in split:
            Hkv //= model.size
        else:
            wk, wv = model.enter(wk), model.enter(wv)
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, H, hd)
    k = (x @ wk.to(x.dtype)).reshape(B, S, Hkv, hd)
    v = (x @ wv.to(x.dtype)).reshape(B, S, Hkv, hd)
    q = rope(q, positions, cfg.rope_theta, mrope)
    k = rope(k, positions, cfg.rope_theta, mrope)
    if "heads" in split and "kv_heads" not in split:
        rep = cfg.n_heads // cfg.n_kv_heads
        idx = (model.index * H + torch.arange(H, device=x.device)) // rep
        k, v = k[:, :, idx], v[:, :, idx]
    return q, k, v


def attn_apply(p, x: torch.Tensor, cfg: ModelConfig,
               pattern: HybridSparsePattern,
               positions: Optional[torch.Tensor] = None, mrope=None,
               group=None, model=None):
    """Full-sequence attention (train). x: (B, S, d); positions (B, S), or
    (3, B, S) under M-RoPE (``mrope``: the sections); returns (B, S, d).
    (The reference also returns (k, v) for its prefill-to-cache path; the
    port prefills through :func:`attn_chunk_prefill`. Its ``kv`` argument
    has no caller: cross attention is :func:`cross_attn_apply`.)

    ``group`` (a :class:`~repro_torch.dist.group.SeqGroup`): sequence-
    parallel training. x is this rank's slice of S tokens of the
    sequence, the default positions are its global ones (``group.index *
    S + arange(S)``; M-RoPE's come from the caller, its slice of the
    global ones) and the attention runs sharded. q and k are rotated
    before :func:`~repro_torch.core.attention.hybrid_attention` routes to
    the sharded op, so the halo carries rotated K, as one device's
    attention reads it.

    ``model`` (a :class:`~repro_torch.dist.group.ModelGroup`): tensor-
    parallel training. Where the group's size divides the heads, the
    rank runs its H / n heads (:func:`attn_qkv`) through the same op,
    then its rows of ``wo``, and the partial outputs are summed over the
    group (one ``all_reduce`` of (B, S, d) in the activations' dtype);
    otherwise the attention runs whole on every rank, with no collective.

    The (B, S, H, hd) -> (B*H, S, hd) layout change is a copy in torch
    (a free transpose in XLA)."""
    B, S, _ = x.shape
    split = "heads" in _split(cfg, model)
    if split:
        x = model.enter(x)
    if positions is None:
        start = 0 if group is None else group.index * S
        positions = torch.arange(start, start + S,
                                 device=x.device).expand(B, S)
    q, k, v = attn_qkv(p, x, cfg, positions, mrope, model=model)
    out = hybrid_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), pattern,
        impl=cfg.salo.impl, block_q=cfg.salo.block_q,
        block_k=cfg.salo.block_k, group=group)
    out = out.transpose(1, 2).reshape(B, S, q.shape[2] * cfg.hd)
    out = out @ p["wo"].to(x.dtype)
    return model.reduce(out) if split else out


# ------------------- continuous-batching serve paths -------------------- #
def attn_chunk_prefill(p, x_chunk, ctx_k, ctx_v, ctx_pos, pos_q, kv_blocks,
                       flags, cfg: ModelConfig,
                       pattern: HybridSparsePattern, group=None):
    """One prompt chunk through a layer's attention (plan-driven prefill).

    x_chunk: (1, Cp, d); ctx_k/ctx_v: (1, S_req, Hkv, hd) the request's
    paged KV view; ctx_pos: (1, S_req) live slot positions; pos_q: (1, Cp)
    chunk positions (PAD_SENTINEL on padded rows); kv_blocks/flags:
    (nq, W) ChunkPlan step tables. Returns (out, k_chunk, v_chunk) — the
    fresh chunk KV for the caller's slab write-back.

    ``group`` (a :class:`~repro_torch.dist.group.SeqGroup`): sequence-
    parallel serving. The ctx view, its positions and the tables cover only
    the slots this shard owns (and the chunk itself on the chunk-owner
    shard); the f32 partial (out, m, l) is merged across the group and
    rounded once to the compute dtype before the output projection."""
    B, Cp, _ = x_chunk.shape
    rope_pos = torch.where(pos_q < PAD_SENTINEL, pos_q, 0)
    q, k, v = attn_qkv(p, x_chunk, cfg, rope_pos)
    k_view = torch.cat([ctx_k.to(k.dtype), k], dim=1)
    v_view = torch.cat([ctx_v.to(v.dtype), v], dim=1)
    pos_k = torch.cat([ctx_pos, pos_q], dim=1)
    res = hybrid_chunk_attention(
        q.transpose(1, 2), k_view.transpose(1, 2), v_view.transpose(1, 2),
        pos_q, pos_k, kv_blocks, flags, pattern,
        return_state=group is not None)
    out = res if group is None else \
        masked_psum_merge(*res, group).to(x_chunk.dtype)
    out = out.transpose(1, 2).reshape(B, Cp, cfg.n_heads * cfg.hd)
    return out @ p["wo"].to(x_chunk.dtype), k, v


def attn_decode_paged(p, x_t, k_slab, v_slab, page_tables, slot_pos, t_vec,
                      phys_w, off_w, cfg: ModelConfig,
                      pattern: HybridSparsePattern, k_scale=None,
                      v_scale=None, want_page_stats: bool = False,
                      group=None):
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

    ``group`` (a :class:`~repro_torch.dist.group.SeqGroup`): sequence-
    parallel serving (the reference's ``axis``). The slab, page tables and
    slot positions are this shard's (npp = ``pages_per_shard``; writes of
    slots owned elsewhere already routed to the null page through
    ``phys_w``), so the one decode launch covers only the owned slots and
    runs with ``return_state``; its f32 (out, m, l) is merged across the
    group (:func:`~repro_torch.dist.sharded_plan.masked_psum_merge`) and
    rounded once to the compute dtype. ``page_m`` then covers this shard's
    pages.

    Returns the reference's ``(out, k_slab, v_slab, k_scale, v_scale,
    page_m)``; the slab and scale tensors are the ones passed in, updated
    in place."""
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
                            v_scale=v_scale, return_state=group is not None,
                            return_page_stats=want_page_stats)
    res = res if isinstance(res, tuple) else (res,)
    page_m = res[-1] if want_page_stats else None
    out = res[0] if group is None else \
        masked_psum_merge(*res[:3], group).to(x_t.dtype)
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
                pattern: HybridSparsePattern, positions=None, mrope=None):
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
    ``cfg.salo.decode_slice``). ``positions``: the token's RoPE positions,
    (B, 1), or (3, B, 1) under M-RoPE (``mrope``: the sections); by
    default ``t`` in every component (M-RoPE text decode: all three
    advance together). Returns (out, cache_k, cache_v), the caches being
    the ones passed in."""
    B = x_t.shape[0]
    t = int(t)
    if positions is None:
        shape = (3, B, 1) if mrope is not None else (B, 1)
        positions = torch.full(shape, t, dtype=torch.int32,
                               device=x_t.device)
    q, k, v = attn_qkv(p, x_t, cfg, positions, mrope)
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


# --------------------------- cross attention ----------------------------- #
def _cross_attend(q, k, v, cfg: ModelConfig, dtype) -> torch.Tensor:
    """Dense softmax attention of q (B, S, H, hd) over the encoder's k, v
    (B, Se, Hkv, hd), no mask and no RoPE; GQA by repeating each KV head
    over its query heads. Both products run on f32 copies (exact 16-bit
    products, f32 sums, as the reference's ``preferred_element_type``)
    and the softmax in f32; one rounding to ``dtype`` at the end.
    Returns (B, S, H * hd)."""
    B, S, H, hd = q.shape
    if k.shape[2] != H:
        k = k.repeat_interleave(H // k.shape[2], dim=2)
        v = v.repeat_interleave(H // v.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return out.to(dtype).reshape(B, S, H * hd)


def cross_attn_apply(p, x: torch.Tensor, enc_out: torch.Tensor,
                     cfg: ModelConfig, model=None) -> torch.Tensor:
    """Encoder-decoder cross attention (whisper): x (B, S, d) attends the
    whole encoder output enc_out (B, Se, d), dense and rectangular (S !=
    Se), so plain torch rather than the square-pattern SALO engines, as in
    the reference (an einsum under XLA there). Returns (B, S, d). (The
    reference also returns the encoder's (k, v); the lockstep cache's
    ``xk``/``xv`` are ``enc_out @ wk`` and ``enc_out @ wv``.)

    ``model``: the heads split as :func:`attn_apply` splits them. x and
    enc_out, whole on every rank, feed each rank's heads, so both pass
    ``model.enter``; the partial outputs are summed."""
    B, S, _ = x.shape
    Se = enc_out.shape[1]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    wk, wv = p["wk"], p["wv"]
    split = _split(cfg, model)
    if "heads" in split:
        x, enc_out = model.enter(x), model.enter(enc_out)
        H //= model.size
        if "kv_heads" in split:
            Hkv //= model.size
        else:
            wk, wv = model.enter(wk), model.enter(wv)
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, H, hd)
    k = (enc_out @ wk.to(x.dtype)).reshape(B, Se, Hkv, hd)
    v = (enc_out @ wv.to(x.dtype)).reshape(B, Se, Hkv, hd)
    if "heads" in split and "kv_heads" not in split:
        rep = cfg.n_heads // cfg.n_kv_heads
        idx = (model.index * H + torch.arange(H, device=x.device)) // rep
        k, v = k[:, :, idx], v[:, :, idx]
    out = _cross_attend(q, k, v, cfg, x.dtype) @ p["wo"].to(x.dtype)
    return model.reduce(out) if "heads" in split else out


def cross_attn_decode(p, x_t: torch.Tensor, k_enc: torch.Tensor,
                      v_enc: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Decode-time cross attention of x_t (B, 1, d) over the cached
    encoder K/V (B, Se, Hkv, hd). Returns (B, 1, d)."""
    B = x_t.shape[0]
    q = (x_t @ p["wq"].to(x_t.dtype)).reshape(B, 1, cfg.n_heads, cfg.hd)
    return _cross_attend(q, k_enc, v_enc, cfg, x_t.dtype) @ \
        p["wo"].to(x_t.dtype)


def sinusoidal_pos(S: int, d: int, dtype, device="cpu") -> torch.Tensor:
    """Whisper-style sinusoidal positional embedding (S, d): built in
    numpy f64 and rounded once to ``dtype`` (the caller adds it in its
    own dtype, as the reference does)."""
    half = d // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / max(half - 1, 1))
    ang = np.arange(S)[:, None] * freqs[None, :]
    pe = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(pe).to(dtype=dtype, device=device)


# ------------------------------ embedding -------------------------------- #
def embed_init(gen, cfg: ModelConfig, device):
    # std 1/sqrt(d): embed_apply rescales by sqrt(d) to unit variance, and
    # the (tied) readout keeps logits O(1) at init.
    std = cfg.d_model ** -0.5
    w = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                    device=gen.device) * std
    return {"w": w.to(device=device, dtype=dt(cfg))}


def embed_apply(p, tokens: torch.Tensor, cfg: ModelConfig,
                model=None) -> torch.Tensor:
    """Token embedding, scaled by sqrt(d). Under a ``model`` group whose
    size divides the vocabulary, ``p["w"]`` holds this rank's contiguous
    vocab rows: the rank looks up the tokens in its range, writes zeros
    elsewhere, and the group sums (exact: one rank holds each row)."""
    if "vocab" in _split(cfg, model):
        rows = p["w"].shape[0]
        local = tokens - model.index * rows
        inside = (local >= 0) & (local < rows)
        x = p["w"][local.clamp(0, rows - 1)]
        x = model.reduce(torch.where(inside[..., None], x, 0.0).to(
            dt(cfg, "compute")))
    else:
        x = p["w"][tokens].to(dt(cfg, "compute"))
    # a Python float keeps bf16 activations bf16 (gemma-style scaling)
    return x * float(math.sqrt(cfg.d_model))


def logits_apply(p_embed, p_head, x: torch.Tensor, cfg: ModelConfig,
                 model=None) -> torch.Tensor:
    """The LM head's logits (B, S, V), soft-capped if the arch says so.
    Under a ``model`` group that splits the vocabulary, this rank's
    vocab slice (B, S, V / n); the softcap is elementwise."""
    if "vocab" in _split(cfg, model):
        x = model.enter(x)
    w = (p_embed["w"] if cfg.tie_embeddings else p_head["w"]).to(x.dtype)
    logits = x @ w.T
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  group=None, model=None) -> torch.Tensor:
    """logits (B, S, V), targets (B, S) int. Mean NLL over mask, in f32.

    Under a sequence ``group`` the tokens are this rank's slice: the
    result is the local sum of token losses over the group's total token
    count (one ``all_reduce`` of the count, which carries no gradient), so
    the ranks' results add up to the whole sequence's mean.

    ``model`` (a :class:`~repro_torch.dist.group.ModelGroup`): the logits
    are this rank's contiguous vocab slice (B, S, V / n), vocab-parallel
    in f32: the row max over the group (``pmax_``, no gradient), the sum
    of exp over the group, and the gold logit from the rank whose slice
    holds the target (zeros elsewhere, summed). Every rank runs every
    collective, with or without gold tokens, and gets the same loss."""
    lf = logits.float()
    if model is None:
        logz = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    else:
        rows = lf.shape[-1]
        m = model.pmax_(lf.detach().amax(dim=-1).contiguous())
        logz = m + torch.log(model.reduce(
            torch.exp(lf - m[..., None]).sum(dim=-1)))
        local = targets.long() - model.index * rows
        inside = (local >= 0) & (local < rows)
        gold = torch.gather(lf, -1, local.clamp(0, rows - 1)[..., None])
        gold = model.reduce(torch.where(inside, gold[..., 0], 0.0))
    nll = logz - gold
    if group is None:
        if mask is None:
            return nll.mean()
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    mask = torch.ones_like(nll) if mask is None else mask.float()
    count = group.psum_(mask.sum().detach().reshape(1))
    return (nll * mask).sum() / torch.clamp(count[0], min=1.0)
