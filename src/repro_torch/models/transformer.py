"""Block assembly: training forward and the serving paths.

The port of :mod:`repro.models.transformer` for the dense ``attn_mlp``
programs: the training forward, the continuous engine's paged paths and
the lockstep engine's decode caches. An
architecture is a *program*: a list of (block_kind, count) segments. The
reference stacks each segment's layer parameters on a leading axis and
runs ``jax.lax.scan``; here a segment's parameters are a list of
per-layer dicts and the scan is a Python loop over the layer index. The
paged slab keeps the reference's stacked layout ``(n_layers, n_pages,
page, Hkv, hd)``; layer ``i`` writes row ``i`` of it in place.

Remat: ``remat="full"`` runs each block under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` — the
backward re-runs the block's forward (one more attention forward launch
per layer), as ``jax.checkpoint`` does; ``remat="none"`` is a plain loop.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.serve.paged_cache import (PagedSlab, gather_view,
                                           quant_slab_write, slab_write)

ATTN_KINDS = ("attn_mlp",)


def _not_ported_kind(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"block kind {kind!r} is not ported yet: ROADMAP 'other model "
        "families'")


def make_program(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """(block_kind, count) segments. The port serves dense attention
    programs only so far; other families raise."""
    if cfg.family in ("ssm", "hybrid", "moe") or cfg.encoder_decoder:
        raise NotImplementedError(
            f"{cfg.family} programs are not ported yet: ROADMAP "
            "'other model families'")
    return [("attn_mlp", cfg.n_layers)]


def block_init(gen, cfg: ModelConfig, kind: str, device):
    if kind != "attn_mlp":
        raise _not_ported_kind(kind)
    return {"ln1": L.rmsnorm_init(cfg.d_model, device),
            "attn": L.attn_init(gen, cfg, device),
            "ln2": L.rmsnorm_init(cfg.d_model, device),
            "mlp": L.mlp_init(gen, cfg, device)}


def segment_init(gen, cfg: ModelConfig, kind: str, n: int, device):
    return [block_init(gen, cfg, kind, device) for _ in range(n)]


def block_apply(p, x: torch.Tensor, cfg: ModelConfig, kind: str, pattern,
                positions=None):
    """Full-sequence block. Returns x (the reference also returns the MoE
    aux losses, which dense blocks do not have)."""
    if kind != "attn_mlp":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet: "
                                  "ROADMAP queue 1, 'other model families'")
    h = L.attn_apply(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                     pattern, positions=positions)
    x = x + h
    h2 = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h2, cfg)


def segment_apply(params, x: torch.Tensor, cfg: ModelConfig, kind: str,
                  pattern, positions=None):
    """Run one segment's layers (the reference's scan). Returns x."""
    if cfg.remat not in ("none", "full"):
        raise NotImplementedError(
            f"remat={cfg.remat!r} is not ported yet (the 'dots' policy "
            "saves matmul outputs: ROADMAP queue 1, 'remat=\"dots\"'); use "
            "'full' or 'none'")

    def body(layer_params, y):
        return block_apply(layer_params, y, cfg, kind, pattern,
                           positions=positions)

    for layer_params in params:
        if cfg.remat == "full":
            x = checkpoint(body, layer_params, x, use_reentrant=False)
        else:
            x = body(layer_params, x)
    return x


def _ffn_residual(p, x: torch.Tensor, cfg: ModelConfig,
                  kind: str) -> torch.Tensor:
    """The post-attention FFN residual of an attention block."""
    if kind not in ATTN_KINDS:
        raise ValueError(f"continuous serving supports attention block kinds "
                         f"{ATTN_KINDS}, got {kind!r}")
    h2 = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h2, cfg)


def block_chunk_prefill(p, x, ctx_k, ctx_v, ctx_pos, pos_q, kv_blocks,
                        flags, cfg: ModelConfig, kind: str, pattern):
    """One prompt chunk through one block. Returns (x, k_chunk, v_chunk)."""
    h, k_c, v_c = L.attn_chunk_prefill(
        p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), ctx_k, ctx_v,
        ctx_pos, pos_q, kv_blocks, flags, cfg, pattern)
    return _ffn_residual(p, x + h, cfg, kind), k_c, v_c


def block_decode_paged(p, x_t, k_slab, v_slab, page_tables, slot_pos, t_vec,
                       phys_w, off_w, cfg: ModelConfig, kind: str, pattern,
                       k_scale=None, v_scale=None,
                       want_page_stats: bool = False):
    """Ragged one-token decode through one block against its slab layer
    (written in place). Returns (x, k_slab, v_slab, k_scale, v_scale,
    page_m) — scales / stats ``None`` unless the slab is int8 / stats were
    asked for."""
    h, k_slab, v_slab, k_scale, v_scale, page_m = L.attn_decode_paged(
        p["attn"], L.rmsnorm(p["ln1"], x_t, cfg.norm_eps), k_slab, v_slab,
        page_tables, slot_pos, t_vec, phys_w, off_w, cfg, pattern,
        k_scale=k_scale, v_scale=v_scale, want_page_stats=want_page_stats)
    return (_ffn_residual(p, x_t + h, cfg, kind), k_slab, v_slab, k_scale,
            v_scale, page_m)


def _layer_scales(slab: PagedSlab, i: int):
    """Layer ``i``'s (k_scale, v_scale) rows of an int8 slab, else Nones."""
    if not slab.quantized:
        return None, None
    return slab.k_scale[i], slab.v_scale[i]


def segment_chunk_prefill(params, slab: PagedSlab, x, page_table, ctx_pos,
                          pos_q, kv_blocks, flags, phys_w, off_w,
                          cfg: ModelConfig, kind: str, pattern):
    """Run one segment's layers over a prompt chunk, writing the slab.

    ``slab``: the segment's :class:`PagedSlab` (leading layer axis);
    ``page_table``: (npp,) int32 the request's pages; ``phys_w``/``off_w``:
    (Cp,) int32 slab write targets for the chunk positions (ring-
    overwritten and padded positions already routed to the null page).
    Each layer reads its context view before its chunk is written back.
    int8 slabs dequantize the context view at the gather and quantize the
    chunk KV at the write-back (monotone per-page scale growth), each
    layer with its own scale row. Returns x."""
    for i, layer_params in enumerate(params):
        k_l, v_l = slab.k[i], slab.v[i]
        ks_l, vs_l = _layer_scales(slab, i)
        ctx_k, ctx_v = gather_view(
            k_l, v_l, page_table[None],
            *((ks_l, vs_l, x.dtype) if slab.quantized else ()))
        x, k_c, v_c = block_chunk_prefill(
            layer_params, x, ctx_k, ctx_v, ctx_pos, pos_q, kv_blocks, flags,
            cfg, kind, pattern)
        if slab.quantized:
            quant_slab_write(k_l, v_l, ks_l, vs_l, phys_w, off_w, k_c[0],
                             v_c[0])
        else:
            slab_write(k_l, v_l, phys_w, off_w, k_c[0], v_c[0])
    return x


def segment_decode_paged(params, slab: PagedSlab, x_t, page_tables,
                         slot_pos, t_vec, phys_w, off_w, cfg: ModelConfig,
                         kind: str, pattern, want_page_stats: bool = False):
    """Run one segment's layers for one ragged decode step (slab written
    in place). Returns x_t — and, when ``want_page_stats``, ``page_m``
    (R, npp): the max masked score over the segment's layers per
    (request, logical page)."""
    pm = None
    for i, layer_params in enumerate(params):
        ks_l, vs_l = _layer_scales(slab, i)
        x_t, _, _, _, _, pm_l = block_decode_paged(
            layer_params, x_t, slab.k[i], slab.v[i], page_tables, slot_pos,
            t_vec, phys_w, off_w, cfg, kind, pattern, k_scale=ks_l,
            v_scale=vs_l, want_page_stats=want_page_stats)
        if want_page_stats:
            pm = pm_l if pm is None else torch.maximum(pm, pm_l)
    return (x_t, pm) if want_page_stats else x_t


# ------------------------ lockstep decode caches ------------------------ #
def block_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, device):
    """One block's lockstep decode cache: ``{"k", "v"}`` of (batch, S, Hkv,
    hd), S = ``max_len`` (full cache) or ``min(max_len, window + g)``
    (SALO ring cache). The SSM / recurrent / cross-attention caches come
    with their families."""
    if kind not in ATTN_KINDS:
        raise _not_ported_kind(kind)
    if cfg.salo.ring_cache:
        max_len = min(max_len, cfg.salo.window + cfg.salo.n_global)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def block_decode(p, cache, x_t, t: int, cfg: ModelConfig, kind: str,
                 pattern):
    """One-token lockstep decode through one block; the cache is written
    in place. Returns (x_t, cache)."""
    if kind not in ATTN_KINDS:
        raise _not_ported_kind(kind)
    h, _, _ = L.attn_decode(p["attn"], L.rmsnorm(p["ln1"], x_t, cfg.norm_eps),
                            cache["k"], cache["v"], t, cfg, pattern)
    return _ffn_residual(p, x_t + h, cfg, kind), cache


def segment_decode(params, caches, x_t, t: int, cfg: ModelConfig, kind: str,
                   pattern):
    """One lockstep decode step through a segment's layers (the
    reference's scan): layer ``i`` uses row ``i`` of the stacked caches
    ``{"k", "v"}`` of (n, B, S, Hkv, hd). Returns (x_t, caches)."""
    for i, layer_params in enumerate(params):
        x_t, _ = block_decode(layer_params,
                              {"k": caches["k"][i], "v": caches["v"][i]},
                              x_t, t, cfg, kind, pattern)
    return x_t, caches
