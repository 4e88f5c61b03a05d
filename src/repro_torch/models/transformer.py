"""Block assembly: training forward and the serving paths.

The port of :mod:`repro.models.transformer`: the training forward, the
continuous engine's paged paths and the lockstep engine's decode caches.
An architecture is a *program*: a list of (block_kind, count) segments.
The reference stacks each segment's layer parameters on a leading axis and
runs ``jax.lax.scan``; here a segment's parameters are a list of
per-layer dicts and the scan is a Python loop over the layer index. The
paged slab keeps the reference's stacked layout ``(n_layers, n_pages,
page, Hkv, hd)``; layer ``i`` writes row ``i`` of it in place.

Block kinds:
  attn_mlp        pre-norm attention + MLP           (dense archs)
  attn_mlp_local  the same on the local-window pattern (recurrentgemma)
  ssm             Mamba2 SSD block                   (mamba2)
  rec_mlp         RG-LRU recurrent block + MLP       (recurrentgemma)
  griffin         (rec_mlp, rec_mlp, attn_mlp_local) supergroup, one unit
  attn_moe        attention + MoE FFN                (kimi)
  attn_moe_dense  attention + dense MLP + MoE in parallel (arctic)
  xattn           self attention + cross attention + MLP (whisper's
                  decoder; its encoder is an attn_mlp segment)

A full-sequence block returns ``(x, aux)``: the MoE blocks' aux losses
(:func:`repro_torch.models.moe.moe_apply`), ``{}`` for the other kinds;
a segment sums them over its layers, as the reference's scan does.

Remat: ``remat="full"`` runs each segment element (a layer, or a whole
griffin group, as the reference's scan body) under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` — the
backward re-runs its forward (one more attention forward launch per
attention layer), as ``jax.checkpoint`` does; ``remat="dots"`` does the
same under a selective-checkpoint policy that saves the outputs of the
projections (``aten.mm`` / ``aten.addmm``: the ``x @ w`` products) and
recomputes everything else, as the reference's
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: the MoE
router's and shared expert's products are saved, batched products
(``aten.bmm``: the experts' products and their combine) are recomputed,
and so is the attention forward, whose kernel is launched outside the
dispatcher (so a grad still runs three attention launches a layer,
``kernels.ops.LAUNCH_CONTRACT``);
``remat="none"`` is a plain loop.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.group import gather_weights
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM
from repro_torch.serve.paged_cache import (PagedSlab, gather_view,
                                           quant_slab_write, slab_write)
from repro_torch.tree import tree_map

# attention + a plain MLP
MLP_KINDS = ("attn_mlp", "attn_mlp_local")
# attention + an MoE FFN (arctic's with a dense MLP beside it)
MOE_KINDS = ("attn_moe", "attn_moe_dense")
# the attention block kinds: what the continuous engine serves (the
# reference's ``ATTN_KINDS``; whisper's ``xattn`` is not one of them)
ATTN_KINDS = MLP_KINDS + MOE_KINDS


def make_program(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """(block_kind, count) segments. An encoder-decoder program is its
    decoder stack (the encoder is ``params["enc"]``, run by
    ``Model._encode``); a VLM is a dense ``attn_mlp`` program (its vision
    merge and M-RoPE live in ``Model``)."""
    if cfg.family == "ssm":
        return [("ssm", cfg.n_layers)]
    if cfg.family == "hybrid":
        n_groups, rem = divmod(cfg.n_layers, 3)
        prog = [("griffin", n_groups)]
        if rem:
            prog.append(("rec_mlp", rem))
        return prog
    if cfg.encoder_decoder:
        return [("xattn", cfg.n_layers)]
    if cfg.family == "moe":
        m = cfg.moe
        prog = [("attn_mlp", m.first_k_dense)] if m.first_k_dense else []
        kind = "attn_moe_dense" if m.dense_residual else "attn_moe"
        return prog + [(kind, cfg.n_layers - m.first_k_dense)]
    return [("attn_mlp", cfg.n_layers)]


def block_init(gen, cfg: ModelConfig, kind: str, device, span=None):
    """One block's parameters. ``span`` ``(lo, hi)``: an MoE block's
    expert stacks hold only those experts (``moe.moe_init``)."""
    if kind in ATTN_KINDS:
        p = {"ln1": L.rmsnorm_init(cfg.d_model, device),
             "attn": L.attn_init(gen, cfg, device),
             "ln2": L.rmsnorm_init(cfg.d_model, device)}
        if kind != "attn_moe":
            p["mlp"] = L.mlp_init(gen, cfg, device)
        if kind in MOE_KINDS:
            p["moe"] = MOE.moe_init(gen, cfg, device, span)
        return p
    if kind == "ssm":
        return {"ln1": L.rmsnorm_init(cfg.d_model, device),
                "ssm": SSM.ssm_init(gen, cfg, device)}
    if kind == "rec_mlp":
        return {"ln1": L.rmsnorm_init(cfg.d_model, device),
                "rec": RG.rglru_init(gen, cfg, device),
                "ln2": L.rmsnorm_init(cfg.d_model, device),
                "mlp": L.mlp_init(gen, cfg, device)}
    if kind == "griffin":
        return {"r1": block_init(gen, cfg, "rec_mlp", device),
                "r2": block_init(gen, cfg, "rec_mlp", device),
                "a": block_init(gen, cfg, "attn_mlp_local", device)}
    if kind == "xattn":
        return {"ln1": L.rmsnorm_init(cfg.d_model, device),
                "attn": L.attn_init(gen, cfg, device),
                "ln_x": L.rmsnorm_init(cfg.d_model, device),
                "xattn": L.attn_init(gen, cfg, device),
                "ln2": L.rmsnorm_init(cfg.d_model, device),
                "mlp": L.mlp_init(gen, cfg, device)}
    raise ValueError(kind)


def segment_init(gen, cfg: ModelConfig, kind: str, n: int, device):
    return [block_init(gen, cfg, kind, device) for _ in range(n)]


def _patterns(cfg: ModelConfig, causal: bool = True):
    """The pattern of each attention block kind: recurrentgemma's local
    third runs ``recurrent.local_window``."""
    main = L.salo_pattern(cfg, causal=causal)
    if cfg.recurrent is not None:
        local = dataclasses.replace(cfg.salo,
                                    window=cfg.recurrent.local_window)
        return {"attn_mlp": main,
                "attn_mlp_local": L.salo_pattern(cfg, causal=causal,
                                                 salo=local)}
    return {"attn_mlp": main, "attn_mlp_local": main}


def block_apply(p, x: torch.Tensor, cfg: ModelConfig, kind: str, pattern,
                positions=None, mrope=None, enc_out=None, group=None,
                data=None, model=None):
    """Full-sequence block. ``positions``/``mrope``: the RoPE positions
    and M-RoPE sections; ``enc_out``: the encoder output an ``xattn``
    block cross-attends; ``group``: the sequence group of an attention
    block's attention, an MoE block's routing and a recurrent block's
    conv halo and carry (:func:`check_sequence_parallel`); ``data``: the
    data group of an MoE block's routing; ``model``: the tensor-parallel
    group of every block's products (``dist/sharding.mesh_placements``).
    Returns (x, aux): the MoE blocks' aux losses, else ``{}``."""
    if kind == "xattn":
        x = x + L.attn_apply(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                             cfg, pattern, positions=positions, group=group,
                             model=model)
        x = x + L.cross_attn_apply(
            p["xattn"], L.rmsnorm(p["ln_x"], x, cfg.norm_eps), enc_out, cfg,
            model)
        return x + L.mlp_apply(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps),
                               cfg, model), {}
    if kind == "griffin":
        pats = _patterns(cfg)
        x, _ = block_apply(p["r1"], x, cfg, "rec_mlp", pattern, positions,
                           group=group, model=model)
        x, _ = block_apply(p["r2"], x, cfg, "rec_mlp", pattern, positions,
                           group=group, model=model)
        return block_apply(p["a"], x, cfg, "attn_mlp_local",
                           pats["attn_mlp_local"], positions, group=group,
                           model=model)
    if kind in ATTN_KINDS:
        h = L.attn_apply(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                         cfg, pattern, positions=positions, mrope=mrope,
                         group=group, model=model)
        return _ffn_residual(p, x + h, cfg, kind, data, model, group)
    if kind == "ssm":
        return x + SSM.ssm_apply(p["ssm"],
                                 L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                                 cfg, model, seq=group), {}
    if kind == "rec_mlp":
        x = x + RG.rglru_apply(p["rec"], L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                               cfg, model, seq=group)
        return x + L.mlp_apply(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps),
                               cfg, model), {}
    raise ValueError(kind)


# The products ``remat="dots"`` saves: unbatched matmuls.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


# the block kinds that run under a sequence group of more than one shard
SEQ_KINDS = ("attn_mlp", "ssm", "rec_mlp", "griffin", "xattn") + MOE_KINDS


def check_sequence_parallel(cfg: ModelConfig, kind: str, group) -> None:
    """Which blocks run under a sequence group of more than one shard
    (``SEQ_KINDS``): every program's of the 11 archs. The ``attn_mlp``
    blocks of the dense families (smollm, gemma, phi4-mini, granite,
    longformer) and of the VLM (qwen2-vl: M-RoPE rotates q and k on their
    global positions before the halo carries k), the MoE family's
    (arctic, kimi: the dispatch routes the whole batch's groups on every
    shard, :func:`repro_torch.models.moe.moe_apply`), the recurrent
    families' (recurrentgemma's ``rec_mlp`` and ``griffin`` groups, whose
    local attention takes the sharded route; mamba2's ``ssm``: the conv
    halo and the scans' carries, :mod:`repro_torch.models.rglru`,
    :mod:`repro_torch.models.ssm`) and whisper's ``xattn`` decoder (its
    self attention sharded, its cross attention local against the whole
    encoder output). Any other kind raises."""
    if group is None or group.size == 1:
        return
    if kind not in SEQ_KINDS:
        raise NotImplementedError(
            f"sequence-parallel training runs the block kinds {SEQ_KINDS}; "
            f"{cfg.name}'s {kind!r} blocks under a group of {group.size} "
            f"are not ported: ROADMAP queue 1, 'multi-GPU'")


def segment_apply(params, x: torch.Tensor, cfg: ModelConfig, kind: str,
                  pattern, positions=None, mrope=None, enc_out=None,
                  group=None, data=None, model=None):
    """Run one segment's layers (the reference's scan) under the config's
    remat policy ("none" | "full" | "dots"), a griffin group as one unit.
    ``enc_out`` enters each checkpointed layer from outside it, so its
    gradient flows back into the encoder (non-reentrant checkpoints).
    ``group``: sequence-parallel training, x this rank's slice of the
    sequence (``Model.forward`` checks the kinds first:
    :func:`check_sequence_parallel`; a remat replay runs the attention's
    exchange, the recurrent blocks' halo and carry gathers again, on
    every rank alike). ``data``: data-parallel training,
    x this rank's rows of the global batch (the MoE blocks route over the
    group's dispatch groups: :func:`repro_torch.models.moe.moe_apply`).
    ``model``: tensor-parallel training, x the whole activation on every
    rank and the layers' weights this rank's slices. A
    layer's weights split over the data group (the FSDP fallback:
    :class:`~repro_torch.dist.group.SplitWeight` leaves) are gathered
    inside the layer's body, so ``remat="full"``/``"dots"`` frees them
    after the layer's forward and gathers them again in the backward's
    replay; with ``remat="none"`` autograd keeps every gathered weight to
    the backward (correct, with no memory saved). A remat replay reruns
    the layer's forward collectives inside the backward, in the same
    order on every rank. Returns (x, aux summed over the layers)."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}; choose none, full "
                         "or dots")

    def body(layer_params, y):
        return block_apply(gather_weights(layer_params), y, cfg, kind,
                           pattern,
                           positions=positions, mrope=mrope, enc_out=enc_out,
                           group=group, data=data, model=model)

    total = {}
    for layer_params in params:
        if cfg.remat == "full":
            x, aux = checkpoint(body, layer_params, x, use_reentrant=False)
        elif cfg.remat == "dots":
            x, aux = checkpoint(body, layer_params, x, use_reentrant=False,
                                context_fn=functools.partial(
                                    create_selective_checkpoint_contexts,
                                    _dots_policy))
        else:
            x, aux = body(layer_params, x)
        add_aux(total, aux)
    return x, total


def add_aux(total: dict, aux: dict) -> dict:
    """Add the aux terms ``aux`` into ``total`` key by key, in place."""
    for key, v in aux.items():
        total[key] = total[key] + v if key in total else v
    return total


def _ffn_residual(p, x: torch.Tensor, cfg: ModelConfig, kind: str,
                  data=None, model=None, seq=None):
    """The post-attention FFN residual of an attention block. Returns (x,
    aux): the MoE aux losses, else ``{}`` (the serving paths drop them:
    serving never backprops). ``data``, ``seq``: the data or sequence
    group an MoE block routes over (training); ``model``: the
    tensor-parallel group of a dense MLP and of the experts (expert
    parallelism)."""
    if kind not in ATTN_KINDS:
        raise ValueError(f"continuous serving supports attention block kinds "
                         f"{ATTN_KINDS}, got {kind!r}")
    h2 = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if kind in MLP_KINDS:
        return x + L.mlp_apply(p["mlp"], h2, cfg, model), {}
    y, aux = MOE.moe_apply(p["moe"], h2, cfg, data, model, seq)
    if kind == "attn_moe_dense":    # arctic: the dense MLP beside the MoE
        return x + y + L.mlp_apply(p["mlp"], h2, cfg, model), aux
    return x + y, aux


def block_chunk_prefill(p, x, ctx_k, ctx_v, ctx_pos, pos_q, kv_blocks,
                        flags, cfg: ModelConfig, kind: str, pattern,
                        group=None):
    """One prompt chunk through one block. Returns (x, k_chunk, v_chunk).
    ``group``: this shard's sequence group (sequence-parallel serving)."""
    h, k_c, v_c = L.attn_chunk_prefill(
        p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), ctx_k, ctx_v,
        ctx_pos, pos_q, kv_blocks, flags, cfg, pattern, group=group)
    return _ffn_residual(p, x + h, cfg, kind)[0], k_c, v_c


def block_decode_paged(p, x_t, k_slab, v_slab, page_tables, slot_pos, t_vec,
                       phys_w, off_w, cfg: ModelConfig, kind: str, pattern,
                       k_scale=None, v_scale=None,
                       want_page_stats: bool = False, group=None):
    """Ragged one-token decode through one block against its slab layer
    (written in place). Returns (x, k_slab, v_slab, k_scale, v_scale,
    page_m) — scales / stats ``None`` unless the slab is int8 / stats were
    asked for. ``group``: this shard's sequence group."""
    h, k_slab, v_slab, k_scale, v_scale, page_m = L.attn_decode_paged(
        p["attn"], L.rmsnorm(p["ln1"], x_t, cfg.norm_eps), k_slab, v_slab,
        page_tables, slot_pos, t_vec, phys_w, off_w, cfg, pattern,
        k_scale=k_scale, v_scale=v_scale, want_page_stats=want_page_stats,
        group=group)
    return (_ffn_residual(p, x_t + h, cfg, kind)[0], k_slab, v_slab, k_scale,
            v_scale, page_m)


def _layer_scales(slab: PagedSlab, i: int):
    """Layer ``i``'s (k_scale, v_scale) rows of an int8 slab, else Nones."""
    if not slab.quantized:
        return None, None
    return slab.k_scale[i], slab.v_scale[i]


def segment_chunk_prefill(params, slab: PagedSlab, x, page_table, ctx_pos,
                          pos_q, kv_blocks, flags, phys_w, off_w,
                          cfg: ModelConfig, kind: str, pattern, group=None):
    """Run one segment's layers over a prompt chunk, writing the slab.

    ``slab``: the segment's :class:`PagedSlab` (leading layer axis);
    ``page_table``: (npp,) int32 the request's pages; ``phys_w``/``off_w``:
    (Cp,) int32 slab write targets for the chunk positions (ring-
    overwritten and padded positions already routed to the null page).
    Each layer reads its context view before its chunk is written back.
    int8 slabs dequantize the context view at the gather and quantize the
    chunk KV at the write-back (monotone per-page scale growth), each
    layer with its own scale row. Under a sequence ``group`` the slab,
    ``page_table`` (npp = ``pages_per_shard``), ``ctx_pos``, the tables
    and the write targets are this shard's. Returns x."""
    for i, layer_params in enumerate(params):
        k_l, v_l = slab.k[i], slab.v[i]
        ks_l, vs_l = _layer_scales(slab, i)
        ctx_k, ctx_v = gather_view(
            k_l, v_l, page_table[None],
            *((ks_l, vs_l, x.dtype) if slab.quantized else ()))
        x, k_c, v_c = block_chunk_prefill(
            layer_params, x, ctx_k, ctx_v, ctx_pos, pos_q, kv_blocks, flags,
            cfg, kind, pattern, group=group)
        if slab.quantized:
            quant_slab_write(k_l, v_l, ks_l, vs_l, phys_w, off_w, k_c[0],
                             v_c[0])
        else:
            slab_write(k_l, v_l, phys_w, off_w, k_c[0], v_c[0])
    return x


def segment_decode_paged(params, slab: PagedSlab, x_t, page_tables,
                         slot_pos, t_vec, phys_w, off_w, cfg: ModelConfig,
                         kind: str, pattern, want_page_stats: bool = False,
                         group=None):
    """Run one segment's layers for one ragged decode step (slab written
    in place). Returns x_t — and, when ``want_page_stats``, ``page_m``
    (R, npp): the max masked score over the segment's layers per
    (request, logical page). Under a sequence ``group`` the slab, page
    tables and slot positions are this shard's, and so is ``page_m``
    (npp = ``pages_per_shard``)."""
    pm = None
    for i, layer_params in enumerate(params):
        ks_l, vs_l = _layer_scales(slab, i)
        x_t, _, _, _, _, pm_l = block_decode_paged(
            layer_params, x_t, slab.k[i], slab.v[i], page_tables, slot_pos,
            t_vec, phys_w, off_w, cfg, kind, pattern, k_scale=ks_l,
            v_scale=vs_l, want_page_stats=want_page_stats, group=group)
        if want_page_stats:
            pm = pm_l if pm is None else torch.maximum(pm, pm_l)
    return (x_t, pm) if want_page_stats else x_t


# ------------------------ lockstep decode caches ------------------------ #
def block_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, device):
    """One block's lockstep decode cache. Attention: ``{"k", "v"}`` of
    (batch, S, Hkv, hd), S = ``max_len`` (full cache) or ``min(max_len,
    window + g)`` (SALO ring cache). SSM: ``{"conv"}`` (batch, W-1, d_inner
    + 2N) in ``dtype`` and ``{"state"}`` (batch, H, N, P) f32. RG-LRU:
    ``{"conv"}`` (batch, W-1, d_rnn) in ``dtype`` and ``{"state"}`` (batch,
    d_rnn) f32. Griffin: ``{"r1", "r2", "a"}`` of those. ``xattn``: the
    attention caches and the cross caches ``{"xk", "xv"}`` of (batch,
    n_audio_frames, Hkv, hd), the encoder's K/V (zeros here: the lockstep
    engine feeds tokens only and fills none, as the reference's)."""
    if cfg.salo.ring_cache:
        max_len = min(max_len, cfg.salo.window + cfg.salo.n_global)
    z = functools.partial(torch.zeros, device=device)
    if kind == "griffin":
        return {"r1": block_cache_init(cfg, "rec_mlp", batch, max_len, dtype,
                                       device),
                "r2": block_cache_init(cfg, "rec_mlp", batch, max_len, dtype,
                                       device),
                "a": block_cache_init(cfg, "attn_mlp_local", batch, max_len,
                                      dtype, device)}
    if kind in ATTN_KINDS or kind == "xattn":
        shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
        cache = {"k": z(shape, dtype=dtype), "v": z(shape, dtype=dtype)}
        if kind == "xattn":
            xshape = (batch, cfg.n_audio_frames, cfg.n_kv_heads, cfg.hd)
            cache.update(xk=z(xshape, dtype=dtype), xv=z(xshape, dtype=dtype))
        return cache
    if kind == "ssm":
        d_inner, H, N, P = SSM._dims(cfg)
        W = cfg.ssm.conv_width
        return {"conv": z((batch, W - 1, d_inner + 2 * N), dtype=dtype),
                "state": z((batch, H, N, P), dtype=torch.float32)}
    if kind == "rec_mlp":
        dr = RG._d_rnn(cfg)
        W = cfg.recurrent.conv_width
        return {"conv": z((batch, W - 1, dr), dtype=dtype),
                "state": z((batch, dr), dtype=torch.float32)}
    raise ValueError(kind)


def block_decode(p, cache, x_t, t: int, cfg: ModelConfig, kind: str,
                 pattern, positions=None, mrope=None):
    """One-token lockstep decode through one block. Attention caches are
    written in place and returned; the recurrent blocks return new
    ``conv``/``state`` tensors. ``positions``/``mrope``: the token's RoPE
    positions and M-RoPE sections (``attn_decode``'s defaults when None).
    Returns (x_t, cache)."""
    if kind == "xattn":
        h, _, _ = L.attn_decode(p["attn"],
                                L.rmsnorm(p["ln1"], x_t, cfg.norm_eps),
                                cache["k"], cache["v"], t, cfg, pattern,
                                positions=positions)
        x_t = x_t + h
        x_t = x_t + L.cross_attn_decode(
            p["xattn"], L.rmsnorm(p["ln_x"], x_t, cfg.norm_eps), cache["xk"],
            cache["xv"], cfg)
        h2 = L.rmsnorm(p["ln2"], x_t, cfg.norm_eps)
        return x_t + L.mlp_apply(p["mlp"], h2, cfg), cache
    if kind == "griffin":
        pats = _patterns(cfg)
        x_t, c1 = block_decode(p["r1"], cache["r1"], x_t, t, cfg, "rec_mlp",
                               pattern)
        x_t, c2 = block_decode(p["r2"], cache["r2"], x_t, t, cfg, "rec_mlp",
                               pattern)
        x_t, c3 = block_decode(p["a"], cache["a"], x_t, t, cfg,
                               "attn_mlp_local", pats["attn_mlp_local"])
        return x_t, {"r1": c1, "r2": c2, "a": c3}
    if kind in ATTN_KINDS:
        h, _, _ = L.attn_decode(p["attn"],
                                L.rmsnorm(p["ln1"], x_t, cfg.norm_eps),
                                cache["k"], cache["v"], t, cfg, pattern,
                                positions=positions, mrope=mrope)
        return _ffn_residual(p, x_t + h, cfg, kind)[0], cache
    if kind == "ssm":
        y, conv, st = SSM.ssm_decode(p["ssm"],
                                     L.rmsnorm(p["ln1"], x_t, cfg.norm_eps),
                                     cache["conv"], cache["state"], cfg)
        return x_t + y, {"conv": conv, "state": st}
    if kind == "rec_mlp":
        y, conv, st = RG.rglru_decode(p["rec"],
                                      L.rmsnorm(p["ln1"], x_t, cfg.norm_eps),
                                      cache["conv"], cache["state"], cfg)
        x_t = x_t + y
        x_t = x_t + L.mlp_apply(p["mlp"],
                                L.rmsnorm(p["ln2"], x_t, cfg.norm_eps), cfg)
        return x_t, {"conv": conv, "state": st}
    raise ValueError(kind)


def _write_back(row, new):
    """Copy a block's new cache leaf into its row of the stacked cache,
    unless the block wrote the row in place."""
    if new is not row:
        row.copy_(new)
    return row


def segment_decode(params, caches, x_t, t: int, cfg: ModelConfig, kind: str,
                   pattern, positions=None, mrope=None):
    """One lockstep decode step through a segment's layers (the
    reference's scan): layer ``i`` uses row ``i`` of every leaf of the
    stacked caches (leading axis n) and its new cache goes back into that
    row, each leaf keeping its dtype. Returns (x_t, caches)."""
    for i, layer_params in enumerate(params):
        rows = tree_map(lambda a: a[i], caches)
        x_t, new = block_decode(layer_params, rows, x_t, t, cfg, kind,
                                pattern, positions=positions, mrope=mrope)
        tree_map(_write_back, rows, new)
    return x_t, caches
