"""Unified model API of the port: ``Model(cfg, device)``.

* ``init(generator) -> params`` — the reference's distributions, drawn
  from an explicit ``torch.Generator`` (the numbers differ from
  ``jax.random``'s; parity tests convert the reference's parameters with
  :func:`repro_torch.convert.params_from_jax` instead);
* ``_embed_inputs(params, batch)`` — token embedding, with a VLM's
  projected ``vision_embeds`` merged where ``vision_mask`` is set;
* ``_encode(params, batch)`` — whisper's bidirectional encoder over
  ``audio_embeds`` plus sinusoidal positions;
* ``forward(params, batch, return_aux=False) -> logits`` (train / full
  sequence; with ``return_aux``, ``(logits, aux)``: the MoE aux losses
  summed over every layer);
* ``loss(params, batch, group=None, data=None, model=None) -> (loss,
  metrics)``;
* ``init_cache(batch_size, max_len) -> cache`` and
  ``decode_step(params, cache, batch_t, t) -> (logits, cache)`` — the
  lockstep decode (the cache is updated in place and returned);
* ``program`` — the (block_kind, count) segments.

``params`` is a plain dict: ``embed``/``ln_f``/(``lm_head``) dicts and one
list of per-layer dicts per segment, under the reference's ``seg{i}_{kind}``
keys; an encoder-decoder adds ``enc`` = ``{"seg0_attn_mlp": [per-layer
dicts], "ln_f"}``, a VLM ``vision_proj`` = ``{"w": (d, d)}``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.group import gather_weights
from repro_torch.dist.sharding import split_axes
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.tree import tree_map


class Model:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.program = T.make_program(cfg)

    def init(self, generator: torch.Generator, keep=None,
             span=None) -> Dict[str, Any]:
        """The parameters, drawn from ``generator``. ``keep(path, subtree)
        -> subtree``, if given, takes each top-level entry and each layer
        of a segment as soon as it is drawn (``path``: its key path, a
        tuple of strings): a tensor-parallel rank keeps its slices that
        way (:func:`repro_torch.train.trainer.init_shards`), so it never
        holds more than one whole layer (or the embedding) beside them.
        ``span`` ``(lo, hi)``: every MoE layer's expert stacks hold only
        those experts, drawn expert by expert (an expert-parallel rank's;
        never a whole stack). The draws are the same with or without
        ``keep`` and ``span``."""
        cfg, dev = self.cfg, self.device
        keep = keep or (lambda path, sub: sub)
        params: Dict[str, Any] = {
            "embed": keep(("embed",), L.embed_init(generator, cfg, dev)),
            "ln_f": keep(("ln_f",), L.rmsnorm_init(cfg.d_model, dev))}
        if not cfg.tie_embeddings:
            params["lm_head"] = keep(("lm_head",), {
                "w": L.embed_init(generator, cfg, dev)["w"]})
        for i, (kind, n) in enumerate(self.program):
            key = f"seg{i}_{kind}"
            params[key] = [keep((key, str(j)),
                                T.block_init(generator, cfg, kind, dev,
                                             span))
                           for j in range(n)]
        if cfg.encoder_decoder:
            params["enc"] = keep(("enc",), {
                "seg0_attn_mlp": T.segment_init(generator, cfg, "attn_mlp",
                                                cfg.n_layers, dev),
                "ln_f": L.rmsnorm_init(cfg.d_model, dev)})
        if cfg.n_vision_tokens:
            params["vision_proj"] = keep(("vision_proj",), {
                "w": L.dense_init(generator, cfg.d_model, cfg.d_model,
                                  L.dt(cfg), dev)})
        return params

    def param_shapes(self) -> Dict[str, Any]:
        """The tree :meth:`init` returns, as ``meta`` tensors of the whole
        leaves' shapes and dtypes, with nothing drawn (the reference's
        ``jax.eval_shape(model.init)``): one layer of each segment is
        traced under ``FakeTensorMode`` and stands for all of its layers.
        What placements that read whole shapes take
        (:func:`repro_torch.dist.sharding.mesh_placements`)."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        one = Model(self.cfg, "cpu")
        one.program = [(kind, 1) for kind, _ in self.program]
        with FakeTensorMode():
            fake = one.init(torch.Generator())
        out = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                             device="meta"), fake)
        for i, (kind, n) in enumerate(self.program):
            key = f"seg{i}_{kind}"
            out[key] = out[key] * n
        return out

    def _embed_inputs(self, params, batch, model=None) -> torch.Tensor:
        """Token embeddings; a VLM batch's ``vision_embeds`` (B, S, d),
        projected by ``vision_proj``, replace them where ``vision_mask``
        (B, S) is set (the vision frontend is stubbed: the embeddings come
        aligned to token slots). Under a ``model`` group the merge follows
        the vocab-parallel lookup's sum, alike on every rank (the whole
        ``vision_proj`` on each); under a sequence group each rank
        merges its own slice's slots, with no collective."""
        cfg = self.cfg
        x = L.embed_apply(gather_weights(params["embed"]), batch["tokens"],
                          cfg, model)
        if cfg.n_vision_tokens and "vision_embeds" in batch:
            vis = batch["vision_embeds"].to(x.dtype) @ \
                gather_weights(params["vision_proj"])["w"].to(x.dtype)
            x = torch.where(batch["vision_mask"][..., None], vis, x)
        return x

    def _encode(self, params, batch, model=None) -> torch.Tensor:
        """Whisper's encoder over the stub audio-frame embeddings
        ``audio_embeds`` (B, n_frames, d) plus sinusoidal positions: the
        ``enc`` attn_mlp layers on the bidirectional SALO pattern
        (``longformer(window, n_global)``: global rows and columns), then
        its final norm. Returns (B, n_frames, d), whole on every rank of
        a ``model`` group (its layers split as the decoder's), and on
        every rank of a sequence group too: it takes no group, so each
        rank encodes every frame (1500 frames are no multiple of the
        sharded plan's tiles, and the reference's input spec keeps the
        frame axis whole)."""
        cfg = self.cfg
        pattern = L.salo_pattern(
            cfg, causal=False,
            salo=dataclasses.replace(cfg.salo, bidirectional=True))
        x = batch["audio_embeds"].to(L.dt(cfg, "compute"))
        x = x + L.sinusoidal_pos(x.shape[1], cfg.d_model, x.dtype, x.device)
        x, _ = T.segment_apply(params["enc"]["seg0_attn_mlp"], x, cfg,
                               "attn_mlp", pattern, model=model)
        return L.rmsnorm(gather_weights(params["enc"]["ln_f"]), x,
                         cfg.norm_eps)

    def forward(self, params, batch, return_aux: bool = False, group=None,
                data=None, model=None):
        """Logits (B, S, vocab) of the full sequence; with ``return_aux``,
        (logits, aux): the MoE aux losses (``load_balance``, ``router_z``,
        ``dropped_frac``) summed over the segments' layers, ``{}`` for
        the other families. Under M-RoPE the positions default to
        ``arange(S)`` in all three components, (3, B, S).

        ``group`` (a :class:`~repro_torch.dist.group.SeqGroup`): sequence-
        parallel training; ``batch`` holds this rank's slice of every
        sequence (``trainer._seq_slice``) and the logits are that slice's.
        Every family runs under a group of more than one shard
        (``transformer.check_sequence_parallel``): the recurrent ones
        carry their conv halo and scan state across the shards; a VLM
        merges the vision embeddings of its own slots (a shard with none
        adds zero to ``vision_proj``'s gradient) and its default M-RoPE
        positions are its global ones, ``group.index * S + arange(S)``;
        whisper encodes the whole ``audio_embeds`` on every rank, with
        no collective, and each rank's decoder slice cross-attends the
        whole ``enc_out``. The encoder's and ``vision_proj``'s gradients
        are each rank's share, summed with the others by the step's one
        gradient ``all_reduce``.

        ``data`` (a :class:`~repro_torch.dist.group.DataGroup`): data-
        parallel training; ``batch`` holds this rank's rows of the global
        batch, and the MoE blocks route over the group
        (:func:`repro_torch.models.moe.moe_apply`). ``params`` holds whole
        weights, or under the FSDP fallback this rank's slices of the
        weights it splits, as
        :class:`~repro_torch.dist.group.SplitWeight` leaves: a layer's are
        gathered inside its (remat) body (``transformer.segment_apply``),
        the others once at their first use (the embedding, so a tied
        embedding's two uses meet in one gradient before its one
        reduce-scatter; ``vision_proj``; ``lm_head`` after the
        segments).

        ``model`` (a :class:`~repro_torch.dist.group.ModelGroup`): tensor-
        parallel training; ``params`` holds this rank's slices
        (:func:`repro_torch.dist.sharding.mesh_placements`) and every
        rank of the group the same ``batch``. Where the group splits the
        vocabulary, the logits are this rank's vocab slice (B, S, V / n):
        a caller that needs the whole logits gathers them. A model group
        runs every block kind of the 11 archs, the MoE layers' expert
        stacks split over it where it divides their experts or their ffn
        (``moe.expert_split``), else whole."""
        cfg = self.cfg
        if group is not None and model is not None:
            raise ValueError("a rank is in a sequence group or a model "
                             "group, not both (the reference never maps "
                             "seq and model together in training)")
        for kind, _ in self.program:
            T.check_sequence_parallel(cfg, kind, group)
        params = dict(params, embed=gather_weights(params["embed"]))
        x = self._embed_inputs(params, batch, model)
        positions = batch.get("positions", None)
        mrope = cfg.mrope_sections
        if mrope is not None and positions is None:
            B, S = batch["tokens"].shape
            start = 0 if group is None else group.index * S
            positions = torch.arange(start, start + S,
                                     device=x.device).expand(3, B, S)
        enc_out = self._encode(params, batch, model) \
            if cfg.encoder_decoder else None
        pats = T._patterns(cfg)
        aux_total: Dict[str, torch.Tensor] = {}
        for i, (kind, n) in enumerate(self.program):
            x, aux = T.segment_apply(params[f"seg{i}_{kind}"], x, cfg, kind,
                                     pats.get(kind, pats["attn_mlp"]),
                                     positions=positions, mrope=mrope,
                                     enc_out=enc_out, group=group,
                                     data=data, model=model)
            T.add_aux(aux_total, aux)
        x = L.rmsnorm(gather_weights(params["ln_f"]), x, cfg.norm_eps)
        logits = L.logits_apply(params["embed"],
                                gather_weights(params.get("lm_head")), x,
                                cfg, model)
        return (logits, aux_total) if return_aux else logits

    def loss(self, params, batch, group=None, data=None, model=None):
        """Mean next-token NLL plus the MoE aux losses ``load_balance`` and
        ``router_z``; returns ``(loss, metrics)`` as the reference does:
        ``nll``, every aux term (``dropped_frac`` too) and ``loss``.

        Under a sequence ``group`` (``batch`` this rank's slice) or a
        ``data`` group (``batch`` this rank's rows) every term is this
        rank's share of the whole batch's: the NLL's the local sum of
        token losses over the group's token count, the MoE aux terms' as
        :func:`repro_torch.models.moe.moe_apply` takes them, so the
        gradients summed over the ranks are the whole batch's; the
        metrics are the group's totals (one ``all_reduce``, detached).

        Under a ``model`` group (tensor parallelism, ``params`` this rank's
        slices, the batch the same on every rank of the group) the loss is
        the whole batch's on every rank (vocab-parallel where the group
        splits the vocabulary: :func:`~repro_torch.models.layers
        .cross_entropy`), and so are the metrics, with no sum over the
        group: an MoE layer's aux terms come from the whole router probs
        on every rank and are added once, as on one rank. It composes
        with ``data``: the NLL's share and the metric
        totals then go over the data group only."""
        if group is not None and data is not None:
            raise ValueError("a rank is in a sequence group or a data "
                             "group, not both")
        logits, aux = self.forward(params, batch, return_aux=True,
                                   group=group, data=data, model=model)
        vocab = model if model is not None and "vocab" in split_axes(
            self.cfg, model.size) else None
        nll = L.cross_entropy(logits, batch["labels"], batch.get("mask"),
                              group=group if data is None else data,
                              model=vocab)
        loss, metrics = nll, {"nll": nll}
        for key, v in aux.items():
            if key in ("load_balance", "router_z"):
                loss = loss + v
            metrics[key] = v
        metrics["loss"] = loss
        if group is not None or data is not None:
            keys = list(metrics)
            totals = (group or data).psum_(torch.stack(
                [metrics[k].detach().reshape(()) for k in keys]))
            metrics = dict(zip(keys, totals.unbind()))
        return loss, metrics

    def init_cache(self, batch_size: int, max_len: int) -> Dict[str, Any]:
        """Lockstep decode caches, zeroed, on the model's device, in the
        reference's stacked layout: per segment the block's cache tree
        (``T.block_cache_init``: ``{"k", "v"}`` of attention blocks in the
        compute dtype, and ``{"xk", "xv"}`` of whisper's cross attention,
        the recurrent blocks' ``conv`` in the compute dtype and ``state``
        in f32) with a leading axis of n layers."""
        cfg, dtype = self.cfg, L.dt(self.cfg, "compute")
        cache = {}
        for i, (kind, n) in enumerate(self.program):
            one = T.block_cache_init(cfg, kind, batch_size, max_len, dtype,
                                     self.device)
            cache[f"seg{i}_{kind}"] = tree_map(
                lambda a: a.new_zeros((n, *a.shape)), one)
        return cache

    def decode_step(self, params, cache, batch_t, t: int):
        """One lockstep decode step. batch_t: ``{"tokens": (B, 1)}``, and
        optionally a VLM's (B, 1) ``vision_embeds``/``vision_mask`` and the
        token's ``positions`` ((3, B, 1) under M-RoPE; ``t`` in every
        component by default); t: the batch's position (an int). Writes
        the new KV and recurrent states into ``cache`` in place; returns
        (logits (B, 1, vocab), cache)."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch_t)
        pats = T._patterns(cfg)
        for i, (kind, n) in enumerate(self.program):
            key = f"seg{i}_{kind}"
            x, cache[key] = T.segment_decode(
                params[key], cache[key], x, t, cfg, kind,
                pats.get(kind, pats["attn_mlp"]),
                positions=batch_t.get("positions", None),
                mrope=cfg.mrope_sections)
        x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        logits = L.logits_apply(params["embed"], params.get("lm_head"), x,
                                cfg)
        return logits, cache


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    return Model(cfg, device)
