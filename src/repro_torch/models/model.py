"""Unified model API of the port: ``Model(cfg, device)``.

* ``init(generator) -> params`` — the reference's distributions, drawn
  from an explicit ``torch.Generator`` (the numbers differ from
  ``jax.random``'s; parity tests convert the reference's parameters with
  :func:`repro_torch.convert.params_from_jax` instead);
* ``_embed_inputs(params, batch)`` — token embedding;
* ``forward(params, batch, return_aux=False) -> logits`` (train / full
  sequence; with ``return_aux``, ``(logits, aux)``: the MoE aux losses
  summed over every layer);
* ``loss(params, batch) -> (loss, metrics)``;
* ``init_cache(batch_size, max_len) -> cache`` and
  ``decode_step(params, cache, batch_t, t) -> (logits, cache)`` — the
  lockstep decode (the cache is updated in place and returned);
* ``program`` — the (block_kind, count) segments.

``params`` is a plain dict: ``embed``/``ln_f``/(``lm_head``) dicts and one
list of per-layer dicts per segment, under the reference's ``seg{i}_{kind}``
keys.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.tree import tree_map


class Model:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.program = T.make_program(cfg)

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        cfg, dev = self.cfg, self.device
        params: Dict[str, Any] = {"embed": L.embed_init(generator, cfg, dev),
                                  "ln_f": L.rmsnorm_init(cfg.d_model, dev)}
        if not cfg.tie_embeddings:
            params["lm_head"] = {"w": L.embed_init(generator, cfg, dev)["w"]}
        for i, (kind, n) in enumerate(self.program):
            params[f"seg{i}_{kind}"] = T.segment_init(generator, cfg, kind, n,
                                                      dev)
        return params

    def _embed_inputs(self, params, batch) -> torch.Tensor:
        return L.embed_apply(params["embed"], batch["tokens"], self.cfg)

    def forward(self, params, batch, return_aux: bool = False):
        """Logits (B, S, vocab) of the full sequence; with ``return_aux``,
        (logits, aux): the MoE aux losses (``load_balance``, ``router_z``,
        ``dropped_frac``) summed over the segments' layers, ``{}`` for
        the other families."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        positions = batch.get("positions", None)
        pats = T._patterns(cfg)
        aux_total: Dict[str, torch.Tensor] = {}
        for i, (kind, n) in enumerate(self.program):
            x, aux = T.segment_apply(params[f"seg{i}_{kind}"], x, cfg, kind,
                                     pats.get(kind, pats["attn_mlp"]),
                                     positions=positions)
            T.add_aux(aux_total, aux)
        x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        logits = L.logits_apply(params["embed"], params.get("lm_head"), x,
                                cfg)
        return (logits, aux_total) if return_aux else logits

    def loss(self, params, batch):
        """Mean next-token NLL plus the MoE aux losses ``load_balance`` and
        ``router_z``; returns ``(loss, metrics)`` as the reference does:
        ``nll``, every aux term (``dropped_frac`` too) and ``loss``."""
        logits, aux = self.forward(params, batch, return_aux=True)
        nll = L.cross_entropy(logits, batch["labels"], batch.get("mask"))
        loss, metrics = nll, {"nll": nll}
        for key, v in aux.items():
            if key in ("load_balance", "router_z"):
                loss = loss + v
            metrics[key] = v
        metrics["loss"] = loss
        return loss, metrics

    def init_cache(self, batch_size: int, max_len: int) -> Dict[str, Any]:
        """Lockstep decode caches, zeroed, on the model's device, in the
        reference's stacked layout: per segment the block's cache tree
        (``T.block_cache_init``: ``{"k", "v"}`` of attention blocks in the
        compute dtype, the recurrent blocks' ``conv`` in the compute dtype
        and ``state`` in f32) with a leading axis of n layers."""
        cfg, dtype = self.cfg, L.dt(self.cfg, "compute")
        cache = {}
        for i, (kind, n) in enumerate(self.program):
            one = T.block_cache_init(cfg, kind, batch_size, max_len, dtype,
                                     self.device)
            cache[f"seg{i}_{kind}"] = tree_map(
                lambda a: a.new_zeros((n, *a.shape)), one)
        return cache

    def decode_step(self, params, cache, batch_t, t: int):
        """One lockstep decode step. batch_t: ``{"tokens": (B, 1)}``; t:
        the batch's position (an int). Writes the new KV and recurrent
        states into ``cache`` in place; returns (logits (B, 1, vocab),
        cache)."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch_t)
        pats = T._patterns(cfg)
        for i, (kind, n) in enumerate(self.program):
            key = f"seg{i}_{kind}"
            x, cache[key] = T.segment_decode(params[key], cache[key], x, t,
                                             cfg, kind,
                                             pats.get(kind, pats["attn_mlp"]))
        x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        logits = L.logits_apply(params["embed"], params.get("lm_head"), x,
                                cfg)
        return logits, cache


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    return Model(cfg, device)
