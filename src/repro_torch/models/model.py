"""Unified model API of the port's serving path: ``Model(cfg, device)``.

* ``init(generator) -> params`` — the reference's distributions, drawn
  from an explicit ``torch.Generator`` (the numbers differ from
  ``jax.random``'s; parity tests convert the reference's parameters with
  :func:`repro_torch.convert.params_from_jax` instead);
* ``_embed_inputs(params, batch)`` — token embedding;
* ``program`` — the (block_kind, count) segments.

``params`` is a plain dict: ``embed``/``ln_f``/(``lm_head``) dicts and one
list of per-layer dicts per segment, under the reference's ``seg{i}_{kind}``
keys. ``forward``/``loss`` come with the training slice.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


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


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    return Model(cfg, device)
