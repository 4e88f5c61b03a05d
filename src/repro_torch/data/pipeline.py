"""Deterministic synthetic LM data pipeline (numpy only).

The port's own copy of :mod:`repro.data.pipeline`'s ``SyntheticLM``: packed
token streams from a mixture of order-k Markov chains with per-document
transition tables, learnable enough that training shows a real loss curve.
Host-sharded and stateless in (seed, step, host), so batches equal the
reference's bit for bit. The per-family extras (audio, vision, M-RoPE
positions) come with those model families.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_order: int = 2
    n_docs: int = 64          # distinct "documents" (transition tables)
    branch: int = 16          # candidate successors per state


class SyntheticLM:
    """Markov-mixture synthetic corpus. Deterministic in (seed, step, host)."""

    def __init__(self, cfg: ModelConfig, data: DataConfig,
                 host_id: int = 0, n_hosts: int = 1):
        if data.global_batch % n_hosts:
            raise ValueError(f"global batch {data.global_batch} does not "
                             f"split over {n_hosts} hosts")
        if cfg.encoder_decoder or cfg.n_vision_tokens:
            raise NotImplementedError(
                "audio/vision batch extras are not ported yet: ROADMAP "
                "queue 1, 'other model families'")
        self.cfg, self.data = cfg, data
        self.host_id, self.n_hosts = host_id, n_hosts
        self.local_batch = data.global_batch // n_hosts
        rng = np.random.default_rng(data.seed)
        # Tokens are drawn from the first `n_states` vocabulary entries so
        # the Markov state IS the token (no aliasing).
        self.n_states = min(cfg.vocab_size, 4096)
        # Per-doc successor tables: state -> `branch` allowed next tokens.
        self._succ = rng.integers(
            0, self.n_states, size=(data.n_docs, self.n_states, data.branch),
            dtype=np.int32)

    def _sample_doc(self, rng: np.random.Generator, length: int) -> np.ndarray:
        doc = rng.integers(0, self.data.n_docs)
        succ = self._succ[doc]
        toks = np.empty(length, np.int32)
        state = rng.integers(0, self.n_states)
        toks[0] = state
        branches = rng.integers(0, self.data.branch, size=length)
        for i in range(1, length):
            state = succ[state, branches[i]]
            toks[i] = state
        return toks

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Global-step-indexed batch for THIS host (resume = same stream)."""
        d = self.data
        rng = np.random.default_rng((d.seed, step, self.host_id))
        S = d.seq_len
        toks = np.stack([self._sample_doc(rng, S + 1)
                         for _ in range(self.local_batch)])
        return {"tokens": toks[:, :S].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
