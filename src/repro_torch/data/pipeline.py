"""Deterministic synthetic LM data pipeline (numpy only).

The port's own copy of :mod:`repro.data.pipeline`'s ``SyntheticLM``: packed
token streams from a mixture of order-k Markov chains with per-document
transition tables, learnable enough that training shows a real loss curve.
Host-sharded and stateless in (seed, step, host), so batches equal the
reference's bit for bit, the per-family extras (whisper's audio
embeddings; a VLM's vision mask, vision embeddings and M-RoPE positions)
included: they are drawn from the same generator in the reference's order.
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
        """Global-step-indexed batch for THIS host (resume = same stream):
        ``tokens``, ``labels`` (B, S) int32; an encoder-decoder's
        ``audio_embeds`` (B, n_audio_frames, d) f32; a VLM's
        ``vision_mask`` (B, S) bool (the first ``min(n_vision_tokens, S //
        2)`` slots), ``vision_embeds`` (B, S, d) f32 and ``positions`` (3,
        B, S) int32."""
        d, cfg = self.data, self.cfg
        rng = np.random.default_rng((d.seed, step, self.host_id))
        S, B = d.seq_len, self.local_batch
        toks = np.stack([self._sample_doc(rng, S + 1) for _ in range(B)])
        out = {"tokens": toks[:, :S].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
        if cfg.encoder_decoder:
            out["audio_embeds"] = rng.normal(
                size=(B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
        if cfg.n_vision_tokens:
            mask = np.zeros((B, S), bool)
            mask[:, :min(cfg.n_vision_tokens, S // 2)] = True
            out["vision_mask"] = mask
            out["vision_embeds"] = rng.normal(
                size=(B, S, cfg.d_model)).astype(np.float32)
            out["positions"] = np.broadcast_to(
                np.arange(S, dtype=np.int32), (3, B, S)).copy()
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
