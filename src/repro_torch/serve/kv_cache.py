"""KV caches for lockstep serving: dense baseline and the SALO ring cache.

The port of :mod:`repro.serve.kv_cache`.

Baseline: a full ``(B, seq_len, Hkv, hd)`` cache — slot == absolute
position.

**SALO ring cache**: under the paper's hybrid sparse pattern a decode step
only reads the ``n_global`` sink keys plus the last ``window`` keys, so the
cache needs ``window + n_global`` slots whatever the context length.
Slots carry their absolute position; the position-based decode masks make
ring indexing transparent. Layout: slots ``[0, g)`` pinned to the sink
tokens, slots ``[g, g + w)`` a ring keyed by ``(position - g) % window``.

This is the *lockstep* cache: ``positions`` is shared by the whole batch,
so every sequence sits at the same ``t``. The continuous engine uses the
pooled paged slab (:mod:`repro_torch.serve.paged_cache`), with per-request
page tables and positions and a ring sized for the dilated lookback.
The cache is full precision only; the int8 path lives in the paged slab.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import torch

from repro_torch.core.scheduler import PAD_SENTINEL


class RingCache(NamedTuple):
    k: torch.Tensor           # (B, g + w, Hkv, hd)
    v: torch.Tensor
    positions: torch.Tensor   # (g + w,) int32 absolute position (-1 = empty)


def ring_init(batch: int, window: int, n_global: int, n_kv_heads: int,
              head_dim: int, dtype, device="cuda") -> RingCache:
    warnings.warn(
        "ring_init builds the legacy LOCKSTEP ring cache (whole-batch "
        "shared positions, dilation-unaware ring sizing); new serving "
        "paths should use the pooled paged slab "
        "(repro_torch.serve.paged_cache.layout_for_pattern + slab_init)",
        DeprecationWarning, stacklevel=2)
    size = n_global + window
    shape = (batch, size, n_kv_heads, head_dim)
    return RingCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        positions=torch.full((size,), -1, dtype=torch.int32, device=device))


def ring_update(cache: RingCache, k_t: torch.Tensor, v_t: torch.Tensor,
                t: int, window: int, n_global: int) -> RingCache:
    """Insert the KV of position ``t`` (k_t: (B, 1, Hkv, hd)), IN PLACE.
    Returns the cache (the same tensors)."""
    t = int(t)
    slot = t if t < n_global else n_global + (t - n_global) % window
    cache.k[:, slot] = k_t[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v_t[:, 0].to(cache.v.dtype)
    cache.positions[slot] = t
    return cache


def ring_positions_mask(cache: RingCache) -> torch.Tensor:
    """Positions array for the decode: empty slots -> PAD_SENTINEL."""
    return torch.where(cache.positions < 0, PAD_SENTINEL, cache.positions)


def bytes_per_layer(batch: int, seq_len: int, n_kv_heads: int, head_dim: int,
                    dtype_bytes: int = 2, *, window: Optional[int] = None,
                    n_global: int = 0) -> int:
    """Cache footprint of one layer, K and V."""
    slots = seq_len if window is None else min(seq_len, window + n_global)
    return 2 * batch * slots * n_kv_heads * head_dim * dtype_bytes
