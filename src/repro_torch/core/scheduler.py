"""Data scheduler, serving part: the chunk-prefill IR and the serving mask.

The port's counterpart of :mod:`repro.core.scheduler` for the serving
path. It holds

* :func:`causal_step_mask` — the shared serving mask (decode plain
  version, decode kernel, chunked prefill), written in torch;
* :func:`ring_view_positions`, :class:`ChunkPlan` and
  :func:`build_chunk_plan` — the causal chunk-slice of the plan that
  chunked prefill walks (numpy, static metadata, built on the host).

``BandSchedule``/``ExecutionPlan`` and the transposed plans belong to the
training path and are not ported yet. The step-table contract itself
lives in :mod:`repro_torch.core.plan_contract`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core.patterns import HybridSparsePattern
from repro_torch.core.plan_contract import (BIG, STEP_GLOBAL, STEP_WINDOW,
                                            validate_tables)
from repro_torch.core.plan_contract import PAD_SENTINEL as PAD_SENTINEL


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def causal_step_mask(pattern: HybridSparsePattern, pos_i, pos_j, flags):
    """The serving-side union mask: window | global column, causal.

    Evaluated on ORIGINAL positions, so ring/paged slot layouts are
    transparent. ``pos_i``/``pos_j`` are int32 tensors that broadcast
    against each other; ``flags`` (an int or an int tensor) gates the
    components (0 = padding no-op). Padding slots carry ``PAD_SENTINEL``
    positions and fail every component: the window by distance, the
    global column by ``pos_j < g``, and padded *query* rows by the
    explicit in-range guard.
    """
    p = pattern
    if p.is_2d:
        raise ValueError("causal_step_mask is the 1-D serving mask; 2-D "
                         "patterns decode through the training engines")
    a, b = p.window
    rel = pos_j - pos_i
    w = (rel >= a) & (rel <= min(b, 0))
    if p.dilation > 1:
        w = w & (torch.remainder(rel, p.dilation) == 0)
    m = w & ((flags & STEP_WINDOW) != 0)
    if p.n_global > 0:
        m = m | ((pos_j < p.n_global) & ((flags & STEP_GLOBAL) != 0))
    return m & (pos_j <= pos_i) & (pos_i < BIG) & (pos_j < BIG)


def ring_view_positions(chunk_start: int, n_sink: int, ring_cap: int,
                        n_global: int) -> np.ndarray:
    """Static position of every cached slot just before chunk ``c0`` starts.

    The paged serving layout is deterministic: sink slot ``j`` holds
    position ``j`` (once prefill has passed it), ring slot ``r`` holds the
    LATEST position ``p < c0`` with ``p >= g`` and ``(p - g) % ring_cap ==
    r``. Returns (n_sink + ring_cap,) int32 with ``BIG`` for slots not yet
    written.
    """
    g, c0 = n_global, chunk_start
    pos = np.full(n_sink + ring_cap, BIG, dtype=np.int32)
    ns = min(g, c0, n_sink)
    pos[:ns] = np.arange(ns)
    if ring_cap > 0 and c0 > g:
        r = np.arange(ring_cap)
        base = g + r
        latest = base + ((c0 - 1 - base) // ring_cap) * ring_cap
        pos[n_sink:] = np.where(c0 - 1 >= base, latest.astype(np.int64),
                                BIG).astype(np.int32)
    return pos


@dataclasses.dataclass(frozen=True, eq=False)
class ChunkPlan:
    """Step tables for ONE causal prefill chunk: queries ``[c0, c1)``
    against the paged KV view ``[sink slots | ring slots | the chunk
    itself]``.

    Tile pruning uses the static slot->position map
    (:func:`ring_view_positions`); masks are evaluated at run time on live
    positions via :func:`causal_step_mask`. Row ``i`` lists the view tiles
    chunk-query-block ``i`` visits (ascending, deduplicated), flags gate
    window vs global work, rows right-padded with ``flags == 0`` no-ops.
    """
    pattern: HybridSparsePattern
    chunk_start: int
    chunk_len: int
    chunk_pad: int            # chunk slots (block-aligned)
    n_sink: int               # sink slots in the view (page-aligned)
    ring_cap: int             # ring slots in the view (page-aligned)
    block: int                # tile size (queries AND keys)
    view_len: int             # n_sink + ring_cap + chunk_pad
    nq: int                   # chunk query blocks
    nkb: int                  # view KV tiles
    max_steps: int
    kv_blocks: np.ndarray     # (nq, max_steps) int32
    flags: np.ndarray         # (nq, max_steps) int32
    num_steps: np.ndarray     # (nq,) int32
    view_positions: np.ndarray  # (view_len,) static positions (BIG = empty)

    def _key(self):
        return (self.pattern, self.chunk_start, self.chunk_len, self.n_sink,
                self.ring_cap, self.block, self.chunk_pad)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, ChunkPlan) and self._key() == other._key()

    def padded_tables(self, nq: int, width: int):
        """Tables padded to a fixed (nq, width), so every chunk of a request
        has the same operand shapes (padding steps: tile 0, flags 0)."""
        if nq < self.nq or width < self.max_steps:
            raise ValueError(f"padded_tables({nq}, {width}) is smaller than "
                             f"the plan ({self.nq}, {self.max_steps})")
        kv = np.zeros((nq, width), dtype=np.int32)
        fl = np.zeros((nq, width), dtype=np.int32)
        kv[: self.nq, : self.max_steps] = self.kv_blocks
        fl[: self.nq, : self.max_steps] = self.flags
        validate_tables(kv, fl, nkb=self.nkb, name="ChunkPlan tables")
        return kv, fl

    def stats(self) -> dict:
        """Tile accounting: what the fused chunk pass executes vs the
        token-by-token decode replay it replaces."""
        executed = int(self.num_steps.sum())
        dense = self.nq * self.nkb
        return dict(chunk_start=self.chunk_start, chunk_len=self.chunk_len,
                    executed_tiles=executed, dense_tiles=dense,
                    launches=1, token_by_token_launches=self.chunk_len)


@functools.lru_cache(maxsize=4096)
def build_chunk_plan(pattern: HybridSparsePattern, chunk_start: int,
                     chunk_len: int, *, n_sink: int, ring_cap: int,
                     block: int, chunk_pad: Optional[int] = None) -> ChunkPlan:
    """Lower one causal prefill chunk into view-tile step tables.

    ``n_sink``/``ring_cap`` describe the request's paged cache view (both
    multiples of ``block``); the chunk rides behind them. Queries at
    positions ``[c0, c0 + chunk_len)`` attend cached KV + the chunk itself
    under the causal union mask.
    """
    if pattern.is_2d or not pattern.causal:
        raise ValueError("chunked prefill requires a causal 1-D pattern, "
                         f"got {pattern}")
    if n_sink % block or ring_cap % block:
        raise ValueError(f"view regions ({n_sink}, {ring_cap}) must be "
                         f"multiples of block {block}")
    a, b = pattern.window
    hi = min(b, 0)
    g = pattern.n_global
    c0, c1 = chunk_start, chunk_start + chunk_len
    cp = _round_up(max(chunk_len, 1), block)
    if chunk_pad is not None:
        if chunk_pad < cp or chunk_pad % block:
            raise ValueError(f"chunk_pad {chunk_pad} must be a multiple of "
                             f"{block} and >= {cp}")
        cp = chunk_pad
    ctx = n_sink + ring_cap
    view_len = ctx + cp
    nq, nkb = cp // block, view_len // block
    vpos = np.full(view_len, BIG, dtype=np.int32)
    vpos[:ctx] = ring_view_positions(c0, n_sink, ring_cap, g)
    vpos[ctx: ctx + chunk_len] = np.arange(c0, c1, dtype=np.int32)

    rows = []
    for i in range(nq):
        qlo = c0 + i * block
        qhi = min(c1, qlo + block) - 1
        if qlo >= c1:
            rows.append([])
            continue
        row = []
        for t in range(nkb):
            tp = vpos[t * block: (t + 1) * block]
            tp = tp[tp < BIG]
            if tp.size == 0:
                continue
            fl = 0
            if ((tp >= qlo + a) & (tp <= qhi + hi)).any():
                fl |= STEP_WINDOW
            if g > 0 and (tp < min(g, qhi + 1)).any():
                fl |= STEP_GLOBAL
            if fl:
                row.append((t, fl))
        rows.append(row)

    max_steps = max(1, max(len(r) for r in rows))
    kv_blocks = np.zeros((nq, max_steps), dtype=np.int32)
    flags = np.zeros((nq, max_steps), dtype=np.int32)
    num_steps = np.asarray([len(r) for r in rows], dtype=np.int32)
    for i, row in enumerate(rows):
        for s, (t, fl) in enumerate(row):
            kv_blocks[i, s] = t
            flags[i, s] = fl
    return ChunkPlan(pattern=pattern, chunk_start=c0, chunk_len=chunk_len,
                     chunk_pad=cp, n_sink=n_sink, ring_cap=ring_cap,
                     block=block, view_len=view_len, nq=nq, nkb=nkb,
                     max_steps=max_steps, kv_blocks=kv_blocks, flags=flags,
                     num_steps=num_steps, view_positions=vpos)
