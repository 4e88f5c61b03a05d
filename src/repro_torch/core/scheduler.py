"""Data scheduler: pattern -> band schedule -> ExecutionPlan, and the
serving chunk IR.

The port's counterpart of :mod:`repro.core.scheduler`. The table builders
are the reference's numpy code, unchanged; only the masks are torch:

* :class:`Band`, :class:`BandSchedule` (``window_mask``,
  ``global_col_mask`` and ``step_mask`` on ORIGINAL positions, in torch),
  :func:`schedule` — data reordering (dilation), 2-D band lowering;
* :class:`ExecutionPlan`, :func:`build_plan` — the deduplicated
  per-query-block step tables one forward launch walks;
* :class:`TransposedPlan`, :func:`build_transposed`,
  :class:`PackedTransposedPlan`, :func:`pack_rows`,
  :func:`build_packed_transposed` — the backward's dK/dV walk;
* :func:`causal_step_mask` — the shared serving mask (decode plain
  version, decode kernel, chunked prefill);
* :func:`ring_view_positions`, :class:`ChunkPlan` and
  :func:`build_chunk_plan` — the causal chunk-slice of the plan that
  chunked prefill walks.

All tables are static numpy metadata built on the host and cached. The
step-table contract itself lives in :mod:`repro_torch.core.plan_contract`.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.patterns import HybridSparsePattern
from repro_torch.core.plan_contract import (BIG, STEP_GLOBAL, STEP_WINDOW,
                                            validate_tables)
from repro_torch.core.plan_contract import PAD_SENTINEL as PAD_SENTINEL


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class Band:
    """One working-space band: queries attend keys with lo <= j - i <= hi."""
    lo: int
    hi: int

    def kv_steps(self, block_q: int, block_k: int) -> int:
        """KV tiles a query block touches for this band (window splitting)."""
        span = (block_q - 1) + (self.hi - self.lo)
        return span // block_k + 2  # +2: start misalignment + inclusive end

    def kv_start_block(self, q_block: int, block_q: int, block_k: int) -> int:
        """First (possibly negative, unclamped) KV tile for query block."""
        return math.floor((q_block * block_q + self.lo) / block_k)


@dataclasses.dataclass(frozen=True, eq=False)
class BandSchedule:
    n: int                      # original sequence length
    n_work: int                 # length after dilation padding (= len(perm))
    bands: Tuple[Band, ...]     # working-space bands (dilation removed)
    perm: Optional[np.ndarray]  # working slot -> original position, or None
    n_global: int
    global_rows: bool
    causal: bool
    pattern: HybridSparsePattern

    # hash/eq over every field except the numpy perm array (derived from
    # (pattern, n) anyway), so plans cache per schedule.
    def _key(self):
        return (self.n, self.n_work, self.pattern, self.bands,
                self.n_global, self.global_rows, self.causal)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return (isinstance(other, BandSchedule)
                and self._key() == other._key())

    @property
    def reordered(self) -> bool:
        return self.perm is not None

    def positions(self) -> np.ndarray:
        """Original position of each working slot (BIG for padding)."""
        if self.perm is None:
            pos = np.arange(self.n_work, dtype=np.int32)
            pos[self.n:] = BIG
            return pos
        pos = self.perm.astype(np.int32).copy()
        pos[pos >= self.n] = BIG
        return pos

    def inverse_perm(self) -> Optional[np.ndarray]:
        """original position -> working slot (length n)."""
        if self.perm is None:
            return None
        inv = np.full(self.n, -1, dtype=np.int32)
        valid = self.perm < self.n
        inv[self.perm[valid]] = np.nonzero(valid)[0]
        if (inv < 0).any():
            raise AssertionError("the dilation permutation misses a position")
        return inv

    def window_mask(self, pos_i: torch.Tensor, pos_j: torch.Tensor):
        """Window-only validity from ORIGINAL positions (int32 tensors that
        broadcast against each other): the windowed/dilated/2-D part of the
        pattern plus causality, NOT the global row/column. Padding
        (pos == BIG) fails by the in-range guard."""
        p = self.pattern
        in_range = (pos_i < self.n) & (pos_j < self.n)
        if p.is_2d:
            g = p.n_global
            _, w = p.grid2d
            wh, ww = p.window2d
            di, dj = pos_i - g, pos_j - g
            yi = torch.div(di, w, rounding_mode="floor")
            yj = torch.div(dj, w, rounding_mode="floor")
            xi, xj = torch.remainder(di, w), torch.remainder(dj, w)
            m = ((yj - yi).abs() <= wh // 2) & ((xj - xi).abs() <= ww // 2)
            m = m & (pos_i >= g) & (pos_j >= g)
        else:
            a, b = p.window
            rel = pos_j - pos_i
            m = (rel >= a) & (rel <= b)
            if p.dilation > 1:
                m = m & (torch.remainder(rel, p.dilation) == 0)
        if self.causal:
            m = m & (pos_j <= pos_i)
        return m & in_range

    def global_col_mask(self, pos_i: torch.Tensor, pos_j: torch.Tensor):
        """Validity of the global-column partial: key is global, and the pair
        is NOT already covered by the window (no double counting)."""
        m = (pos_j < self.n_global) & (pos_i < self.n)
        if self.causal:
            m = m & (pos_j <= pos_i)
        return m & ~self.window_mask(pos_i, pos_j)

    def step_mask(self, pos_i: torch.Tensor, pos_j: torch.Tensor, flags):
        """The ExecutionPlan's per-step mask — THE mask every engine applies.

        ``flags`` (an int or an int tensor broadcastable against the tile)
        selects the components this step evaluates: STEP_WINDOW gates the
        window term, STEP_GLOBAL the global-column term (disjoint from the
        window). ``flags == 0`` steps are padding no-ops.
        """
        w = self.window_mask(pos_i, pos_j)
        m = w & ((flags & STEP_WINDOW) != 0)
        if self.n_global > 0:
            gcol = (pos_j < self.n_global) & (pos_i < self.n) & ~w
            if self.causal:
                gcol = gcol & (pos_j <= pos_i)
            m = m | (gcol & ((flags & STEP_GLOBAL) != 0))
        return m

    def plan(self, block_q: int, block_k: int,
             pad_multiple: int = 1) -> "ExecutionPlan":
        """Lower this schedule into the deduplicated step-table IR."""
        return build_plan(self, block_q, block_k, pad_multiple)


@functools.lru_cache(maxsize=256)
def schedule(pattern: HybridSparsePattern, n: int) -> BandSchedule:
    """Lower a pattern at sequence length ``n`` into a band schedule."""
    if pattern.is_2d:
        exp = pattern.seq_len()
        if n != exp:
            raise ValueError(f"2-D pattern implies n={exp}, got {n}")
        _, w = pattern.grid2d
        wh, ww = pattern.window2d
        bands = tuple(
            Band(dy * w - ww // 2, dy * w + ww // 2)
            for dy in range(-(wh // 2), wh // 2 + 1)
        )
        return BandSchedule(n=n, n_work=n, bands=bands, perm=None,
                            n_global=pattern.n_global,
                            global_rows=pattern.global_rows,
                            causal=pattern.causal, pattern=pattern)

    a, b = pattern.window
    d = pattern.dilation
    if d == 1:
        lo = max(a, -(n - 1))
        hi = min(b, n - 1)
        if pattern.causal:
            hi = min(hi, 0)
        return BandSchedule(n=n, n_work=n, bands=(Band(lo, hi),), perm=None,
                            n_global=pattern.n_global,
                            global_rows=pattern.global_rows,
                            causal=pattern.causal, pattern=pattern)

    # data reordering (paper §4.2): stride-d permutation
    if a % d or b % d:
        raise ValueError(f"dilated window offsets ({a},{b}) must be multiples"
                         f" of dilation {d}")
    n_work = _round_up(n, d)
    perm = np.concatenate([np.arange(r, n_work, d) for r in range(d)])
    lo = max(a // d, -(n_work // d - 1))
    hi = min(b // d, n_work // d - 1)
    if pattern.causal:
        hi = min(hi, 0)
    return BandSchedule(n=n, n_work=n_work, bands=(Band(lo, hi),), perm=perm,
                        n_global=pattern.n_global,
                        global_rows=pattern.global_rows,
                        causal=pattern.causal, pattern=pattern)


@dataclasses.dataclass(frozen=True, eq=False)
class ExecutionPlan:
    """Flat per-query-block step tables: what one fused pass executes.

    Row ``i`` lists the KV tiles query block ``i`` visits, in ascending
    tile order, each tile exactly once: ``kv_blocks[i, s]`` (0 for padding
    steps), ``flags[i, s]`` (STEP_WINDOW / STEP_GLOBAL, 0 = padding no-op),
    ``band_set_ids[i, s]`` (index into ``band_sets``, -1 for padding).
    Rows are right-padded to ``max_steps``. All arrays are static numpy;
    the plan hashes on (schedule, block_q, block_k, n_pad).
    """
    sched: BandSchedule
    block_q: int
    block_k: int
    n_pad: int                # padded working length (tile-grid aligned)
    nq: int                   # query blocks
    nkb: int                  # KV tiles
    max_steps: int            # table width
    kv_blocks: np.ndarray     # (nq, max_steps) int32
    flags: np.ndarray         # (nq, max_steps) int32
    band_set_ids: np.ndarray  # (nq, max_steps) int32
    band_sets: Tuple[Tuple[int, ...], ...]
    num_steps: np.ndarray     # (nq,) int32 — real (non-padding) steps

    def __hash__(self):
        return hash((self.sched, self.block_q, self.block_k, self.n_pad))

    def __eq__(self, other):
        return (isinstance(other, ExecutionPlan)
                and self.sched == other.sched
                and self.block_q == other.block_q
                and self.block_k == other.block_k
                and self.n_pad == other.n_pad)

    def positions_padded(self) -> np.ndarray:
        """Original position per padded working slot (PAD_SENTINEL beyond)."""
        pos = np.full(self.n_pad, BIG, dtype=np.int32)
        pos[: self.sched.n_work] = self.sched.positions()
        return pos

    def step_mask(self, pos_i, pos_j, flags):
        return self.sched.step_mask(pos_i, pos_j, flags)

    def transposed(self) -> "TransposedPlan":
        """The adjoint walk: per-KV-block step tables (cached)."""
        return build_transposed(self)

    def transposed_packed(self) -> "PackedTransposedPlan":
        """The transposed walk re-packed to a fixed row width (cached) —
        what the dK/dV engines execute."""
        return build_packed_transposed(self)

    def stats(self) -> dict:
        """Plan-level work accounting (the reference's keys)."""
        executed_tiles = int(self.num_steps.sum())
        executed_pairs = executed_tiles * self.block_q * self.block_k
        useful = int(self.sched.pattern.mask(self.sched.n).sum())
        g = self.sched.n_global
        per_band_steps = sum(b.kv_steps(self.block_q, self.block_k)
                             for b in self.sched.bands)
        if g > 0:
            per_band_steps += -(-g // self.block_k)
        tp = self.transposed()
        pk = self.transposed_packed()
        return dict(
            q_blocks=self.nq,
            kv_steps_per_q_block=self.max_steps,
            executed_pairs=executed_pairs,
            useful_pairs=useful,
            utilization=useful / max(executed_pairs, 1),
            tile_flops=4 * self.block_q * self.block_k,
            executed_tiles=executed_tiles,
            per_band_tiles=self.nq * per_band_steps,
            per_band_launches=len(self.sched.bands),
            launches=1,
            band_sets=len(self.band_sets),
            bwd_dq_tiles=executed_tiles,
            bwd_dkv_tiles=int(tp.num_steps.sum()),
            bwd_kv_steps_per_kv_block=tp.max_steps,
            bwd_launches=2,
            bwd_dkv_grid_unpacked=self.nkb * tp.max_steps,
            bwd_dkv_grid_packed=pk.n_rows * pk.width,
            bwd_dkv_pack_ratio=(self.nkb * tp.max_steps)
            / max(pk.n_rows * pk.width, 1),
        )


def build_plan(sched: BandSchedule, block_q: int, block_k: int,
               pad_multiple: int = 1) -> ExecutionPlan:
    """Lower a band schedule into the deduplicated ExecutionPlan.

    Every attended pair of the windowed part has a working-space offset
    inside some band, so its KV tile lies inside that band's walk for its
    query block; every global pair's tile holds a global key and is added
    explicitly. Each tile is visited at most once, so the union mask counts
    each pair exactly once. ``pad_multiple`` extends the tile-grid padding.
    """
    return _build_plan(sched, block_q, block_k, int(pad_multiple))


@functools.lru_cache(maxsize=256)
def _build_plan(sched: BandSchedule, block_q: int, block_k: int,
                pad_multiple: int) -> ExecutionPlan:
    n_pad = _round_up(sched.n_work,
                      math.lcm(max(block_q, block_k), pad_multiple))
    nq = n_pad // block_q
    nkb = n_pad // block_k
    pos = np.full(n_pad, BIG, dtype=np.int32)
    pos[: sched.n_work] = sched.positions()

    g = sched.n_global
    if g > 0:
        gtiles = set(np.nonzero(
            (pos.reshape(nkb, block_k) < g).any(axis=1))[0].tolist())
    else:
        gtiles = set()

    band_set_index: dict = {}
    band_sets: list = []
    rows = []
    for i in range(nq):
        cover: dict = {}
        for bi, band in enumerate(sched.bands):
            s0 = band.kv_start_block(i, block_q, block_k)
            for t in range(s0, s0 + band.kv_steps(block_q, block_k)):
                if 0 <= t < nkb:
                    cover.setdefault(t, []).append(bi)
        row = []
        for t in sorted(set(cover) | gtiles):
            bset = tuple(cover.get(t, ()))
            fl = (STEP_WINDOW if bset else 0) | (STEP_GLOBAL
                                                 if t in gtiles else 0)
            if bset not in band_set_index:
                band_set_index[bset] = len(band_sets)
                band_sets.append(bset)
            row.append((t, fl, band_set_index[bset]))
        rows.append(row)

    max_steps = max(1, max(len(r) for r in rows))
    kv_blocks = np.zeros((nq, max_steps), dtype=np.int32)
    flags = np.zeros((nq, max_steps), dtype=np.int32)
    band_set_ids = np.full((nq, max_steps), -1, dtype=np.int32)
    num_steps = np.asarray([len(r) for r in rows], dtype=np.int32)
    for i, row in enumerate(rows):
        for s, (t, fl, sid) in enumerate(row):
            kv_blocks[i, s] = t
            flags[i, s] = fl
            band_set_ids[i, s] = sid

    validate_tables(kv_blocks, flags, nkb=nkb, num_steps=num_steps,
                    name="ExecutionPlan tables")
    return ExecutionPlan(
        sched=sched, block_q=block_q, block_k=block_k, n_pad=n_pad, nq=nq,
        nkb=nkb, max_steps=max_steps, kv_blocks=kv_blocks, flags=flags,
        band_set_ids=band_set_ids, band_sets=tuple(band_sets),
        num_steps=num_steps)


@dataclasses.dataclass(frozen=True, eq=False)
class TransposedPlan:
    """Per-KV-block step tables: the exact adjoint of an ExecutionPlan.

    Row ``j`` lists the query blocks whose forward walk visits KV tile
    ``j``, ascending, each once: ``q_blocks[j, s]`` (0 for padding),
    ``flags[j, s]`` (the forward visit's flags, 0 = padding),
    ``num_steps[j]``. Total real steps equal the forward plan's.
    """
    plan: ExecutionPlan
    max_steps: int
    q_blocks: np.ndarray   # (nkb, max_steps) int32
    flags: np.ndarray      # (nkb, max_steps) int32
    num_steps: np.ndarray  # (nkb,) int32

    def __hash__(self):
        return hash(("transposed", self.plan))

    def __eq__(self, other):
        return isinstance(other, TransposedPlan) and self.plan == other.plan


@functools.lru_cache(maxsize=256)
def build_transposed(plan: ExecutionPlan) -> TransposedPlan:
    """Transpose the forward step tables into per-KV-block tables (pure
    table surgery: same visits, same flags, regrouped by KV tile)."""
    rows: list = [[] for _ in range(plan.nkb)]
    for i in range(plan.nq):
        for s in range(int(plan.num_steps[i])):
            fl = int(plan.flags[i, s])
            if fl:
                rows[int(plan.kv_blocks[i, s])].append((i, fl))
    max_steps = max(1, max(len(r) for r in rows))
    q_blocks = np.zeros((plan.nkb, max_steps), dtype=np.int32)
    flags = np.zeros((plan.nkb, max_steps), dtype=np.int32)
    num_steps = np.asarray([len(r) for r in rows], dtype=np.int32)
    for j, row in enumerate(rows):
        for s, (i, fl) in enumerate(row):
            q_blocks[j, s] = i
            flags[j, s] = fl
    return TransposedPlan(plan=plan, max_steps=max_steps, q_blocks=q_blocks,
                          flags=flags, num_steps=num_steps)


@dataclasses.dataclass(frozen=True, eq=False)
class PackedTransposedPlan:
    """The transposed walk packed to fixed-width rows.

    ``row_tile[r]`` names the KV tile packed row ``r`` accumulates into;
    rows longer than ``width`` are split into several packed rows sharing
    one ``row_tile`` (emitted next to each other, in order), and tiles no
    query block visits get no row. Per-row partials are summed per owner
    tile by the engines.
    """
    plan: Optional[ExecutionPlan]
    width: int
    n_rows: int
    row_tile: np.ndarray   # (n_rows,) int32 — owner KV tile per packed row
    q_blocks: np.ndarray   # (n_rows, width) int32 (0 = padding step)
    flags: np.ndarray      # (n_rows, width) int32 (0 = padding no-op)
    num_steps: np.ndarray  # (n_rows,) int32

    def __hash__(self):
        return hash(("packed", self.plan))

    def __eq__(self, other):
        return (isinstance(other, PackedTransposedPlan)
                and self.plan is not None and self.plan == other.plan)


def pack_rows(rows, width: Optional[int] = None):
    """Pack ragged per-tile visit lists into fixed-width owner-tagged rows.

    ``rows[j]`` is the list of ``(q_block, flags)`` visits of KV tile ``j``.
    Returns ``(row_tile, q_blocks, flags, num_steps, width)`` numpy arrays.
    ``width`` defaults to the 95th-percentile nonzero row length.
    """
    lens = np.asarray([len(r) for r in rows], dtype=np.int64)
    nz = lens[lens > 0]
    if width is None:
        width = int(np.ceil(np.percentile(nz, 95))) if nz.size else 1
    width = max(1, int(width))
    packed = []  # (tile, [(q, fl), ...]) chunks
    for j, row in enumerate(rows):
        for c0 in range(0, len(row), width):
            packed.append((j, row[c0: c0 + width]))
    if not packed:
        packed = [(0, [])]
    n_rows = len(packed)
    row_tile = np.asarray([t for t, _ in packed], dtype=np.int32)
    q_blocks = np.zeros((n_rows, width), dtype=np.int32)
    flags = np.zeros((n_rows, width), dtype=np.int32)
    num_steps = np.asarray([len(c) for _, c in packed], dtype=np.int32)
    for r, (_, chunk) in enumerate(packed):
        for s, (i, fl) in enumerate(chunk):
            q_blocks[r, s] = i
            flags[r, s] = fl
    return row_tile, q_blocks, flags, num_steps, width


@functools.lru_cache(maxsize=256)
def build_packed_transposed(plan: ExecutionPlan) -> PackedTransposedPlan:
    """Pack :func:`build_transposed`'s tables (pure table surgery again)."""
    tp = build_transposed(plan)
    rows = [[(int(tp.q_blocks[j, s]), int(tp.flags[j, s]))
             for s in range(int(tp.num_steps[j]))] for j in range(plan.nkb)]
    row_tile, q_blocks, flags, num_steps, width = pack_rows(rows)
    return PackedTransposedPlan(plan=plan, width=width,
                                n_rows=row_tile.shape[0], row_tile=row_tile,
                                q_blocks=q_blocks, flags=flags,
                                num_steps=num_steps)


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

    def sharded_tables(self, n_shards: int, nq: int, width: int,
                       chunk_owner: Optional[int] = None):
        """Per-shard step tables over the ``[sink | ring | chunk]`` view,
        for sequence-parallel serving.

        Context tiles are striped contiguously over the shards (tile ``t``
        owned by ``t // tiles_per_shard``, as the paged layout stripes its
        pages), so each shard executes only the steps whose KV it holds,
        remapped onto its local view ``[owned ctx tiles | chunk]``. The
        chunk's own tiles go to exactly ONE shard (``chunk_owner``, default
        the last; the chunk KV is on every shard, so any owner is exact):
        every (query, kv slot) pair is evaluated on exactly one shard, and
        the per-shard ``(out, m, l)`` partials combine exactly under
        :func:`repro_torch.dist.sharded_plan.masked_psum_merge`. A shard
        with no step for a row keeps ``flags == 0`` padding, which gives
        the empty identity ``(0, NEG_INF, 0)``.

        Returns ``(kv, fl)`` stacked ``(n_shards, nq, width)`` int32."""
        ctx_tiles = (self.n_sink + self.ring_cap) // self.block
        if ctx_tiles % n_shards:
            raise ValueError(f"ctx tiles {ctx_tiles} not divisible by "
                             f"{n_shards} shards (use a shard-aligned "
                             f"PagedLayout)")
        tps = ctx_tiles // n_shards
        if chunk_owner is None:
            chunk_owner = n_shards - 1
        local_tiles = tps + self.chunk_pad // self.block
        if nq < self.nq or width < local_tiles:
            raise ValueError(f"sharded_tables({n_shards}, {nq}, {width}) "
                             f"is smaller than the plan's {self.nq} rows "
                             f"of {local_tiles} local tiles")
        kv = np.zeros((n_shards, nq, width), dtype=np.int32)
        fl = np.zeros((n_shards, nq, width), dtype=np.int32)
        fill = np.zeros((n_shards, nq), dtype=np.int64)
        for i in range(self.nq):
            for st in range(int(self.num_steps[i])):
                t = int(self.kv_blocks[i, st])
                if t < ctx_tiles:
                    s, local = t // tps, t % tps
                else:
                    s, local = chunk_owner, tps + (t - ctx_tiles)
                w = fill[s, i]
                kv[s, i, w] = local
                fl[s, i, w] = self.flags[i, st]
                fill[s, i] = w + 1
        for s in range(n_shards):
            validate_tables(kv[s], fl[s], nkb=local_tiles,
                            name=f"ChunkPlan shard {s} tables")
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
