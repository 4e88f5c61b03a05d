"""Paged ring-cache slab: ONE pooled KV allocation shared by all requests.

The port of :mod:`repro.serve.paged_cache`, fp slabs:

* **One slab per model segment** — ``(n_layers, n_pages, page, Hkv, hd)``
  for K and V. Admission hands out pages, completion recycles them.
* **Per-request page table** — ``sink_pages`` pages pinned to the global /
  sink prefix plus ``ring_pages`` pages forming a ring over the (dilated)
  window lookback.
* **Per-request positions** — ``(R, slots_per_req)`` absolute position per
  logical slot (``PAD_SENTINEL`` = empty).

Page 0 is reserved as the **null page**: inactive batch rows and dropped
writes are routed there, so every scatter keeps a fixed shape. Page 0 is
never read through a live position.

Slot map (logical, per request): position ``p < g`` lives at slot ``p``;
position ``p >= g`` lives at slot ``n_sink + (p - g) % ring_cap``. Masks
downstream are position-based, so the scrambled ring order is transparent.

The int8 slab (``quant_slab_write``, ``reset_page_scales``) and the
sequence-parallel layout (``shards > 1``) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import numpy as np
import torch

from repro_torch.core.scheduler import PAD_SENTINEL
from repro_torch.ft.faults import ResourceExhausted


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Static per-request geometry of the paged ring cache.

    ``shards`` is kept for the reference's field set; only ``shards == 1``
    is served by the port so far.
    """
    page: int
    window: int
    n_global: int
    dilation: int = 1
    shards: int = 1

    def __post_init__(self):
        if self.page < 1 or self.window < 1 or self.dilation < 1 \
                or self.shards < 1:
            raise ValueError(f"bad paged layout {self}")
        if self.window > 1 << 28:
            raise ValueError("paged serving needs a bounded window "
                             "(salo pattern disabled / dense?)")

    @property
    def span(self) -> int:
        """Positions the ring must retain: the full dilated lookback."""
        return (self.window - 1) * self.dilation + 1

    @property
    def sink_pages(self) -> int:
        return _ceil_div(self.n_global, self.page) if self.n_global else 0

    @property
    def ring_pages(self) -> int:
        base = _ceil_div(self.span, self.page)
        pad = -(self.sink_pages + base) % self.shards
        return base + pad

    @property
    def n_sink(self) -> int:
        return self.sink_pages * self.page

    @property
    def ring_cap(self) -> int:
        return self.ring_pages * self.page

    @property
    def pages_per_req(self) -> int:
        return self.sink_pages + self.ring_pages

    @property
    def slots_per_req(self) -> int:
        return self.pages_per_req * self.page

    @property
    def pages_per_shard(self) -> int:
        if self.pages_per_req % self.shards:
            raise ValueError(f"{self.pages_per_req} pages do not stripe "
                             f"over {self.shards} shards")
        return self.pages_per_req // self.shards

    @property
    def slots_per_shard(self) -> int:
        return self.pages_per_shard * self.page

    def pages_needed(self, total_positions: int) -> int:
        """Physical pages a request writing positions ``[0, total)`` ever
        touches (a prefix of the slot space)."""
        t = int(total_positions)
        if t <= 0:
            return 0
        if t <= self.n_global:
            return _ceil_div(t, self.page)
        if t - self.n_global >= self.ring_cap:
            return self.pages_per_req
        return self.sink_pages + _ceil_div(t - self.n_global, self.page)

    def pages_needed_per_shard(self, total_positions: int) -> List[int]:
        """Split :meth:`pages_needed` over the contiguous page striping."""
        need = self.pages_needed(total_positions)
        pps = self.pages_per_shard
        return [min(max(need - s * pps, 0), pps)
                for s in range(self.shards)]

    def slot(self, p: torch.Tensor) -> torch.Tensor:
        """Logical slot of absolute positions ``p`` (int32 tensor)."""
        g = self.n_global
        return torch.where(p < g, p,
                           self.n_sink + torch.remainder(p - g,
                                                         self.ring_cap))

    def write_target(self, page_table: torch.Tensor, p: torch.Tensor,
                     keep=None):
        """(physical page, offset) for writing positions ``p``.

        ``page_table``: (..., pages_per_req) int32; ``p``: (...) int32
        positions. ``keep``: optional bool mask — False routes the write to
        the reserved null page 0. Returns int32 (phys, off).
        """
        s = self.slot(p)
        pg = torch.div(s, self.page, rounding_mode="floor")
        off = torch.remainder(s, self.page)
        phys = torch.gather(page_table, -1, pg[..., None].long())[..., 0]
        if keep is not None:
            phys = torch.where(keep, phys, 0)
            off = torch.where(keep, off, 0)
        return phys.to(torch.int32), off.to(torch.int32)


def layout_for_pattern(pattern, page: int, shards: int = 1) -> PagedLayout:
    """THE layout derivation — engine and pool sizing share it, so
    ``n_pages = 1 + max_batch * layout.pages_per_req`` always matches what
    admission will request."""
    if pattern.is_2d or not pattern.causal:
        raise ValueError(f"paged serving needs a causal 1-D pattern: "
                         f"{pattern}")
    return PagedLayout(page=page, window=pattern.window_size(),
                       n_global=pattern.n_global, dilation=pattern.dilation,
                       shards=shards)


class PagedSlab(NamedTuple):
    """Pooled fp KV for one model segment: (n_layers, n_pages, page, Hkv,
    hd). Layer ``i`` uses slab row ``i``; all layers share the same page
    tables."""
    k: torch.Tensor
    v: torch.Tensor


def slab_init(n_layers: int, n_pages: int, page: int, n_kv_heads: int,
              head_dim: int, dtype, device) -> PagedSlab:
    shape = (n_layers, n_pages, page, n_kv_heads, head_dim)
    return PagedSlab(k=torch.zeros(shape, dtype=dtype, device=device),
                     v=torch.zeros(shape, dtype=dtype, device=device))


def slab_write(k_slab: torch.Tensor, v_slab: torch.Tensor,
               phys: torch.Tensor, off: torch.Tensor, k_t: torch.Tensor,
               v_t: torch.Tensor) -> None:
    """Scatter per-request new KV into ONE layer's slab, IN PLACE.

    k_slab/v_slab: (n_pages, page, Hkv, hd); phys/off: (B,) int32 write
    targets; k_t/v_t: (B, Hkv, hd). The reference's functional
    ``.at[phys, off].set`` becomes an in-place ``index_put_`` here (the
    slab is the engine's own state; nothing else holds the old value).
    Rows routed to the null page may collide, which leaves the value
    written there undefined in both frameworks; page 0 is never read."""
    idx = (phys.long(), off.long())
    k_slab.index_put_(idx, k_t.to(k_slab.dtype))
    v_slab.index_put_(idx, v_t.to(v_slab.dtype))


def gather_view(k_slab: torch.Tensor, v_slab: torch.Tensor,
                page_tables: torch.Tensor):
    """Materialize per-request logical KV views (the plain decode path;
    the CUDA kernel chases the page table instead and never does this).

    k_slab/v_slab: (n_pages, page, Hkv, hd); page_tables: (B, npp).
    Returns (B, npp * page, Hkv, hd) x 2."""
    B, npp = page_tables.shape
    _, page, Hkv, hd = k_slab.shape
    idx = page_tables.reshape(-1)
    kv = k_slab.index_select(0, idx)
    vv = v_slab.index_select(0, idx)
    return (kv.reshape(B, npp * page, Hkv, hd),
            vv.reshape(B, npp * page, Hkv, hd))


def empty_positions(n_requests: int, layout: PagedLayout,
                    device) -> torch.Tensor:
    """Per-request slot->position table, all-empty (PAD_SENTINEL)."""
    return torch.full((n_requests, layout.slots_per_req), PAD_SENTINEL,
                      dtype=torch.int32, device=device)


class PageAllocator:
    """Free-list page allocator over the pooled slab (host-side).

    Page 0 is reserved as the null page and never handed out. Recycled
    pages go straight back to the free list (positions are the validity
    source of truth; stale KV in a reused page is masked out by its PAD
    positions until overwritten)."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved)")
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, 0, -1))

    @property
    def n_free(self) -> int:
        return len(self._free)

    def can_alloc(self, n: int) -> bool:
        return len(self._free) >= n

    def alloc(self, n: int) -> np.ndarray:
        if not self.can_alloc(n):
            raise ResourceExhausted(
                f"page pool exhausted ({n} > {self.n_free})")
        pages = [self._free.pop() for _ in range(n)]
        return np.asarray(pages, dtype=np.int32)

    def release(self, pages) -> None:
        for p in np.asarray(pages).tolist():
            if not 0 < p < self.n_pages:
                raise ValueError(f"page {p} outside [1, {self.n_pages})")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
            self._free.append(p)


def slab_bytes(n_layers_total: int, n_pages: int, page: int,
               n_kv_heads: int, head_dim: int, dtype_bytes: int = 2) -> int:
    """Total pooled fp slab footprint (all segments' layers, K+V)."""
    return 2 * n_layers_total * n_pages * page * n_kv_heads * head_dim \
        * dtype_bytes
