"""Paged ring-cache slab: ONE pooled KV allocation shared by all requests.

The port of :mod:`repro.serve.paged_cache`:

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

**Quantized slab** (``kv_dtype="int8"``): K/V are stored int8 with one f32
scale per (layer, page) (:class:`PagedSlab` ``k_scale``/``v_scale``).
:func:`quant_slab_write` grows a page's scale monotonically as hotter rows
land in it (rescaling the resident int8 payload by the old/new ratio) and
pins the null page's scale to 0, so routed-away writes quantize to zeros.
Reads dequantize per page: :func:`gather_view` for the plain path, the
paged-decode kernel in its loads. Recycled pages get their scales reset to
0 (:func:`reset_page_scales`).

**Sequence-parallel layout** (``shards > 1``): a request's logical pages
are striped contiguously over the shards, logical page ``j`` (and every
slot in it) owned by shard ``j // pages_per_shard``
(:meth:`PagedLayout.slot_owner`, :meth:`PagedLayout.slot_local`). Each
rank of a :class:`~repro_torch.dist.group.SeqGroup` allocates only its own
shard's pool of ``n_pages`` pages (:func:`slab_init` as on one device);
its page tables and slot positions are its stripe of the request's.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.scheduler import PAD_SENTINEL
from repro_torch.ft.faults import ResourceExhausted


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Static per-request geometry of the paged ring cache.

    ``shards > 1`` is the sequence-parallel layout: logical page ``j`` is
    owned by shard ``j // pages_per_shard``, so the sink pages land on the
    shards covering their positions and the ring pages are striped over
    the rest. ``ring_pages`` absorbs the alignment padding (a ring longer
    than the dilated lookback changes nothing: positions older than the
    lookback are masked by the window whether or not a slot still holds
    them).
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

    def slot_owner(self, s):
        """Shard owning logical slot ``s`` (an int or an integer tensor)."""
        return s // self.slots_per_shard

    def slot_local(self, s):
        """Shard-local index of logical slot ``s``."""
        return s % self.slots_per_shard

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
    """Pooled KV for one model segment: (n_layers, n_pages, page, Hkv,
    hd). Layer ``i`` uses slab row ``i``; all layers share the same page
    tables.

    ``k_scale``/``v_scale`` are ``None`` for fp slabs; for int8 slabs they
    are f32 ``(n_layers, n_pages)`` per-(layer, page) dequant scales.
    Scale 0 marks an empty page — the null page 0, always."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def tensors(self) -> List[torch.Tensor]:
        """The slab's tensors: K, V and, for int8 slabs, the scales."""
        return [a for a in self if a is not None]


def slab_init(n_layers: int, n_pages: int, page: int, n_kv_heads: int,
              head_dim: int, dtype, device,
              quantized: bool = False) -> PagedSlab:
    """``quantized=True`` allocates int8 K/V (``dtype`` then only names the
    compute dtype readers dequantize to) plus zeroed per-(layer, page)
    scales."""
    shape = (n_layers, n_pages, page, n_kv_heads, head_dim)
    if not quantized:
        return PagedSlab(k=torch.zeros(shape, dtype=dtype, device=device),
                         v=torch.zeros(shape, dtype=dtype, device=device))
    sshape = (n_layers, n_pages)
    return PagedSlab(
        k=torch.zeros(shape, dtype=torch.int8, device=device),
        v=torch.zeros(shape, dtype=torch.int8, device=device),
        k_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
        v_scale=torch.zeros(sshape, dtype=torch.float32, device=device))


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


def _quant_write_one(slab: torch.Tensor, scale: torch.Tensor,
                     phys: torch.Tensor, off: torch.Tensor,
                     x: torch.Tensor) -> None:
    """int8 scatter of ``x`` into one layer's slab with per-page scales, IN
    PLACE.

    slab: (n_pages, page, Hkv, hd) int8; scale: (n_pages,) f32; phys/off:
    (n,) int32 write targets; x: (n, Hkv, hd) new rows. Page scales grow
    MONOTONICALLY (scatter-max of the incoming rows' amax/127); growth
    rescales the page's resident payload by old/new, and the null page's
    scale stays 0 so routed-away writes quantize to zeros.

    Only the written pages can change scale, so only they are rescaled
    (the reference rescales the whole slab, where every other page's ratio
    is exactly 1.0: the same bits). That includes a page whose scale goes
    from 0 to positive: its ratio is 0, which zeroes a recycled page's
    stale payload. A page written by several rows is gathered and written
    back several times with the same values, so the result is defined."""
    x = x.float()
    pg = phys.long()
    row_scale = x.abs().amax(dim=(-2, -1)) / 127.0                 # (n,)
    new_scale = scale.scatter_reduce(0, pg, row_scale, reduce="amax")
    new_scale[0] = 0.0
    ratio = torch.where(new_scale > 0.0,
                        scale / torch.clamp(new_scale, min=1e-30), 1.0)
    slab[pg] = torch.clamp(torch.round(slab[pg].float()
                                       * ratio[pg][:, None, None, None]),
                           -128, 127).to(torch.int8)
    s = new_scale[pg][:, None, None]                              # (n,1,1)
    q = torch.where(s > 0.0,
                    torch.clamp(torch.round(x / torch.clamp(s, min=1e-30)),
                                -128, 127), 0.0).to(torch.int8)
    slab.index_put_((pg, off.long()), q)
    scale.copy_(new_scale)


def quant_slab_write(k_slab: torch.Tensor, v_slab: torch.Tensor,
                     k_scale: torch.Tensor, v_scale: torch.Tensor,
                     phys: torch.Tensor, off: torch.Tensor,
                     k_t: torch.Tensor, v_t: torch.Tensor):
    """Quantizing twin of :func:`slab_write` for int8 slabs, IN PLACE.

    Same write targets as :func:`slab_write`, plus the layer's (n_pages,)
    scale vectors, which are updated in place too. Returns
    ``(k_slab, v_slab, k_scale, v_scale)`` — the same tensors, as the
    reference's functional contract returns the new ones."""
    _quant_write_one(k_slab, k_scale, phys, off, k_t)
    _quant_write_one(v_slab, v_scale, phys, off, v_t)
    return k_slab, v_slab, k_scale, v_scale


def reset_page_scales(scale: torch.Tensor, pages) -> torch.Tensor:
    """Zero the scales of freshly (re)allocated pages, all layers at once,
    IN PLACE. scale: (..., n_layers, n_pages); pages: (n,) physical page
    ids. Called when a request's pages return to the pool, so a recycled
    page's stale amax cannot inflate the next request's grid."""
    idx = torch.as_tensor(np.asarray(pages), dtype=torch.long,
                          device=scale.device)
    scale[..., idx] = 0.0
    return scale


def gather_view(k_slab: torch.Tensor, v_slab: torch.Tensor,
                page_tables: torch.Tensor,
                k_scale: Optional[torch.Tensor] = None,
                v_scale: Optional[torch.Tensor] = None, dtype=None):
    """Materialize per-request logical KV views (the plain decode path;
    the CUDA kernel chases the page table instead and never does this).

    k_slab/v_slab: (n_pages, page, Hkv, hd); page_tables: (B, npp). For
    int8 slabs pass the layer's ``k_scale``/``v_scale`` (n_pages,) and the
    compute ``dtype``: each gathered page is dequantized by its own scale
    and rounded to ``dtype``. Returns (B, npp * page, Hkv, hd) x 2."""
    B, npp = page_tables.shape
    _, page, Hkv, hd = k_slab.shape
    idx = page_tables.reshape(-1).long()
    kv = k_slab.index_select(0, idx)
    vv = v_slab.index_select(0, idx)
    if k_scale is not None:
        sk = k_scale.index_select(0, idx)[:, None, None, None]
        sv = v_scale.index_select(0, idx)[:, None, None, None]
        kv = (kv.float() * sk).to(dtype)
        vv = (vv.float() * sv).to(dtype)
    return (kv.reshape(B, npp * page, Hkv, hd),
            vv.reshape(B, npp * page, Hkv, hd))


def empty_positions(n_requests: int, layout: PagedLayout,
                    device) -> torch.Tensor:
    """Per-request slot->position table of one shard's slots (every slot
    when ``layout.shards == 1``), all-empty (PAD_SENTINEL)."""
    return torch.full((n_requests, layout.slots_per_shard), PAD_SENTINEL,
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
               n_kv_heads: int, head_dim: int, dtype_bytes: int = 2,
               with_scales: bool = False) -> int:
    """Total pooled slab footprint (all segments' layers, K+V).
    ``with_scales`` adds the int8 slab's per-(layer, page) f32 scales (K
    and V)."""
    base = 2 * n_layers_total * n_pages * page * n_kv_heads * head_dim \
        * dtype_bytes
    if with_scales:
        base += 2 * n_layers_total * n_pages * 4
    return base
