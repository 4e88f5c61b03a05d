"""ShardedPlan: the ExecutionPlan sliced per sequence shard, and the
cross-shard softmax merge of the sequence-parallel serving engine.

The port of :mod:`repro.dist.sharded_plan`. A sequence shard of the
training op only needs its **neighbours'** KV tiles (the band's reach) and
the few **global-key** tiles: a halo exchange, not an all-gather.

* :func:`shard_plan` slices a plan's step tables by owner query block.
  Every KV tile a shard's rows reference is **local** (owned), **halo**
  (owned by the shard at signed distance ``δ``, fetched by one
  :meth:`~repro_torch.dist.group.SeqGroup.ppermute` per distance) or
  **global** (a tile holding global-prefix keys, broadcast by one masked
  sum over the group). The tables are remapped onto each shard's view
  ``[local | halo groups | global slots]``; pure numpy, bit-equal to the
  reference's, cached.
* :func:`_build_views` / :func:`_return_views` — the exchange and its
  exact adjoint: halo-tile gradients ride the REVERSE ``ppermute`` back to
  their owners and global-slot gradients a sum over the group, added into
  the owner's local dK/dV in the reference's order.
* :func:`_make_local_fwd` / :func:`_make_local_bwd` — the shard-local
  passes: K1 on the shard's view tables (``nq_l`` query blocks against
  ``view_tiles`` KV tiles), then K2 on the same tables and K3 on the
  packed transposed view tables, one view exchange feeding both. Dynamic
  plans select each shard's tables on its view (K1 and K2 on them) and
  take the scatter dK/dV twin. The wrappers run the kernels for CUDA
  tensors and their plain versions for CPU tensors.
* :func:`stride_exchange`, :func:`to_work` / :func:`from_work` — a
  reordered schedule's working stream across shards (dilation > 1,
  dilated sinks: the stride permutation of SALO's data reordering): each
  rank's original slice to its slice of the working stream and back, one
  ``all_to_all`` each way (:meth:`~repro_torch.dist.group.SeqGroup
  .exchange`), an exact adjoint pair; the reference applies the
  permutation to the global arrays before its ``shard_map`` region,
  which XLA lowers to an all-to-all.
* :func:`sharded_attention` — the differentiable op, one rank's slice of
  the sequence in and out, whose backward is the single-device contract
  :func:`repro_torch.core.blockwise.plan_backward` with shard-mapped
  engines and the shard's working-stream transforms. Global *rows*
  (global queries attend every key) are the one piece needing
  cross-shard softmax state: each rank forms their partial against its
  own keys and :func:`masked_psum_merge` combines them.
* :func:`masked_psum_merge` — the merge of finalized per-shard partials,
  which the serving engine also uses after K4 and the prefill chunk.

Every function takes the group explicitly: a
:class:`~repro_torch.dist.group.SeqGroup` (one rank; its tensors are this
shard's) or a :class:`~repro_torch.dist.group.StackedGroup` (every shard in
one process; tensors lead with the shard axis), which is to the exchange
and the local passes what ``jax.vmap(..., axis_name=...)`` is to the
reference's ``shard_map``. The op itself takes a ``SeqGroup``.

Traffic per device per layer: ``(sum(halo_counts) + n_gt) * block_k * d``
keys and values, independent of the sequence length, against
``(n_shards - 1) * n_local * d`` for an all-gather (:meth:`ShardedPlan
.stats`).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import types
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.blockwise import _dot, plan_backward
from repro_torch.core.patterns import HybridSparsePattern
from repro_torch.core.renorm import NEG_INF
from repro_torch.core.scheduler import (PAD_SENTINEL, ExecutionPlan,
                                        build_plan, pack_rows, schedule)
from repro_torch.dist.group import RowExchange, StackedGroup


# ---------------------------------------------------------------------- #
# The ShardedPlan IR
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True, eq=False)
class ShardedPlan:
    """Static per-shard slicing of an ExecutionPlan (pure numpy metadata).

    Stacked arrays carry one row per shard. View-tile indices live in
    ``[0, view_tiles)`` over the local layout ``[nkb_l local | halo group
    per distance | n_gt global slots]``.
    """
    plan: ExecutionPlan
    n_shards: int
    nq_l: int                     # query blocks per shard
    nkb_l: int                    # owned KV tiles per shard
    gtiles: Tuple[int, ...]       # global-key tiles (global tile order)
    halo_dists: Tuple[int, ...]   # distinct signed owner distances
    halo_counts: Tuple[int, ...]  # per distance: padded slot count T_δ
    halo_real: Tuple[int, ...]    # per shard: real (unpadded) halo tiles
    view_tiles: int               # nkb_l + sum(halo_counts) + n_gt
    tables: np.ndarray            # (n_shards, nq_l, W) view-tile ids
    flags: np.ndarray             # (n_shards, nq_l, W) step flags
    view_map: np.ndarray          # (n_shards, view_tiles) global tile each
    #                               view slot holds after the exchange (-1 =
    #                               padded halo slot, never referenced)
    send_idx: Tuple[np.ndarray, ...]  # per distance: (n_shards, T_δ) local
    #                                   tile indices each shard SENDS (pad 0)
    g_owner_idx: np.ndarray       # (n_shards, n_gt) local idx of owned gtile
    g_owned: np.ndarray           # (n_shards, n_gt) bool ownership mask
    pos_q: np.ndarray             # (n_shards, nq_l, block_q) positions
    pos_k: np.ndarray             # (n_shards, view_tiles, block_k) positions
    t_row_tile: np.ndarray        # (n_shards, R) packed dK/dV owner tiles
    t_q_blocks: np.ndarray        # (n_shards, R, Wt) packed local q blocks
    t_flags: np.ndarray           # (n_shards, R, Wt)

    @property
    def n_gt(self) -> int:
        return len(self.gtiles)

    def stats(self, d: int, dtype_bytes: int = 2) -> dict:
        """Per-device per-layer exchange bytes (the paper's halo claim).

        ``halo_tiles``/``halo_bytes`` count what :func:`_build_views`
        sends: every shard sends the padded ``sum(halo_counts)`` slots
        (the buffers are padded to the worst shard per distance, wrap sends
        included); ``halo_tiles_real`` is the worst shard's unpadded need.
        ``bcast_bytes`` is the global tiles' sum, against an all-gather
        that cycles every other shard's full KV through each device."""
        bk = self.plan.block_k
        halo_tiles = sum(self.halo_counts)
        halo_bytes = halo_tiles * bk * d * dtype_bytes * 2
        bcast_bytes = self.n_gt * bk * d * dtype_bytes * 2
        allgather_bytes = ((self.n_shards - 1) * self.nkb_l * bk * d
                           * dtype_bytes * 2)
        return dict(
            n_shards=self.n_shards,
            n_local=self.nkb_l * bk,
            halo_tiles=halo_tiles,
            halo_tiles_real=max(self.halo_real) if self.halo_real else 0,
            global_tiles=self.n_gt,
            halo_bytes=halo_bytes,
            bcast_bytes=bcast_bytes,
            exchange_bytes=halo_bytes + bcast_bytes,
            allgather_bytes=allgather_bytes,
            bytes_ratio=(halo_bytes + bcast_bytes)
            / max(allgather_bytes, 1),
        )


@functools.lru_cache(maxsize=64)
def shard_plan(plan: ExecutionPlan, n_shards: int) -> ShardedPlan:
    """Slice ``plan`` into per-shard step tables + exchange metadata."""
    nq, nkb = plan.nq, plan.nkb
    if nq % n_shards or nkb % n_shards:
        raise ValueError(
            f"plan grid ({nq} q blocks, {nkb} KV tiles) must be divisible "
            f"by n_shards={n_shards}; build the plan with pad_multiple="
            f"n_shards * lcm(block_q, block_k)")
    nq_l, nkb_l = nq // n_shards, nkb // n_shards
    bq, bk = plan.block_q, plan.block_k
    pos = plan.positions_padded()
    g = plan.sched.n_global

    if g > 0:
        gtiles = [int(t) for t in np.nonzero(
            (pos.reshape(nkb, bk) < g).any(axis=1))[0]]
    else:
        gtiles = []
    gset = set(gtiles)
    g_index = {t: i for i, t in enumerate(gtiles)}
    n_gt = len(gtiles)

    # Referenced non-local, non-global tiles per shard, grouped by the
    # signed owner distance δ (owner = shard + δ).
    halo = []
    for s in range(n_shards):
        tiles = set()
        for i in range(s * nq_l, (s + 1) * nq_l):
            for st in range(int(plan.num_steps[i])):
                tiles.add(int(plan.kv_blocks[i, st]))
        halo.append(sorted(t for t in tiles
                           if t // nkb_l != s and t not in gset))
    dists = sorted({t // nkb_l - s for s in range(n_shards)
                    for t in halo[s]})
    need = {d: [[t for t in halo[s] if t // nkb_l - s == d]
                for s in range(n_shards)] for d in dists}
    counts = [max(len(need[d][s]) for s in range(n_shards)) for d in dists]
    view_tiles = nkb_l + sum(counts) + n_gt

    # Group base offsets in the view + per-shard view index of each tile.
    group_off = {}
    off = nkb_l
    for d, T in zip(dists, counts):
        group_off[d] = off
        off += T
    g_base = off
    view_of = []   # per shard: {global tile -> view tile}
    for s in range(n_shards):
        m = {}
        for t in range(s * nkb_l, (s + 1) * nkb_l):
            m[t] = t - s * nkb_l
        for d in dists:
            for slot, t in enumerate(need[d][s]):
                m[t] = group_off[d] + slot
        for t in gtiles:
            m.setdefault(t, g_base + g_index[t])
        view_of.append(m)

    # Remapped step tables (values -> view tiles), stacked per shard.
    W = plan.max_steps
    tables = np.zeros((n_shards, nq_l, W), dtype=np.int32)
    flags = np.zeros((n_shards, nq_l, W), dtype=np.int32)
    for s in range(n_shards):
        for i_l in range(nq_l):
            i = s * nq_l + i_l
            for st in range(int(plan.num_steps[i])):
                tables[s, i_l, st] = view_of[s][int(plan.kv_blocks[i, st])]
                flags[s, i_l, st] = int(plan.flags[i, st])

    # What each view slot holds after _build_views runs: the local region
    # is the shard's own tiles, each halo group slot the tile its
    # need-list put there, each global slot its gtile. Padded halo slots
    # (beyond a shard's need, up to the common T_δ) carry -1: they receive
    # what the sender's slot-0 default gathers, no table references them,
    # and they keep PAD_SENTINEL positions.
    view_map = np.full((n_shards, view_tiles), -1, dtype=np.int32)
    for s in range(n_shards):
        view_map[s, :nkb_l] = np.arange(s * nkb_l, (s + 1) * nkb_l)
        for d in dists:
            for slot, t in enumerate(need[d][s]):
                view_map[s, group_off[d] + slot] = t
        for gi, t in enumerate(gtiles):
            view_map[s, g_base + gi] = t

    # What each shard SENDS per distance: the tiles its receiver (shard
    # s - δ, which fetches from owner s) listed, as local tile indices.
    send_idx = []
    for d, T in zip(dists, counts):
        arr = np.zeros((n_shards, T), dtype=np.int32)
        for j in range(n_shards):
            r = j - d
            if 0 <= r < n_shards:
                for slot, t in enumerate(need[d][r]):
                    arr[j, slot] = t - j * nkb_l
        send_idx.append(arr)

    g_owner_idx = np.zeros((n_shards, max(n_gt, 1)), dtype=np.int32)
    g_owned = np.zeros((n_shards, max(n_gt, 1)), dtype=bool)
    for gi, t in enumerate(gtiles):
        o = t // nkb_l
        g_owner_idx[o, gi] = t - o * nkb_l
        g_owned[o, gi] = True
    g_owner_idx = g_owner_idx[:, :n_gt]
    g_owned = g_owned[:, :n_gt]

    # Static positions: local queries; the view's local/halo/global slots.
    pos_q = pos.reshape(n_shards, nq_l, bq).copy()
    pos_k = np.full((n_shards, view_tiles, bk), PAD_SENTINEL, dtype=np.int32)
    pos_t = pos.reshape(nkb, bk)
    for s in range(n_shards):
        pos_k[s, :nkb_l] = pos_t[s * nkb_l: (s + 1) * nkb_l]
        for d in dists:
            for slot, t in enumerate(need[d][s]):
                pos_k[s, group_off[d] + slot] = pos_t[t]
        for gi, t in enumerate(gtiles):
            pos_k[s, g_base + gi] = pos_t[t]

    # Packed local transposed tables (dK/dV): per shard, per VIEW tile, the
    # local query blocks that visit it — one common packed width so the
    # stacked arrays stay rectangular across shards.
    rows_per_shard = []
    all_lens = []
    for s in range(n_shards):
        rows = [[] for _ in range(view_tiles)]
        for i_l in range(nq_l):
            i = s * nq_l + i_l
            for st in range(int(plan.num_steps[i])):
                fl = int(plan.flags[i, st])
                if fl:
                    rows[int(tables[s, i_l, st])].append((i_l, fl))
        rows_per_shard.append(rows)
        all_lens.extend(len(r) for r in rows if r)
    lens = np.asarray(all_lens if all_lens else [1])
    width = max(1, int(np.ceil(np.percentile(lens, 95))))
    packed = [pack_rows(rows, width) for rows in rows_per_shard]
    R = max(p[0].shape[0] for p in packed)
    t_row_tile = np.zeros((n_shards, R), dtype=np.int32)
    t_q_blocks = np.zeros((n_shards, R, width), dtype=np.int32)
    t_flags = np.zeros((n_shards, R, width), dtype=np.int32)
    for s, (rt, qb, fl, _ns, _w) in enumerate(packed):
        r = rt.shape[0]
        t_row_tile[s, :r] = rt
        t_q_blocks[s, :r] = qb
        t_flags[s, :r] = fl

    return ShardedPlan(
        plan=plan, n_shards=n_shards, nq_l=nq_l, nkb_l=nkb_l,
        gtiles=tuple(gtiles), halo_dists=tuple(dists),
        halo_counts=tuple(counts),
        halo_real=tuple(len(h) for h in halo), view_tiles=view_tiles,
        tables=tables, flags=flags, view_map=view_map,
        send_idx=tuple(send_idx),
        g_owner_idx=g_owner_idx, g_owned=g_owned, pos_q=pos_q, pos_k=pos_k,
        t_row_tile=t_row_tile, t_q_blocks=t_q_blocks, t_flags=t_flags)


def _auto_block(n_work: int, n_shards: int, requested: Optional[int]) -> int:
    """Largest power-of-two block <= min(128, the shard's slot count) —
    keeps pad_multiple (= n_shards * lcm of the blocks) from inflating
    n_pad far past the sequence on small shards."""
    b = 8
    while b * 2 <= min(128, max(8, n_work // n_shards)):
        b *= 2
    return min(requested, b) if requested else b


# ---------------------------------------------------------------------- #
# Cross-shard softmax merge (serving, and the global rows of training)
# ---------------------------------------------------------------------- #
def masked_psum_merge(out: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                      group, return_stats: bool = False):
    """Combine per-shard finalized attention partials across a group.

    The sharded paged slab gives each shard a disjoint slice of every
    request's cache, so decode and chunked prefill run one launch per shard
    over the owned slots, and the partials are merged here. ``out``:
    (..., d) = acc / l (guarded); ``m``/``l``: (...) f32 row stats. Each
    shard's contribution is weighted by ``c = l * exp(m - M)`` with ``M``
    the max of ``m`` over the shards; the empty-row identity ``(0,
    NEG_INF, 0)`` gives ``c == 0``, so a shard that holds no valid slot for
    a row (inactive request, slot owned elsewhere, ring not yet reaching
    the shard) contributes exactly nothing.

    ``group``: a :class:`~repro_torch.dist.group.SeqGroup` (or a
    :class:`~repro_torch.dist.group.StackedGroup`, whose tensors lead with
    the shard axis). Two collectives, both ``all_reduce``: MAX over ``m``,
    then ONE SUM over ``out * c`` and ``c`` stacked on the last axis. All
    in f32; returns the merged (..., d) f32 output, which the caller rounds
    once to its compute dtype. ``return_stats=True`` returns ``(out, M,
    L)``: the merged row max and the denominator ``L = sum(c)``, so the
    merged probabilities are ``exp(s - M) / L`` (M read as 0 where it is
    NEG_INF; L is 0 on a row empty on every shard)."""
    M = group.pmax_(m.float().clone())
    shift = torch.where(M <= NEG_INF / 2, 0.0, M)
    c = l.float() * torch.exp(m.float() - shift)   # empty rows: l == 0
    buf = torch.cat([out.float() * c[..., None], c[..., None]], dim=-1)
    group.psum_(buf)
    den = buf[..., -1]
    merged = buf[..., :-1] / torch.where(den == 0.0, 1.0, den)[..., None]
    return (merged, M, den) if return_stats else merged


# ---------------------------------------------------------------------- #
# The plan's tables on a device, per shard
# ---------------------------------------------------------------------- #
class ShardTables(NamedTuple):
    """A sharded plan's tables as tensors on one device, one tensor per
    shard (each its own allocation, so every kernel operand starts on a
    16-byte boundary): int32 step tables and positions, int64 exchange
    indices, bool ownership."""
    tables: List[torch.Tensor]      # (nq_l, W)
    flags: List[torch.Tensor]
    pos_q: List[torch.Tensor]       # (nq_l, block_q)
    pos_k: List[torch.Tensor]       # (view_tiles, block_k)
    row_tile: List[torch.Tensor]    # (R,)
    q_blocks: List[torch.Tensor]    # (R, Wt)
    pk_flags: List[torch.Tensor]
    send_idx: List[List[torch.Tensor]]   # per distance, per shard: (T_δ,)
    g_owner_idx: List[torch.Tensor]      # (n_gt,)
    g_owned: List[torch.Tensor]          # (n_gt,)


@functools.lru_cache(maxsize=64)
def shard_tables(sp: ShardedPlan, device: torch.device) -> ShardTables:
    """``sp``'s tables uploaded to ``device`` once per (plan, device) and
    cached, so a train step copies no table per layer."""
    def up(a, dtype=torch.int32):
        return [torch.as_tensor(np.ascontiguousarray(a[s]),
                                dtype=dtype).to(device)
                for s in range(sp.n_shards)]

    return ShardTables(
        tables=up(sp.tables), flags=up(sp.flags), pos_q=up(sp.pos_q),
        pos_k=up(sp.pos_k), row_tile=up(sp.t_row_tile),
        q_blocks=up(sp.t_q_blocks), pk_flags=up(sp.t_flags),
        send_idx=[up(a, torch.int64) for a in sp.send_idx],
        g_owner_idx=up(sp.g_owner_idx, torch.int64),
        g_owned=up(sp.g_owned, torch.bool))


def _stacked(group) -> bool:
    return isinstance(group, StackedGroup)


def _take_tiles(group, x: torch.Tensor, idx: List[torch.Tensor]):
    """Gather KV tiles (axis -3) by each shard's index row ``idx[s]``."""
    if _stacked(group):
        return torch.stack([x[s].index_select(x.dim() - 4, idx[s])
                            for s in range(group.size)])
    return x.index_select(x.dim() - 3, idx[group.index])


def _add_tiles(group, x: torch.Tensor, idx: List[torch.Tensor],
               src: torch.Tensor) -> None:
    """``x[..., idx[s], :, :] += src`` on the tile axis (-3), in place."""
    if _stacked(group):
        for s in range(group.size):
            x[s].index_add_(x.dim() - 4, idx[s], src[s])
    else:
        x.index_add_(x.dim() - 3, idx[group.index], src)


def _owned(group, owned: List[torch.Tensor]) -> torch.Tensor:
    """The global tiles' ownership mask, shaped to broadcast over
    ``(*shard, 2, B, n_gt, bk, D)``."""
    if _stacked(group):
        return torch.stack(owned)[:, None, None, :, None, None]
    return owned[group.index][None, None, :, None, None]


def _per_shard(group, fn, *xs):
    """``fn(s, *xs)`` for this rank's shard, or for every shard of a
    :class:`StackedGroup` (``xs`` sliced on their leading axis, the
    results stacked on it)."""
    if not _stacked(group):
        return fn(group.index, *xs)
    outs = [fn(s, *(x[s] for x in xs)) for s in range(group.size)]
    return tuple(torch.stack(o) for o in zip(*outs))


# ---------------------------------------------------------------------- #
# The halo/broadcast exchange and its exact adjoint
# ---------------------------------------------------------------------- #
def _build_views(sp: ShardedPlan, group, k_l: torch.Tensor,
                 v_l: torch.Tensor):
    """Local KV -> full local view: one ``ppermute`` per halo distance (K
    and V ride one stacked buffer) + one masked sum for the global tiles.

    k_l/v_l: (B, nkb_l * bk, D) this shard's keys, or (S, B, ..., D) on a
    StackedGroup. Returns ``(k_view, v_view)``, (B, view_tiles * bk, D)
    each (the shard axis first on a StackedGroup). Every rank sends and
    receives at every distance (the cyclic permutation, wrap sends
    included), so every slot holds what a sender gathered: padded halo
    slots hold the sender's local tile 0, finite, and no table reads
    them. The global tiles' sum runs in K/V's own type: every rank but the
    owner adds zeros, so it is exact in any type."""
    t = shard_tables(sp, k_l.device)
    lead = k_l.shape[:-2]
    D = k_l.shape[-1]
    bk = sp.plan.block_k
    sd = len(lead) - 1                      # the K/V stacking axis
    kv = torch.stack([k_l.reshape(*lead, sp.nkb_l, bk, D),
                      v_l.reshape(*lead, sp.nkb_l, bk, D)], dim=sd)
    parts = [kv]
    for d_i, delta in enumerate(sp.halo_dists):
        buf = _take_tiles(group, kv, t.send_idx[d_i])
        perm = [(j, (j - delta) % sp.n_shards) for j in range(sp.n_shards)]
        parts.append(group.ppermute(buf, perm))
    if sp.n_gt:
        contrib = torch.where(_owned(group, t.g_owned),
                              _take_tiles(group, kv, t.g_owner_idx), 0.0)
        parts.append(group.psum_(contrib))
    view = torch.cat(parts, dim=-3)          # (*, 2, B, view_tiles, bk, D)
    shape = (*lead, sp.view_tiles * bk, D)
    return (view.select(sd, 0).reshape(shape),
            view.select(sd, 1).reshape(shape))


def _return_views(sp: ShardedPlan, group, dk_view: torch.Tensor,
                  dv_view: torch.Tensor):
    """Adjoint of :func:`_build_views`: halo-slot gradients ride the
    REVERSE ``ppermute`` back to their owner shard; global-slot gradients
    are summed over the group and claimed by each tile's owner. Padded
    slots are referenced by no table, so their gradients are exactly zero
    and the adds of the padding lanes add zeros. f32 (or wider) out:
    (B, view_tiles * bk, D) -> (B, nkb_l * bk, D), the shard axis first
    on a StackedGroup."""
    t = shard_tables(sp, dk_view.device)
    lead = dk_view.shape[:-2]
    D = dk_view.shape[-1]
    bk = sp.plan.block_k
    sd = len(lead) - 1
    dkv = torch.stack([dk_view.reshape(*lead, sp.view_tiles, bk, D),
                       dv_view.reshape(*lead, sp.view_tiles, bk, D)],
                      dim=sd)
    dkv = dkv.to(torch.promote_types(dkv.dtype, torch.float32))
    dloc = dkv[..., : sp.nkb_l, :, :].clone()
    off = sp.nkb_l
    for d_i, (delta, T) in enumerate(zip(sp.halo_dists, sp.halo_counts)):
        buf = dkv[..., off: off + T, :, :].contiguous()
        off += T
        perm = [(j, (j + delta) % sp.n_shards) for j in range(sp.n_shards)]
        _add_tiles(group, dloc, t.send_idx[d_i], group.ppermute(buf, perm))
    if sp.n_gt:
        dg = group.psum_(dkv[..., off: off + sp.n_gt, :, :].contiguous())
        _add_tiles(group, dloc, t.g_owner_idx,
                   torch.where(_owned(group, t.g_owned), dg, 0.0))
    shape = (*lead, sp.nkb_l * bk, D)
    return (dloc.select(sd, 0).reshape(shape),
            dloc.select(sd, 1).reshape(shape))


# ---------------------------------------------------------------------- #
# Per-shard tables, runtime selection, and the shard-local passes
# ---------------------------------------------------------------------- #
def _shard_tables(sp: ShardedPlan, s: int, device):
    t = shard_tables(sp, device)
    return t.tables[s], t.flags[s], t.pos_q[s], t.pos_k[s]


@functools.lru_cache(maxsize=64)
def _sharded_always_keep(sp: ShardedPlan, local_window: int) -> np.ndarray:
    """Per-shard never-drop masks over the candidate tables: the dynamic
    selection runs on each shard's [local | halo | global] view, and the
    causal-local/global exemptions are decided on ORIGINAL positions — the
    view remap is transparent. Stacked (n_shards, nq_l, W) bool."""
    from repro_torch.core.dynamic import always_keep_mask
    out = np.zeros(sp.tables.shape, dtype=bool)
    for s in range(sp.n_shards):
        out[s] = always_keep_mask(sp.tables[s], sp.flags[s], sp.pos_q[s],
                                  sp.pos_k[s], local_window,
                                  sp.plan.sched.causal)
    return out


@functools.lru_cache(maxsize=64)
def _always_on(sp: ShardedPlan, local_window: int, device: torch.device):
    """:func:`_sharded_always_keep` on ``device``, one tensor per shard."""
    a = _sharded_always_keep(sp, local_window)
    return [torch.as_tensor(a[s]).to(device) for s in range(sp.n_shards)]


def _dyn_select(sp: ShardedPlan, dyn, s: int, q_l, k_view, tbl, flg, pq, pk,
                scale: float):
    """Shard ``s``'s top-k over its candidate tables, on its view after the
    exchange: the exchange schedule stays static while the executed steps
    are chosen by content. Deterministic in (q_l, k_view), so the backward
    replays the forward's tables."""
    from repro_torch.core.dynamic import _resolve_window, select_steps
    lw = _resolve_window(dyn, sp.plan.block_q, sp.plan.block_k)
    keep = min(int(dyn.keep), sp.tables.shape[2])
    return select_steps(q_l, k_view, tbl, flg, pq, pk,
                        _always_on(sp, lw, q_l.device)[s], keep, scale,
                        dyn.pool_k)


def _make_local_fwd(sp: ShardedPlan, group, scale: float, dyn=None):
    """The shard-local forward ``local(q_l, k_l, v_l) -> (out, m, l)``:
    the view exchange, then K1 (``salo_table_attention``) on the shard's
    view tables — on tables selected on the view for a dynamic plan. q_l,
    k_l, v_l: (B, n_local, D) this shard's slice of the working stream
    (the shard axis first on a StackedGroup); out in q's dtype, m/l
    (B, n_local) f32."""
    from repro_torch.kernels.salo_attention import salo_table_attention
    sched = sp.plan.sched

    def shard(s, q_l, k_view, v_view):
        tbl, flg, pq, pk = _shard_tables(sp, s, q_l.device)
        if dyn is not None:
            tbl, flg = _dyn_select(sp, dyn, s, q_l, k_view, tbl, flg, pq,
                                   pk, scale)
        return salo_table_attention(q_l.contiguous(), k_view, v_view, pq,
                                    pk, tbl, flg, sched=sched, scale=scale)

    def local(q_l, k_l, v_l):
        k_view, v_view = _build_views(sp, group, k_l, v_l)
        return _per_shard(group, shard, q_l, k_view, v_view)

    return local


def _make_local_bwd(sp: ShardedPlan, group, scale: float, dyn=None):
    """The shard-local backward ``local(dout, delta, m, l, q_l, k_l, v_l)
    -> (dq, dk_l, dv_l)``: ONE view exchange feeds both gradient passes —
    K2 (dQ) on the shard's forward tables and K3 (dK/dV) on its packed
    transposed view tables — and the view's dK/dV go back to their owners
    by :func:`_return_views`. Dynamic plans replay the forward's
    selection from (q_l, k_view) and take the scatter twin
    :func:`~repro_torch.core.blockwise.table_dkv_scatter_scan` for dK/dV
    (a packed transposed walk cannot exist for runtime tables). dq in q's
    dtype; dk/dv f32."""
    from repro_torch.core.blockwise import table_dkv_scatter_scan
    from repro_torch.kernels.salo_backward import (salo_table_backward_dkv,
                                                   salo_table_backward_dq)
    sched = sp.plan.sched

    def shard(s, dout, delta, m, l, q_l, k_view, v_view):
        tbl, flg, pq, pk = _shard_tables(sp, s, q_l.device)
        args = (dout.contiguous(), delta.contiguous(), m.contiguous(),
                l.contiguous(), q_l.contiguous(), k_view, v_view, pq, pk)
        kw = dict(sched=sched, scale=scale)
        if dyn is not None:
            tbl, flg = _dyn_select(sp, dyn, s, q_l, k_view, tbl, flg, pq,
                                   pk, scale)
            dq = salo_table_backward_dq(*args, tbl, flg, **kw)
            dk_v, dv_v = table_dkv_scatter_scan(*args, tbl, flg, sched,
                                                scale)
            return dq, dk_v, dv_v
        t = shard_tables(sp, q_l.device)
        dq = salo_table_backward_dq(*args, tbl, flg, **kw)
        dk_v, dv_v = salo_table_backward_dkv(*args, t.row_tile[s],
                                             t.q_blocks[s], t.pk_flags[s],
                                             **kw)
        return dq, dk_v, dv_v

    def local(dout, delta, m, l, q_l, k_l, v_l):
        k_view, v_view = _build_views(sp, group, k_l, v_l)
        dq, dk_view, dv_view = _per_shard(group, shard, dout, delta, m, l,
                                          q_l, k_view, v_view)
        dk_l, dv_l = _return_views(sp, group, dk_view, dv_view)
        return dq, dk_l, dv_l

    return local


# ---------------------------------------------------------------------- #
# Global rows over the group
# ---------------------------------------------------------------------- #
def _row_span(sched, group, n_local: int) -> Tuple[int, int]:
    """(first global row's original position on this shard, how many of
    the ``n_global`` rows this shard owns)."""
    lo = group.index * n_local
    return lo, max(0, min(sched.n_global, lo + n_local) - lo)


def _rows_scores(sched, group, qg, k_l, scale: float):
    """Scores of the g global queries against this shard's keys (B, g,
    n_local), f32, NEG_INF where a causal pattern masks them (so their
    ``exp(s - shift)`` is exactly 0)."""
    s = _dot(qg, k_l) * scale
    if not sched.causal:
        return s
    dev = k_l.device
    n_local = k_l.shape[1]
    kpos = group.index * n_local + torch.arange(n_local, device=dev)
    mask = (kpos[None, :] <= torch.arange(sched.n_global, device=dev)[:, None])
    return torch.where(mask[None], s, NEG_INF)


def _rows_forward(sched, group, q_l, k_l, v_l, scale: float):
    """The global-row epilogue over the group. The ``n_global`` global
    queries (they may span shards) reach every rank by a masked sum;
    each rank forms their f32 partial ``(out, m, l)`` against its own keys
    (causal mask where the pattern is causal); :func:`masked_psum_merge`
    combines the partials. Returns ``(rows, qg, M, L)``: the merged rows
    (B, g, D) f32 — the owners write theirs — the global queries (B, g, D)
    f32 and the merged row max and denominator (B, g), kept for the
    backward."""
    B, n_local, D = q_l.shape
    g = sched.n_global
    lo, own = _row_span(sched, group, n_local)
    qg = torch.zeros((B, g, D), dtype=torch.float32, device=q_l.device)
    qg[:, lo: lo + own] = q_l[:, :own].float()
    group.psum_(qg)
    s = _rows_scores(sched, group, qg, k_l, scale)
    m = s.amax(dim=-1)
    shift = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.exp(s - shift[..., None])           # masked: exactly 0
    l = p.sum(dim=-1)
    out = torch.matmul(p, v_l.float()) \
        / torch.where(l == 0.0, 1.0, l)[..., None]
    rows, M, L = masked_psum_merge(out, m, l, group, return_stats=True)
    return rows, qg, M, L


def _rows_vjp(sched, group, q_l, k_l, v_l, scale: float, rows, qg, M, L,
              g):
    """The global rows' VJP over the group, for ``plan_backward``: the
    rows' cotangent reaches every rank by a masked sum (the merged rows
    are on every rank, so ``delta = dO . O`` is local); each rank rebuilds
    ``p = exp(s - M) / L`` for its keys, adds its dK/dV, and its dQ
    partial is summed over the group, the owners taking their rows.
    Returns ``(g with the rows zeroed, (dq, dk, dv))``, the additions f32
    in the local layout."""
    B, n_local, D = q_l.shape
    ng = sched.n_global
    lo, own = _row_span(sched, group, n_local)
    gcot = torch.zeros((B, ng, D), dtype=torch.float32, device=g.device)
    gcot[:, lo: lo + own] = g[:, :own].float()
    group.psum_(gcot)
    s = _rows_scores(sched, group, qg, k_l, scale)
    shift = torch.where(M <= NEG_INF / 2, 0.0, M)
    p = torch.exp(s - shift[..., None]) \
        / torch.where(L == 0.0, 1.0, L)[..., None]
    delta = (gcot * rows).sum(dim=-1)
    ds = p * (torch.matmul(gcot, v_l.float().transpose(-1, -2))
              - delta[..., None])
    dv = torch.matmul(p.transpose(-1, -2), gcot)
    dk = torch.matmul(ds.transpose(-1, -2), qg) * scale
    dq_g = group.psum_(torch.matmul(ds, k_l.float()) * scale)
    dq = torch.zeros((B, n_local, D), dtype=torch.float32, device=g.device)
    dq[:, :own] = dq_g[:, lo: lo + own]
    g_main = torch.cat([torch.zeros_like(g[:, :own]), g[:, own:]], dim=1)
    return g_main, (dq, dk, dv)


# ---------------------------------------------------------------------- #
# The working stream across shards
# ---------------------------------------------------------------------- #
@functools.lru_cache(maxsize=64)
def stride_exchange(plan: ExecutionPlan, n_shards: int) -> RowExchange:
    """The working stream of a reordered schedule across ``n_shards``
    shards, as one all-to-all: rank ``r`` holds the original positions
    ``[r N/S, (r+1) N/S)`` and works on the working slots ``[r n_pad/S,
    (r+1) n_pad/S)``; each working slot takes the position ``sched.perm``
    names (core/scheduler.py), from the rank that holds it. Slots whose
    ``perm`` is past N and the tail past ``n_work`` are padding: no rank
    sends them, so they are zeros. Pure numpy, cached per (plan,
    n_shards)."""
    sched, S = plan.sched, n_shards
    N = sched.n
    if N % S or plan.n_pad % S:
        raise ValueError(f"the working stream of n {N} (n_pad "
                         f"{plan.n_pad}) does not split into {S} shards")
    n_l, w_l = N // S, plan.n_pad // S
    pos = np.full(plan.n_pad, N, dtype=np.int64)     # original position
    pos[: sched.n_work] = (np.arange(sched.n_work) if sched.perm is None
                           else sched.perm)
    counts = np.zeros((S, S), dtype=np.int64)
    send = [[] for _ in range(S)]
    recv = []
    for j in range(S):                      # the rank whose slots these are
        p = pos[j * w_l: (j + 1) * w_l]
        src = np.where(p < N, p // n_l, S)
        recv.append(np.concatenate([np.nonzero(src == r)[0]
                                    for r in range(S)]))
        for r in range(S):
            rows = p[src == r] - r * n_l
            counts[r, j] = rows.size
            send[r].append(rows)
    return RowExchange(n_l, w_l, counts,
                       tuple(np.concatenate(x) for x in send), tuple(recv))


def _through(sp: ShardedPlan, group, ex: RowExchange, xs):
    """``xs`` through ONE exchange: joined on the batch axis (each (B, n,
    ...) of one shape past B, the shard axis first on a StackedGroup) in
    their widest type, moved, split, and each returned in its own type.
    The identity on a schedule that is not reordered."""
    if not sp.plan.sched.reordered:
        return tuple(xs)
    ax = 1 if _stacked(group) else 0
    dt = functools.reduce(torch.promote_types, (x.dtype for x in xs))
    y = group.exchange(xs[0].to(dt) if len(xs) == 1 else
                       torch.cat([x.to(dt) for x in xs], dim=ax), ex)
    return tuple(p.to(x.dtype) for p, x in zip(y.chunk(len(xs), dim=ax),
                                                xs))


def to_work(sp: ShardedPlan, group, *xs):
    """Each of ``xs``, this rank's slice (B, N / S, ...) of the original
    sequence, as its slice (B, n_pad / S, ...) of the working stream: the
    single-device :func:`~repro_torch.core.blockwise.working_stream` cut
    per shard, bit for bit, through ONE all-to-all over ``group``
    (:func:`stride_exchange`; every tensor of ``xs`` in one buffer).
    Padding slots are zeros."""
    return _through(sp, group, stride_exchange(sp.plan, sp.n_shards), xs)


def from_work(sp: ShardedPlan, group, *xs):
    """The inverse of :func:`to_work` and its exact adjoint (the same rows
    sent back, the padding dropped): each of ``xs`` (B, n_pad / S, ...)
    -> (B, N / S, ...), through ONE all-to-all."""
    return _through(sp, group, stride_exchange(sp.plan, sp.n_shards)
                    .reverse, xs)


# ---------------------------------------------------------------------- #
# The sharded attention op
# ---------------------------------------------------------------------- #
def _sharded_forward(q, k, v, sp: ShardedPlan, group, scale: float, dyn):
    """One rank's forward: q, k and v into the rank's slice of the working
    stream (:func:`to_work`), the local pass on it, the output back
    (:func:`from_work`), then the global rows on the original slices.
    Returns ``(out, (qw, kw, vw, out_w, m, l), rows_state)``: m and l stay
    in the working layout."""
    from repro_torch.kernels.ops import _launch_accounting
    sched = sp.plan.sched
    s = group.index
    qw, kw, vw = to_work(sp, group, q, k, v)
    tiles = int((sp.flags[s] != 0).sum())
    if dyn is not None:
        from repro_torch.core.dynamic import _account_build
        tiles = _account_build(sp.flags[s], min(int(dyn.keep),
                                                sp.tables.shape[2]))
    # the booking's shapes are the shard's: nq_l query blocks
    _launch_accounting("salo_table_attention", types.SimpleNamespace(
        nq=sp.nq_l, block_q=sp.plan.block_q, block_k=sp.plan.block_k),
        qw, tiles)
    out_w, m, l = _make_local_fwd(sp, group, scale, dyn)(qw, kw, vw)
    out, = from_work(sp, group, out_w)
    rows_state = ()
    if sched.n_global > 0 and sched.global_rows:
        rows_state = _rows_forward(sched, group, q, k, v, scale)
        lo, own = _row_span(sched, group, q.shape[1])
        if own:
            out = torch.cat([rows_state[0][:, lo: lo + own].to(q.dtype),
                             out[:, own:]], dim=1)
    return out, (qw, kw, vw, out_w, m, l), rows_state


class _ShardedAttention(torch.autograd.Function):
    """The reference's ``custom_vjp`` pair: the forward saves the
    working-layout q, k, v and the local partial triple (and, with global
    rows, the original slices and the rows' state); the backward is
    :func:`~repro_torch.core.blockwise.plan_backward` with shard-mapped
    engines and this shard's working-stream transforms — one combined
    local backward (one view exchange) answers the dQ engine, and the
    dK/dV engine returns its stashed result."""

    @staticmethod
    def forward(ctx, q, k, v, sp, group, scale, dyn):
        out, res, rows_state = _sharded_forward(q, k, v, sp, group, scale,
                                                dyn)
        rows = (q, k, v, *rows_state) if rows_state else ()
        ctx.save_for_backward(*res, *rows)
        ctx.cfg = (sp, group, scale, dyn)
        return out

    @staticmethod
    def backward(ctx, g):
        qw, kw, vw, out_w, m, l, *rows = ctx.saved_tensors
        sp, group, scale, dyn = ctx.cfg
        sched = sp.plan.sched
        stash = {}

        def dq_engine(dout, delta, m_, l_, qw_, kw_, vw_, _pos):
            dq, dk, dv = _make_local_bwd(sp, group, scale, dyn)(
                dout, delta, m_, l_, qw_, kw_, vw_)
            stash["dkv"] = (dk, dv)
            return dq

        def dkv_engine(*_args):
            return stash.pop("dkv")

        def send_back(*grads):
            # without global rows plan_backward adds nothing to the
            # gradients before it rounds them to the inputs' types: round
            # first, and the exchange moves half the bytes, the same bits
            if not rows:
                grads = tuple(x.to(w.dtype) for x, w in zip(grads,
                                                             (qw, kw, vw)))
            return from_work(sp, group, *grads)

        if rows:
            rows_vjp = functools.partial(_rows_vjp, sched, group,
                                         *rows[:3], scale, *rows[3:])
        else:
            def rows_vjp(g_):
                return g_, None
        dq, dk, dv = plan_backward(
            g, qw, kw, vw, out_w, m, l, sp.plan, scale, dq_engine,
            dkv_engine, rows_vjp=rows_vjp, qkv_w=(qw, kw, vw),
            working=(functools.partial(to_work, sp, group), send_back, None))
        return dq, dk, dv, None, None, None, None


def sharded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      pattern: HybridSparsePattern, group, *,
                      block_q: Optional[int] = None,
                      block_k: Optional[int] = None,
                      scale: Optional[float] = None,
                      dynamic=None) -> torch.Tensor:
    """Sequence-parallel hybrid sparse attention over ``group``.

    q/k/v: (B, N / S, D) — this rank's contiguous slice of the original
    sequence of length N over the S ranks of ``group`` (a
    :class:`~repro_torch.dist.group.SeqGroup`); B folds batch*heads.
    Returns this rank's slice of the output; differentiable. Every rank
    calls it with the same pattern and shapes.

    Blocks: the largest power of two up to 128 and the shard's length,
    capped by ``block_q``/``block_k`` (the reference's ``_auto_block``).
    The plan pads its working stream to a multiple of ``S * lcm(block_q,
    block_k)``. A reordered schedule (dilation > 1, dilated sinks: the
    working stream is a global stride permutation, an all-to-all in the
    reference) takes its slices through :func:`to_work` /
    :func:`from_work`, its padding in the working stream. Otherwise the
    rank's slice must be its slice of the working stream: N a multiple of
    ``S * lcm(block_q, block_k)``, else ``ValueError``. Covers causal and
    bidirectional windows (halos on both sides), windows wider than a
    shard (several halo distances), global tiles and global rows, 2-D ViL
    bands.

    Collectives a call: the view exchange (one ``ppermute`` per halo
    distance and one sum of the global tiles) forward and again backward,
    with its reverse; on a reordered schedule also 2 stride exchanges
    (``all_to_all``) forward — q, k and v in one buffer, the output back
    — and 2 backward — the cotangent in, dq, dk and dv back in one
    buffer (the forward keeps q, k and v in the working layout for it).
    A train step under remat full replays the forward: 6 a layer.

    ``dynamic`` (a :class:`repro_torch.core.dynamic.DynamicConfig`): each
    shard selects its top-``keep`` steps on its view after the exchange.
    CUDA tensors run K1–K3 (K1 and K2 on a dynamic plan) or raise; CPU
    tensors their plain versions.
    """
    if _stacked(group):
        raise TypeError("sharded_attention runs one rank's slice: pass a "
                        "SeqGroup (a StackedGroup drives the shard-local "
                        "passes only)")
    B, n_local, D = q.shape
    S = group.size
    N = n_local * S
    sched = schedule(pattern, N)
    bq = _auto_block(sched.n_work, S, block_q)
    bk = _auto_block(sched.n_work, S, block_k)
    mult = S * math.lcm(bq, bk)
    if N % mult and not sched.reordered:
        raise ValueError(
            f"sharded_attention needs the sequence length N = {N} to be a "
            f"multiple of n_shards * lcm(block_q, block_k) = {S} * "
            f"lcm({bq}, {bk}) = {mult}, so that each rank's slice is its "
            f"slice of the working stream")
    plan = build_plan(sched, bq, bk, mult)
    sp = shard_plan(plan, S)
    scale_ = (D ** -0.5) if scale is None else float(scale)
    if dynamic is not None:
        from repro_torch.core.dynamic import _resolve_window, check_keep
        lw = _resolve_window(dynamic, bq, bk)
        check_keep(min(int(dynamic.keep), sp.tables.shape[2]),
                   _sharded_always_keep(sp, lw), what="sharded plan")
    return _ShardedAttention.apply(q, k, v, sp, group, scale_, dynamic)
