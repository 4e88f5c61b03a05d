"""THE step-table contract: one spec every table producer and consumer share.

Every table-driven engine consumes the same IR — in this slice of the
port, the serving chunk tables (:class:`repro_torch.core.scheduler.ChunkPlan`)
walked by :func:`repro_torch.core.blockwise.chunk_attention`: a pair of
rectangular int32 arrays

    ``kv_blocks[i, s]`` — the KV tile query-block row ``i`` visits at
    step ``s`` (a value in ``[0, nkb)`` over whatever tile universe the
    consumer walks: the padded working grid, a shard's local view, a
    chunk's paged view);
    ``flags[i, s]``     — which mask components that visit evaluates, a
    bitmask of :data:`STEP_WINDOW` and :data:`STEP_GLOBAL`.

The contract, checked by :func:`validate_tables`:

* both arrays are rank-2 ``int32`` of identical shape ``(nq, width)``,
  ``width >= 1`` (the fixed ``steps`` dimension of the kernel grid —
  rows are padded to it, never ragged);
* every tile index lies in ``[0, nkb)`` — including padding steps, which
  point at tile 0 so gathers stay in-bounds;
* ``flags`` uses no bits outside ``STEP_WINDOW | STEP_GLOBAL``;
* a step is padding **iff** ``flags == 0``; padding steps carry
  ``kv_blocks == 0`` (the no-op contract: every mask term of
  ``step_mask``/``causal_step_mask`` evaluates False, the gathered tile 0
  contributes nothing);
* within a row, no real tile is visited twice (the dedup invariant that
  makes the union mask exact — each attended pair is counted once);
* when the producer also emits ``num_steps``, row ``i``'s real steps are
  a left-aligned prefix: ``flags[i, :num_steps[i]]`` all nonzero,
  ``flags[i, num_steps[i]:]`` all zero.

Positions are NOT part of the tables: padding *slots* (not steps) are
expressed through the position streams, where :data:`PAD_SENTINEL` marks
a slot holding nothing — every mask fails on it by the in-range guard.
The static builder additionally emits rows in ascending tile order; that
is a convention (it gives deterministic step order), not a contract —
sharded view remapping and runtime top-k selection produce other orders
and every consumer folds steps through an order-invariant online softmax.

Tables may be numpy arrays or torch tensors; a tensor is copied to the
host for the value checks.
"""
from __future__ import annotations

import numpy as np

# Sentinel original-position for padding slots — THE one padding sentinel,
# shared by every cache/kernel path. Must fit int32 (the kernels'
# position width) *and* keep pos_j - pos_i inside int32 — any mask
# comparison against it must fail via the `pos < n` in-range guard or a
# window-distance check.
BIG = 2 ** 31 - 2 ** 20
PAD_SENTINEL = BIG

# Step flags: which mask components a step evaluates.
STEP_WINDOW = 1   # some band covers this (q_block, kv_tile) visit
STEP_GLOBAL = 2   # the KV tile holds global-prefix keys

VALID_FLAGS = STEP_WINDOW | STEP_GLOBAL


def iter_real_steps(kv_blocks, flags):
    """Yield ``(row, step, tile, flag)`` for every real (``flags != 0``)
    step of a contract table pair: the one walk order every pass of
    :mod:`repro_torch.analysis.plan_verify` builds its coverage counts
    and visit multisets from."""
    kv = _concrete(kv_blocks)
    fl = _concrete(flags)
    for i, s in zip(*np.nonzero(fl)):
        yield int(i), int(s), int(kv[i, s]), int(fl[i, s])


def _concrete(a) -> np.ndarray:
    """numpy view of ``a`` (a numpy array, or a torch tensor, which is
    copied to the host)."""
    if isinstance(a, np.ndarray):
        return a
    import torch

    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _np_dtype(a) -> np.dtype:
    """numpy dtype of a numpy array or torch tensor."""
    dt = getattr(a, "dtype", None)
    if isinstance(dt, np.dtype):
        return dt
    import torch

    if isinstance(dt, torch.dtype):
        return torch.empty((), dtype=dt).numpy().dtype
    return np.dtype(dt)


def validate_tables(kv_blocks, flags, *, nkb: int,
                    num_steps=None, name: str = "step tables",
                    values: bool = True) -> None:
    """Check a ``(kv_blocks, flags)`` pair against the table contract.

    ``nkb`` is the tile universe the consumer will index with these
    values (padded working grid / shard view / chunk view). Raises
    :class:`ValueError` with the offending row/step on violation.
    ``values=False`` checks shapes and dtypes only: what the reference's
    check sees inside ``jax.jit``, and what a hot path on the card can
    check without copying its tables to the host.
    """
    shape = getattr(kv_blocks, "shape", None)
    fshape = getattr(flags, "shape", None)
    if shape is None or fshape is None or len(shape) != 2 \
            or shape != fshape:
        raise ValueError(
            f"{name}: kv_blocks/flags must be rank-2 arrays of one shape, "
            f"got {shape} vs {fshape}")
    if shape[1] < 1:
        raise ValueError(f"{name}: table width must be >= 1, got {shape[1]}")
    for label, arr in (("kv_blocks", kv_blocks), ("flags", flags)):
        dt = _np_dtype(arr)
        if dt != np.int32:
            raise ValueError(f"{name}: {label} must be int32, got {dt}")
    if nkb < 1:
        raise ValueError(f"{name}: tile universe nkb must be >= 1, "
                         f"got {nkb}")
    if not values:
        return

    kv = _concrete(kv_blocks)
    fl = _concrete(flags)

    bad = fl & ~VALID_FLAGS
    if bad.any():
        i, s = np.argwhere(bad != 0)[0]
        raise ValueError(
            f"{name}: unknown flag bits {int(fl[i, s])} at row {i} step {s}"
            f" (valid mask: {VALID_FLAGS})")
    oob = (kv < 0) | (kv >= nkb)
    if oob.any():
        i, s = np.argwhere(oob)[0]
        raise ValueError(
            f"{name}: tile index {int(kv[i, s])} at row {i} step {s} "
            f"outside [0, {nkb})")
    pad_bad = (fl == 0) & (kv != 0)
    if pad_bad.any():
        i, s = np.argwhere(pad_bad)[0]
        raise ValueError(
            f"{name}: padding step (flags == 0) at row {i} step {s} must "
            f"point at tile 0, got tile {int(kv[i, s])}")
    # per-row dedup of REAL tiles: padding steps all alias tile 0 and are
    # excluded via a sort key that keeps them distinct from real tile 0.
    key = np.where(fl != 0, kv.astype(np.int64), -1)
    srt = np.sort(key, axis=1)
    dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    if dup.any():
        i = int(np.argwhere(dup.any(axis=1))[0][0])
        t = int(srt[i][1:][dup[i]][0])
        raise ValueError(
            f"{name}: row {i} visits tile {t} more than once "
            f"(the dedup invariant — one visit per (row, tile))")
    if num_steps is not None:
        ns = _concrete(num_steps).astype(np.int64)
        if (ns < 0).any() or (ns > shape[1]).any():
            raise ValueError(
                f"{name}: num_steps outside [0, {shape[1]}]")
        cols = np.arange(shape[1])[None, :]
        real = fl != 0
        if (real != (cols < ns[:, None])).any():
            i = int(np.argwhere(
                (real != (cols < ns[:, None])).any(axis=1))[0][0])
            raise ValueError(
                f"{name}: row {i} padding is not right-aligned — real "
                f"steps must be exactly flags[:, :num_steps] nonzero, "
                f"flags[:, num_steps:] zero")
