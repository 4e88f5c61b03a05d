"""Checkpointing: atomic, keep-k, async.

The port of :mod:`repro.ft.checkpoint`, with the
reference's on-disk layout, so a checkpoint written by either package
restores in the other:

  * ``<dir>/step_%08d/arrays.npz`` holds one array per leaf, keyed by the
    leaf's path joined with ``::`` (``params::layers::0::w``,
    ``opt::.m::w``, ``opt::.step``; see :func:`repro_torch.tree
    .tree_flatten_with_path`), and ``meta.json`` the step and the sorted
    keys.
  * **Atomic**: written to ``<dir>/tmp.<step>.<pid>`` and then renamed, so
    a writer killed halfway never corrupts the latest checkpoint; orphaned
    tmp dirs are swept (:func:`sweep_stale_tmp`).
  * **Keep-k GC** bounds the disk under frequent checkpoints.
  * **Async** (:class:`CheckpointManager`): the device-to-host copy is
    synchronous, on the caller's thread, so what is written is the state
    at the call even though the serving engine updates its slabs in place
    afterwards; only the serialization runs on a background thread.

Leaves: tensors (bf16 is written as f32, which numpy can hold, as the
reference writes its ml_dtypes leaves; every other dtype as itself), numpy
arrays, and Python ``int``s (``AdamWState.step``), written as 0-d int32 as
JAX writes its step. :func:`restore` takes dtype and device from the
``like`` tree, leaf by leaf, and never its shapes: the engine snapshot's
``control`` leaf is a byte blob whose length follows the queue. A tensor
leaf is restored onto its ``like`` leaf's device, an ``int`` comes back as
an ``int``.

``restore(..., shardings=)`` places the leaves onto another layout (the
reference's elastic rescale): one placement for the whole tree, or a tree
of placements matched to the leaves by path (:func:`placements`). A
placement is a device (a data-parallel state is replicated; a checkpoint
written by rank 0 of an n-rank data-parallel run restores on any rank
count), or the leaf's placement on each axis of the ``(data, model)``
mesh, ``torch.distributed.tensor``'s idiom: a tuple ``(data, model)``
of ``Shard(dim)`` / ``Replicate()``
(:func:`repro_torch.train.trainer.state_shardings`). ``Shard(dim)`` on
the model axis splits the leaf along ``dim`` over the ranks of a
``model_group`` (:class:`~repro_torch.dist.group.ModelGroup`, tensor
parallelism; an MoE layer's expert stacks are ``Shard(0)`` and its
router ``Shard(1)`` where the group divides the experts), on the data
axis over a ``data_group`` (the FSDP
fallback); this rank keeps its contiguous slice. ``save(...,
shardings=, model_group=, data_group=)`` of such a state gathers each
split leaf over its group first, and the rank that is 0 in both groups
writes the whole leaf, so the file is the single-device checkpoint of
the same state, byte for byte, and restores onto any layout (and in the
reference). A ``Shard`` without its group raises.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import tree_flatten_with_path, tree_unflatten

_SEP = "::"
_TMP_RE = re.compile(r"tmp\.(\d+)\.(\d+)")


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    except OSError:
        return False
    return True


def sweep_stale_tmp(path) -> int:
    """Remove orphaned ``tmp.<step>.<pid>`` dirs (a writer killed between
    ``makedirs`` and the atomic rename leaks its tmp dir).

    A tmp dir is stale when its writer pid is dead, or is THIS process
    (writes within a process are serialized: :meth:`CheckpointManager.save`
    joins the previous writer thread, so a same-pid tmp can only be an
    abandoned earlier attempt). Returns the number of dirs removed; called
    from :func:`save` before each write and from the keep-k GC."""
    removed = 0
    if not os.path.isdir(path):
        return removed
    for d in os.listdir(path):
        m = _TMP_RE.fullmatch(d)
        if m and (int(m.group(2)) == os.getpid()
                  or not _pid_alive(int(m.group(2)))):
            shutil.rmtree(os.path.join(path, d), ignore_errors=True)
            removed += 1
    return removed


def _host(leaf):
    """A host copy of one leaf, taken now: tensors to (cloned) CPU
    tensors, arrays copied, ints kept."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, np.ndarray):
        return leaf.copy()
    if isinstance(leaf, (int, np.integer)) and not isinstance(leaf, bool):
        return int(leaf)
    raise TypeError(f"checkpoint: unsupported leaf type {type(leaf)}")


def _array(leaf) -> np.ndarray:
    """The array written for one leaf (bf16 upcast to f32)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _flatten(tree) -> dict:
    """``{key: np.ndarray}`` of a tree, keyed as the reference keys it."""
    flat, _ = tree_flatten_with_path(tree)
    return {_SEP.join(path): _array(leaf) for path, leaf in flat}


def _splits(where, model_group, data_group):
    """The ``(group, dim)`` splits of one placement: each ``Shard`` of a
    ``(data, model)`` tuple over its axis' group; none for a device or
    ``None``."""
    from torch.distributed.tensor import Shard

    if not isinstance(where, tuple):
        return []
    pairs = [(g, w, name) for g, w, name in zip(
        (data_group, model_group), where, ("data_group", "model_group"))
        if isinstance(w, Shard)]
    for g, w, name in pairs:
        if g is None:
            raise ValueError(f"placement {w} splits a leaf over the ranks "
                             f"of a group: pass {name}=")
    return [(g, w.dim) for g, w, _ in pairs]


def gather_tree(tree: Any, shardings: Any, model_group,
                data_group=None) -> Any:
    """The whole leaves of a split rank's ``tree``: each leaf whose
    ``(data, model)`` placement in ``shardings`` (:func:`placements`) has
    a ``Shard(dim)`` on an axis is gathered over that axis' group (one
    ``all_gather``, joined in rank order along ``dim``); every other leaf
    is kept. Every rank of the groups calls it."""
    flat, treedef = tree_flatten_with_path(tree)
    where = placements(shardings, [p for p, _ in flat])
    out = []
    for (_, x), w in zip(flat, where):
        for g, dim in _splits(w, model_group, data_group):
            x = g.unshard(x, dim)
        out.append(x)
    return tree_unflatten(treedef, out)


def _to_write(tree: Any, shardings: Any, model_group,
              data_group=None) -> Any:
    """What this rank writes of ``tree``: the tree itself, or under
    ``shardings`` its whole leaves (:func:`gather_tree`) on the rank that
    is 0 in both groups and None on the other ranks."""
    if shardings is None:
        return tree
    tree = gather_tree(tree, shardings, model_group, data_group)
    lead = all(g is None or g.index == 0 for g in (model_group, data_group))
    return tree if lead else None


def save(path, tree: Any, step: int, shardings: Any = None,
         model_group=None, data_group=None) -> Optional[str]:
    """Atomic checkpoint write. Returns the final directory.

    ``shardings``/``model_group``/``data_group``: ``tree`` is a split
    rank's (:func:`gather_tree`); every rank of the groups calls
    ``save``, the split leaves are gathered, and the rank that is 0 in
    both groups alone writes (the others return None)."""
    tree = _to_write(tree, shardings, model_group, data_group)
    if tree is None:
        return None
    path = os.fspath(path)
    final = os.path.join(path, f"step_{step:08d}")
    sweep_stale_tmp(path)
    tmp = os.path.join(path, f"tmp.{step}.{os.getpid()}")
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    meta = {"step": step, "keys": sorted(flat.keys())}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(path) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for d in os.listdir(path)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


class _OnMesh:
    """A ``(data, model)`` placement tuple held as one leaf of a
    shardings tree (whose walk would take a tuple for a node)."""

    def __init__(self, axes):
        self.axes = tuple(axes)


def _mesh_leaves(tree):
    """``tree`` with every tuple of ``torch.distributed.tensor``
    placements wrapped as one leaf (:class:`_OnMesh`)."""
    from torch.distributed.tensor import Placement

    if isinstance(tree, dict):
        return {k: _mesh_leaves(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_mesh_leaves(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        if tree and all(isinstance(p, Placement) for p in tree):
            return _OnMesh(tree)
        return type(tree)(_mesh_leaves(v) for v in tree)
    return tree


def _placement(placement):
    """One placement: ``None`` (stay where the leaf is), a
    ``torch.device``, a device string (as a device), or a ``(data,
    model)`` tuple of ``Shard`` / ``Replicate`` (returned as the tuple)."""
    if placement is None or isinstance(placement, torch.device):
        return placement
    if isinstance(placement, str):
        return torch.device(placement)
    from torch.distributed.tensor import Replicate, Shard
    if isinstance(placement, _OnMesh) and len(placement.axes) == 2 and all(
            isinstance(p, (Shard, Replicate)) for p in placement.axes):
        return placement.axes
    raise TypeError(f"a placement is a device, a device string, a (data, "
                    f"model) tuple of Shard / Replicate or None, got "
                    f"{getattr(placement, 'axes', placement)!r}")


def placements(shardings, paths) -> list:
    """The placement of each leaf at ``paths`` (``None``: stay where it
    is; a device; or a ``(data, model)`` tuple):
    ``shardings`` is one placement for every leaf, or a tree of them
    whose placement at a node holds for every leaf under it (a prefix
    tree, as a JAX sharding tree may be); a leaf no node covers stays
    where it is."""
    flat, _ = tree_flatten_with_path(_mesh_leaves(shardings))
    by_path = {p: _placement(s) for p, s in flat}
    out = []
    for path in paths:
        cover = [path[:i] for i in range(len(path), -1, -1)
                 if path[:i] in by_path]
        out.append(by_path[cover[0]] if cover else None)
    return out


def _slice(x, where, model_group, data_group=None):
    """This rank's slice of the whole leaf ``x`` under a ``(data,
    model)`` placement that splits it (a copy), else ``x``."""
    for g, dim in _splits(where, model_group, data_group):
        x = g.shard(x, dim)
    return x


def _restore_leaf(arr: np.ndarray, like, where=None, model_group=None,
                  data_group=None):
    """One leaf from its array, as the ``like`` leaf: a tensor of its
    dtype on its device (or on the device ``where``; under a split
    placement this rank's slice), an array of its dtype, or an ``int``."""
    if isinstance(like, torch.Tensor):
        x = _slice(torch.from_numpy(np.ascontiguousarray(arr)), where,
                   model_group, data_group)
        return x.to(device=where if isinstance(where, torch.device)
                    else like.device, dtype=like.dtype)
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype)
    if isinstance(like, (int, np.integer)) and not isinstance(like, bool):
        return int(arr)
    raise TypeError(f"restore: unsupported leaf type {type(like)}")


def restore(path, like: Any, step: Optional[int] = None,
            shardings: Any = None, model_group=None,
            data_group=None) -> Any:
    """Restore into the structure of ``like`` (its dtypes and devices; not
    its shapes). ``step`` defaults to the latest. ``shardings``: where the
    tensor leaves go instead of their ``like`` leaf's device — one
    placement, or a tree of them (:func:`placements`); under a ``(data,
    model)`` tuple with a ``Shard`` the whole leaf is read and this rank
    keeps its slice on each split axis (``data_group``,
    ``model_group``)."""
    path = os.fspath(path)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    flat_like, treedef = tree_flatten_with_path(like)
    keys = [_SEP.join(p) for p, _ in flat_like]
    where = placements(shardings, [p for p, _ in flat_like])
    with np.load(os.path.join(d, "arrays.npz")) as data:
        missing = set(keys) - set(data.files)
        if missing:
            raise ValueError(
                f"checkpoint missing keys: {sorted(missing)[:5]}...")
        leaves = [_restore_leaf(data[k], leaf, w, model_group, data_group)
                  for k, (_, leaf), w in zip(keys, flat_like, where)]
    return tree_unflatten(treedef, leaves)


class CheckpointManager:
    """keep-k GC + async background writes + restart bookkeeping."""

    def __init__(self, path, keep: int = 3, async_write: bool = True):
        self.path = os.fspath(path)
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.write_s: Optional[float] = None   # the last write's seconds
        os.makedirs(self.path, exist_ok=True)

    def _gc(self):
        sweep_stale_tmp(self.path)
        steps = sorted(int(m.group(1)) for d in os.listdir(self.path)
                       if (m := re.fullmatch(r"step_(\d+)", d)))
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self):
        """Join the background writer; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def writing(self) -> bool:
        """True while a background write is still running."""
        return self._thread is not None and self._thread.is_alive()

    def save(self, tree: Any, step: int, shardings: Any = None,
             model_group=None, data_group=None):
        """Snapshot ``tree`` now and write it (in the background when
        async). ``shardings``/``model_group``/``data_group``: a split
        rank's tree (:func:`gather_tree`); every rank of the groups calls
        ``save``, and the rank that is 0 in both alone writes."""
        self.wait()
        tree = _to_write(tree, shardings, model_group, data_group)
        if tree is None:
            return
        # Synchronous device->host snapshot (consistent view), async write.
        flat, treedef = tree_flatten_with_path(tree)
        host_tree = tree_unflatten(treedef, [_host(x) for _, x in flat])

        def work():
            t0 = time.perf_counter()
            save(self.path, host_tree, step)
            self._gc()
            self.write_s = time.perf_counter() - t0

        if not self.async_write:
            work()
            return

        def run():
            try:
                work()
            except BaseException as e:   # handed to the caller by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def restore_latest(self, like: Any, shardings: Any = None,
                       model_group=None, data_group=None):
        self.wait()
        step = latest_step(self.path)
        if step is None:
            return None, None
        return restore(self.path, like, step, shardings, model_group,
                       data_group), step
