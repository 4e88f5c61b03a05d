"""Convert the JAX reference's parameters and engine snapshots into the
port's.

``params_from_jax(tree)`` takes the reference's parameter tree as nested
dicts of **numpy** arrays (``jax.tree.map(np.asarray, params)``) and
returns the port's tree: the same keys and orientations (``(d_in,
d_out)`` weights, so the conversion is a copy), with every stacked segment
``seg{i}_{kind}`` of shape ``(n, ...)`` sliced into a list of ``n``
per-layer dicts (an encoder-decoder's ``enc`` sub-tree likewise). A leaf
the port does not consume raises, so a silently dropped parameter cannot
make two models look equal.

``checkpoint_from_jax(path, like)`` reads a reference train checkpoint
(``{"params", "opt"}`` written by ``repro.launch.train --ckpt``: stacked
segments, AdamW's m, v, master and step) and returns it in the port's
per-layer layout, shaped and typed as ``like``; ``is_jax_checkpoint``
tells the two layouts apart.

``engine_state_from_jax(tree, device)`` takes a reference
``ContinuousEngine.state_dict()`` with numpy leaves and returns the port's
image of it for ``ContinuousEngine.load_state``. It reads the tree by the
checkpoint keys (``slabs::seg0_attn_mlp::.k``, ``slot_pos``, ...; see
:mod:`repro_torch.ft.checkpoint`), the same keys a snapshot written by
``repro.ft.save`` holds on disk, and raises on any leaf it does not
consume.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.ft.checkpoint import _restore_leaf, latest_step
from repro_torch.serve.paged_cache import PagedSlab
from repro_torch.tree import tree_flatten_with_path, tree_unflatten

# What the port consumes, per block kind: the leaf names of each dict, or
# the schema of a nested block (griffin's r1/r2/a).
_ATTN = {"ln1": ("scale",), "attn": ("wq", "wk", "wv", "wo"),
         "ln2": ("scale",), "mlp": ("w_in", "w_out", "w_gate")}
_REC = {"ln1": ("scale",),
        "rec": ("w_in", "w_gate_branch", "w_out", "conv_w", "w_a", "w_i",
                "lam"),
        "ln2": ("scale",), "mlp": ("w_in", "w_out", "w_gate")}
# a schema entry of None is a leaf of the dict itself (the MoE router and
# expert stacks beside the shared expert's MLP)
_MOE = {"router": None, "w_in": None, "w_gate": None, "w_out": None,
        "shared": ("w_in", "w_out", "w_gate")}
_BLOCK_SCHEMA = {
    "attn_mlp": _ATTN,
    "attn_mlp_local": _ATTN,
    "attn_moe": {"ln1": ("scale",), "attn": _ATTN["attn"],
                 "ln2": ("scale",), "moe": _MOE},
    "attn_moe_dense": dict(_ATTN, moe=_MOE),
    "rec_mlp": _REC,
    "ssm": {"ln1": ("scale",),
            "ssm": ("w_in", "w_out", "conv_w", "A_log", "D", "dt_bias",
                    "norm_scale")},
    "griffin": {"r1": _REC, "r2": _REC, "a": _ATTN},
    "xattn": dict(_ATTN, ln_x=("scale",), xattn=_ATTN["attn"]),
}
_TOP_SCHEMA = {"embed": ("w",), "ln_f": ("scale",), "lm_head": ("w",),
               "vision_proj": ("w",)}
# whisper's encoder: one stacked attn_mlp segment and its final norm
_ENC_KEYS = {"seg0_attn_mlp", "ln_f"}


def _tensor(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes bf16: reinterpret bits
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _take(d: Dict[str, Any], names, where: str, index=None, device="cpu"):
    """Consume the leaves ``names`` (those present) of dict ``d``; raise if
    anything else is left."""
    extra = set(d) - set(names)
    if extra:
        raise ValueError(f"params_from_jax: unconsumed leaves under {where}: "
                         f"{sorted(extra)}")
    out = {}
    for n in names:
        if n in d:
            a = d[n] if index is None else d[n][index]
            out[n] = _tensor(a, device)
    return out


def _take_block(sub: Dict[str, Any], schema, where: str, index: int,
                device) -> Dict[str, Any]:
    """Layer ``index`` of a stacked block sub-tree, by its schema; raise on
    any part or leaf the schema does not name."""
    extra = set(sub) - set(schema)
    if extra:
        raise ValueError(f"params_from_jax: unconsumed leaves under "
                         f"{where}: {sorted(extra)}")
    out = {}
    for part, names in schema.items():
        if part not in sub:
            continue
        if names is None:
            out[part] = _tensor(sub[part][index], device)
        elif isinstance(names, tuple):
            out[part] = _take(sub[part], names, f"{where}/{part}",
                              index=index, device=device)
        else:
            out[part] = _take_block(sub[part], names, f"{where}/{part}",
                                    index, device)
    return out


def _n_layers(sub) -> int:
    """The leading (layer) axis of a stacked sub-tree: any leaf's."""
    while isinstance(sub, dict):
        sub = next(iter(sub.values()))
    return int(np.shape(sub)[0])


def params_from_jax(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The port's parameters from the reference's (numpy leaves)."""
    out: Dict[str, Any] = {}
    for key, sub in tree.items():
        if key in _TOP_SCHEMA:
            out[key] = _take(sub, _TOP_SCHEMA[key], key, device=device)
            continue
        if key == "enc":
            extra = set(sub) - _ENC_KEYS
            if extra:
                raise ValueError(f"params_from_jax: unconsumed leaves under "
                                 f"enc: {sorted(extra)}")
            out[key] = params_from_jax(sub, device)
            continue
        kind = key.split("_", 1)[1] if key.startswith("seg") else None
        if kind not in _BLOCK_SCHEMA:
            raise ValueError(f"params_from_jax: unconsumed sub-tree {key!r}")
        out[key] = [_take_block(sub, _BLOCK_SCHEMA[kind], key, i, device)
                    for i in range(_n_layers(sub))]
    return out


def _stacked_key(key: str):
    """(the reference's checkpoint key, layer index) of a port key: a
    segment leaf's layer index dropped (``params::seg0_attn_mlp::3::attn::
    wq`` -> (``params::seg0_attn_mlp::attn::wq``, 3), row 3 of the stacked
    array); (key, None) for a leaf outside the segments."""
    parts = key.split("::")
    for i, part in enumerate(parts[:-1]):
        if part.startswith("seg") and parts[i + 1].isdigit():
            return "::".join(parts[:i + 1] + parts[i + 2:]), int(parts[i + 1])
    return key, None


def is_jax_checkpoint(path, step=None) -> bool:
    """True when the checkpoint at ``path`` (its latest step by default)
    holds the reference's stacked segments: a ``seg*`` key followed
    directly by a leaf name, where the port's keys have a layer index."""
    step = latest_step(path) if step is None else step
    with open(os.path.join(os.fspath(path), f"step_{step:08d}",
                           "meta.json")) as f:
        keys = json.load(f)["keys"]
    return any(_stacked_key(k)[1] is None and any(
        p.startswith("seg") for p in k.split("::")[:-1]) for k in keys)


def checkpoint_from_jax(path, like: Any, step=None):
    """Restore a reference checkpoint (stacked segments) at ``path`` into
    the structure of ``like``, the port's per-layer tree (its dtypes and
    devices): layer ``i`` of a segment leaf is row ``i`` of the
    reference's stacked array, for the parameters and every part of the
    optimizer state alike. Raises unless the checkpoint holds exactly the
    keys and stacked depths ``like`` takes. Returns (tree, step)."""
    path = os.fspath(path)
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    flat, treedef = tree_flatten_with_path(like)
    with np.load(os.path.join(path, f"step_{step:08d}",
                              "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    leaves, rows = [], {}
    for p, leaf in flat:
        key = "::".join(p)
        src, i = _stacked_key(key)
        if src not in arrays:
            raise ValueError(f"checkpoint_from_jax: {src!r} (for {key!r}) "
                             f"is not in the checkpoint")
        rows.setdefault(src, set()).add(i)
        arr = arrays[src]
        if i is not None and i >= arr.shape[0]:
            raise ValueError(f"checkpoint_from_jax: {key!r} is past the "
                             f"{arr.shape[0]} layers of {src!r}")
        leaves.append(_restore_leaf(arr if i is None else arr[i], leaf))
    extra = sorted(set(arrays) - set(rows))
    if extra:
        raise ValueError(f"checkpoint_from_jax: unconsumed keys {extra}")
    for src, r in rows.items():
        n = arrays[src].shape[0] if None not in r else None
        if n is not None and r != set(range(n)):
            raise ValueError(f"checkpoint_from_jax: {src!r} stacks {n} "
                             f"layers, the port's tree takes {sorted(r)}")
    return tree_unflatten(treedef, leaves), step


# The host leaves of an engine snapshot and their dtypes.
_ENGINE_HOST = {"page_tables": np.int32, "page_hist": np.float64,
                "control": np.uint8}


def engine_state_from_jax(tree: Dict[str, Any], device="cuda"
                          ) -> Dict[str, Any]:
    """The port's engine image of a reference engine snapshot (numpy
    leaves): slabs and slot map as tensors on ``device``, the host leaves
    as numpy arrays."""
    flat, _ = tree_flatten_with_path(tree)
    leaves = {"::".join(path): a for path, a in flat}
    out: Dict[str, Any] = {
        name: np.asarray(leaves.pop(name), dt).copy()
        for name, dt in _ENGINE_HOST.items()}
    out["slot_pos"] = _tensor(leaves.pop("slot_pos"), device)
    fields = {f: "." + f for f in PagedSlab._fields}
    out["slabs"] = {}
    for seg in tree["slabs"]:
        part = {f: leaves.pop(f"slabs::{seg}::{k}", None)
                for f, k in fields.items()}
        out["slabs"][seg] = PagedSlab(**{
            f: None if a is None else _tensor(a, device)
            for f, a in part.items()})
    if leaves:
        raise ValueError(f"engine_state_from_jax: unconsumed leaves "
                         f"{sorted(leaves)}")
    return out
