"""Convert the JAX reference's parameters and engine snapshots into the
port's.

``params_from_jax(tree)`` takes the reference's parameter tree as nested
dicts of **numpy** arrays (``jax.tree.map(np.asarray, params)``) and
returns the port's tree: the same keys and orientations (``(d_in,
d_out)`` weights, so the conversion is a copy), with every stacked segment
``seg{i}_{kind}`` of shape ``(n, ...)`` sliced into a list of ``n``
per-layer dicts. A leaf the port does not consume raises, so a silently
dropped parameter cannot make two models look equal.

``engine_state_from_jax(tree, device)`` takes a reference
``ContinuousEngine.state_dict()`` with numpy leaves and returns the port's
image of it for ``ContinuousEngine.load_state``. It reads the tree by the
checkpoint keys (``slabs::seg0_attn_mlp::.k``, ``slot_pos``, ...; see
:mod:`repro_torch.ft.checkpoint`), the same keys a snapshot written by
``repro.ft.save`` holds on disk, and raises on any leaf it does not
consume.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.serve.paged_cache import PagedSlab
from repro_torch.tree import tree_flatten_with_path

# What the port consumes, per block kind: the leaf names of each dict, or
# the schema of a nested block (griffin's r1/r2/a).
_ATTN = {"ln1": ("scale",), "attn": ("wq", "wk", "wv", "wo"),
         "ln2": ("scale",), "mlp": ("w_in", "w_out", "w_gate")}
_REC = {"ln1": ("scale",),
        "rec": ("w_in", "w_gate_branch", "w_out", "conv_w", "w_a", "w_i",
                "lam"),
        "ln2": ("scale",), "mlp": ("w_in", "w_out", "w_gate")}
_BLOCK_SCHEMA = {
    "attn_mlp": _ATTN,
    "attn_mlp_local": _ATTN,
    "rec_mlp": _REC,
    "ssm": {"ln1": ("scale",),
            "ssm": ("w_in", "w_out", "conv_w", "A_log", "D", "dt_bias",
                    "norm_scale")},
    "griffin": {"r1": _REC, "r2": _REC, "a": _ATTN},
}
_TOP_SCHEMA = {"embed": ("w",), "ln_f": ("scale",), "lm_head": ("w",)}


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
    return {part: (_take(sub[part], names, f"{where}/{part}", index=index,
                         device=device)
                   if isinstance(names, tuple) else
                   _take_block(sub[part], names, f"{where}/{part}", index,
                               device))
            for part, names in schema.items() if part in sub}


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
        kind = key.split("_", 1)[1] if key.startswith("seg") else None
        if kind not in _BLOCK_SCHEMA:
            raise ValueError(f"params_from_jax: unconsumed sub-tree {key!r}")
        out[key] = [_take_block(sub, _BLOCK_SCHEMA[kind], key, i, device)
                    for i in range(_n_layers(sub))]
    return out


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
