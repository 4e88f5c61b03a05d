"""Placements over the ``(data, model)`` mesh: the port's copy of the
reference's logical-axis rules for the "model" mesh axis, and of its FSDP
fallback over the "data" axis.

The reference (``repro.dist.sharding``) names a logical axis for every dim
of a parameter by matching its tree path against :data:`PARAM_RULES`
(:func:`logical_axes_for`), maps the logical axes onto mesh axes through
:data:`DEFAULT_RULES`, and drops a mesh axis where it does not divide the
dim or was used by an earlier dim (``_mesh_clean``); the launcher's
``cell_rules`` first replicates ``kv_heads``, ``heads`` and ``vocab`` when
their count does not divide the model axis. The port holds the same rules
without JAX and answers one question per leaf: the dim it splits on over a
model group of ``n`` ranks, or ``None`` (replicated).

One difference, on purpose. The reference stacks a segment's layers on a
leading axis, so a dense MLP's ``w_in`` is ``(L, d, f)``; being 3-D with a
``w_`` name, :func:`logical_axes_for` labels that leading axis
``experts``, which maps onto "model" first, and the MLP splits over its
layers where ``L`` divides ``n`` (ffn stays whole). The port's layers are
list nodes, so a dense ``w_in`` is the 2-D ``(d, f)`` and the rules split
it over ffn, the placement :data:`PARAM_RULES` states for it.

The same holds for an MoE layer's expert stacks. The reference's are 4-D
``(L, E, d, f)`` (layers stacked), which :func:`logical_axes_for` labels
``(None, None, 'embed', 'ffn')``: it *stores* them split over ffn, though
its dispatch *computes* them split over experts (``moe_apply`` constrains
the buffer to ``"experts"``). The port's per-layer stack is the 3-D
``(E, d, f)``, labelled ``('experts', 'embed', 'ffn')``, so it splits over
experts: the placement the reference computes in. The router ``(d, E)``
splits over its expert columns in both. Where the group does not divide
E, ``_mesh_clean`` drops the experts axis: the stacks split over ffn
where the group divides ``d_ff_expert`` and stay whole otherwise, and the
router stays whole (``models/moe.expert_split``). Each leaf's split is
judged on that leaf's own dim (``_mesh_clean``'s divisibility rule): an
ffn dim is
``d_ff`` wide in a dense MLP, ``d_ff_expert`` in an expert stack,
``d_ff_expert · n_shared_experts`` in a shared expert, ``d_rnn`` in an
RG-LRU block and ``2 d_inner + 2 N + H`` (``w_in``) or ``d_inner``
(``w_out``) in an SSD block, so a group that divides one and not another
splits the one alone.

A block whose products split while some of its leaves stay whole (an
RG-LRU block's ``conv_w``, ``w_a``, ``w_i``, ``lam``; an SSD block's
``conv_w``, ``A_log``, ``D``, ``dt_bias``, ``norm_scale``) uses on each
rank only its part of those leaves, so a rank's gradient of them is its
share: :class:`Split` marks them ``model_sum`` and the trainer sums
their gradients over the model group.

The FSDP fallback (the reference's ``param_shardings``, ``"fsdp": ("data",)``
in :data:`DEFAULT_RULES`): a leaf that no model rule splits and that has at
least 2 dims splits its largest dim (the first on a tie) over the data
group, where the group's size divides that dim; otherwise it stays whole
(:func:`mesh_placements`). Each leaf is judged on its own per-layer shape,
so two kinds of leaf differ from the reference's stacked tree: the 1-D
per-layer leaves (norm scales, biases, the RG-LRU's ``lam``, the SSD's
``A_log``/``D``/``dt_bias``) are ``(L, d)`` or ``(L, heads)`` there, 2-D,
and split (on ``d``, or on the layer axis for mamba2-370m's ``(48, 32)``
leaves); the port's are 1-D and stay whole. A leaf's split is over one
mesh axis or none, never both.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, FrozenSet, Optional, Tuple

from repro_torch.tree import (tree_flatten_with_path, tree_leaves,
                              tree_map, tree_unflatten)

MODEL = "model"
DATA = "data"

# logical axis -> mesh axes, as the reference's production meshes map them
DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "cache_seq": None,
    "embed": None,
    "ffn": (MODEL,),
    "heads": (MODEL,),
    "kv_heads": (MODEL,),
    "head_dim": None,
    "vocab": (MODEL,),
    "experts": (MODEL,),
    "expert_cap": None,
    "fsdp": (DATA,),
}

# path regex over '/'-joined tree keys -> logical axis per dim; the first
# match wins, an unmatched leaf is replicated
PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"(^|/)(embed|lm_head)/w$", ("vocab", "embed")),
    (r"(^|/)wq$", ("embed", "heads")),
    (r"(^|/)w[kv]$", ("embed", "kv_heads")),
    (r"(^|/)wo$", ("heads", "embed")),
    (r"(^|/)(w_in|w_gate|w_gate_branch)$", ("embed", "ffn")),
    (r"(^|/)w_out$", ("ffn", "embed")),
    (r"(^|/)router$", ("embed", "experts")),
    (r"(^|/)(scale|bias)$", (None,)),
)


def logical_axes_for(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    """The logical axis of each of a leaf's ``ndim`` dims, from its path
    (the reference's function, rule for rule)."""
    for pat, axes in PARAM_RULES:
        if re.search(pat, path):
            # leading (stacked-layer / expert) dims stay unsharded unless
            # the leaf is the expert-stationary 3-D tensor
            if ndim == len(axes) + 1:
                lead = ("experts",) if "w_" in path.rsplit("/", 1)[-1] \
                    and ndim == 3 else (None,)
                return lead + axes
            if ndim >= len(axes):
                return (None,) * (ndim - len(axes)) + axes
            return axes[:ndim]
    return (None,) * ndim


def _counts(cfg, ffn: Optional[int] = None) -> Dict[str, int]:
    """The size of each logical axis a block's leaves split on; ``ffn``:
    the ffn width of the leaf at hand (``d_ff`` by default)."""
    c = {"heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
         "ffn": cfg.d_ff if ffn is None else ffn, "vocab": cfg.vocab_size}
    if cfg.moe is not None:
        c["experts"] = cfg.moe.n_experts
    return c


def ffn_width(cfg, path: str) -> int:
    """The whole ffn width of the leaf at ``path``: a shared expert's
    ``d_ff_expert · n_shared_experts``, an expert stack's
    ``d_ff_expert``, an RG-LRU block's ``d_rnn``, an SSD block's ``2
    d_inner + 2 N + H`` (``w_in``) or ``d_inner`` (``w_out``), else
    ``d_ff``: the size of the leaf's ffn dim in ``Model.param_shapes()``.
    From the config, so a tree of a rank's slices is placed as the whole
    tree it was cut from."""
    if cfg.moe is not None and re.search(r"(^|/)moe/", path):
        m = cfg.moe
        if re.search(r"(^|/)moe/shared/", path):
            return m.d_ff_expert * m.n_shared_experts
        return m.d_ff_expert
    if re.search(r"(^|/)rec/", path):
        return cfg.recurrent.d_rnn or cfg.d_model
    if re.search(r"(^|/)ssm/", path):
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        if path.endswith("/w_in") or path == "w_in":
            return 2 * d_inner + 2 * s.d_state + d_inner // s.head_dim
        return d_inner
    return cfg.d_ff


def split_axes(cfg, n: int, ffn: Optional[int] = None) -> FrozenSet[str]:
    """The logical axes of ``cfg`` that split over a model group of ``n``
    ranks: the reference's ``cell_rules`` replicate ``kv_heads``,
    ``heads`` and ``vocab`` when the count does not divide ``n``, and
    ``_mesh_clean`` keeps a dim whole when ``n`` does not divide it (the
    ffn dim is ``ffn``, ``d_ff`` by default: :func:`ffn_width`; the
    experts dim is ``n_experts``). A query head count that ``n`` divides
    while the KV head count does not leaves ``wk``/``wv`` replicated."""
    if n <= 1:
        return frozenset()
    return frozenset(a for a, c in _counts(cfg, ffn).items() if c % n == 0)


def is_expert_stack(path: str) -> bool:
    """Whether the leaf at ``path`` is an MoE layer's expert stack
    (``moe/w_in``, ``moe/w_gate`` or ``moe/w_out``: the port's 3-D
    ``(E, d, f)`` / ``(E, f, d)``, split on its experts dim where the
    group divides E, else on its ffn dim or not at all)."""
    return re.search(r"(^|/)moe/w_(in|gate|out)$", path) is not None


def leaf_placement(path: str, ndim: int, cfg, n: int) -> Optional[int]:
    """The dim of the leaf at ``path`` (``'/'``-joined, the port's per-layer
    path: no stacked layer axis) that splits over ``n`` ranks, or None:
    each dim judged on the leaf's own size, as ``_mesh_clean`` judges it
    (its ffn dim on :func:`ffn_width`)."""
    split = split_axes(cfg, n, ffn_width(cfg, path))
    for i, axis in enumerate(logical_axes_for(path, ndim)):
        if axis in split and DEFAULT_RULES.get(axis) == (MODEL,):
            return i        # a mesh axis shards at most one dim
    return None


@dataclasses.dataclass(frozen=True)
class Split:
    """One leaf's placement on the ``(data, model)`` mesh: the dim it
    splits on over the data group (the FSDP fallback) and over the model
    group, each ``None`` where the leaf is whole on that axis. A leaf
    splits over one axis or none. ``model_sum``: the leaf is whole over
    the model group but each rank uses only its part of it (a recurrent
    block whose ``w_out`` the group splits: :func:`mesh_placements`), so
    a rank's gradient of it is its share, to be summed over the model
    group. A leaf of every tree walk."""
    data: Optional[int] = None
    model: Optional[int] = None
    model_sum: bool = False

    @property
    def whole(self) -> bool:
        return self.data is None and self.model is None


# the recurrent blocks whose whole leaves feed a rank's slice of the work
# where their ``w_out`` splits (``Split.model_sum``)
_SUMMED_BLOCKS = ("rec", "ssm")


def fsdp_dim(shape, data: int) -> Optional[int]:
    """The reference's FSDP fallback for one leaf that no model rule
    splits: its largest dim (the first on a tie) where the ``data`` ranks
    divide it, for a leaf of at least 2 dims; else None."""
    if data <= 1 or len(shape) < 2:
        return None
    dim = max(range(len(shape)), key=lambda i: shape[i])
    return dim if shape[dim] % data == 0 else None


def mesh_placements(params, cfg, data: int = 1, model: int = 1,
                    prefix: Tuple[str, ...] = (), experts_cut: bool = False):
    """For each leaf of ``params`` (the port's per-layer tree) its
    :class:`Split` on a mesh of ``data`` x ``model`` ranks; the same tree
    structure. The model dim is the reference's rules on the leaf's path
    and ``dim()`` (sizes from the config: :func:`leaf_placement`, so
    ``params`` may hold a rank's slices). A leaf
    the model group leaves whole takes the FSDP fallback's data dim
    (:func:`fsdp_dim`, on its shape: so ``params`` holds whole leaves,
    e.g. ``Model.param_shapes()``; ``data`` 1 is no FSDP). ``prefix``:
    the path of ``params`` inside the whole tree. ``experts_cut``: the
    expert stacks of ``params`` hold this rank's experts only (drawn so
    by ``Model.init(span=)``), so they are not cut again: model ``None``,
    and no data split. The whole leaves of an RG-LRU or SSD block
    (``rec/``, ``ssm/``) whose ``w_out`` splits are marked ``model_sum``
    (so ``params`` holds whole blocks, as a layer of ``Model.init``)."""
    flat, treedef = tree_flatten_with_path(params)
    paths = ["/".join(prefix + p) for p, _ in flat]
    dims = {}
    for path, (_, leaf) in zip(paths, flat):
        dims[path] = None if experts_cut and is_expert_stack(path) else \
            leaf_placement(path, leaf.dim(), cfg, model)
    out = []
    for path, (_, leaf) in zip(paths, flat):
        if dims[path] is not None:
            out.append(Split(model=dims[path]))
            continue
        block = path.rsplit("/", 1)[0]
        summed = block.rsplit("/", 1)[-1] in _SUMMED_BLOCKS and \
            dims.get(block + "/w_out") is not None
        out.append(Split(data=None if experts_cut and is_expert_stack(path)
                         else fsdp_dim(tuple(leaf.shape), data),
                         model_sum=summed))
    return tree_unflatten(treedef, out)


def describe(params, placements) -> str:
    """One entry per distinct leaf path of ``params`` (the layer index as
    ``*``) with its :class:`Split` from ``placements``: what a run prints
    once."""
    seen: Dict[str, str] = {}
    flat, _ = tree_flatten_with_path(params)
    for (path, _), s in zip(flat, tree_leaves(
            tree_map(lambda _, s: s, params, placements))):  # params' order
        key = "/".join("*" if p.isdigit() else p for p in path)
        where = ("whole" if s.whole else f"split dim {s.model} over {MODEL}"
                 if s.model is not None else f"split dim {s.data} over {DATA}")
        seen.setdefault(key, where + (f", gradient summed over {MODEL}"
                                      if s.model_sum else ""))
    return "; ".join(f"{k}: {w}" for k, w in seen.items())
