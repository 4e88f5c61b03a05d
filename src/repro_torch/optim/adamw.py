"""AdamW with dtype-configurable moments, as plain functions on tensors.

The port of :mod:`repro.optim.adamw`. Not ``torch.optim.AdamW``: its
decoupled decay rounds differently from this update's
``p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)``. Gradients are clipped
by their global norm. ``moment_dtype`` sets the moments' storage type and
``use_master`` keeps an f32 copy of low-precision parameters. The update
is functional (new tensors), as in the reference.

Under tensor parallelism a rank holds slices of the split leaves, and
under the FSDP fallback slices of the leaves it splits over the data
group; the global norm is then the whole model's: the squares of the
model-split leaves summed over the model group (one ``all_reduce``) and
those of the data-split leaves gathered over the data group (one
``all_gather``), the leaves held whole counted once (a leaf splits over
one axis or none).
The update itself is leafwise and needs no collective; :func:`init` of
slices gives sliced moments and master.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.dist.sharding import Split, fsdp_dim
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    # master fp32 copy of bf16 params (False = update in param dtype)
    use_master: bool = False


class AdamWState(NamedTuple):
    step: int       # host-side step count
    m: Any
    v: Any
    master: Any     # fp32 params or None


def init(cfg: AdamWConfig, params) -> AdamWState:
    mdt = getattr(torch, cfg.moment_dtype)
    master = (tree_map(lambda p: p.detach().float().clone(), params)
              if cfg.use_master else None)
    return AdamWState(
        step=0, m=tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params),
        v=tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params),
        master=master)


def global_norm(tree, placements=None, mesh=None) -> torch.Tensor:
    """The L2 norm of every leaf of ``tree``. ``placements``/``mesh``: a
    split rank's slices (``placements`` a tree of
    :class:`~repro_torch.dist.sharding.Split`, or None for whole leaves;
    ``mesh`` the rank's :class:`~repro_torch.dist.group.Mesh2D`).

    The squares of the leaves split over the model group are summed over
    it (one ``all_reduce``). Over a data group of ``n`` ranks each leaf
    the FSDP fallback splits (:func:`~repro_torch.dist.sharding.fsdp_dim`)
    has its squares summed in its ``n`` chunks along that dim, the chunks'
    sums added in rank order: a rank's slices' sums cross in one
    ``all_gather``, and a leaf held whole is cut into the same chunks
    here. So the norm is the same number bit for bit whether the data
    group splits those leaves or not (an FSDP step's update is the plain
    data-parallel step's slice)."""
    leaves = tree_leaves(tree)
    splits = [Split()] * len(leaves) if placements is None else [
        s for _, s in tree_leaves(tree_map(lambda x, s: (x, s), tree,
                                           placements))]
    data = None if mesh is None else mesh.data
    n = 1 if data is None else data.size
    sq = lambda x: torch.sum(torch.square(x.float()))  # noqa: E731
    mine = [sq(x) for x, s in zip(leaves, splits) if s.data is not None]
    gathered = iter(data.all_gather(torch.stack(mine)).unbind(1)) \
        if mine else None
    model_part = rest = torch.zeros((), device=leaves[0].device)
    for x, s in zip(leaves, splits):
        if s.data is not None:
            parts = next(gathered)
        elif s.model is None and fsdp_dim(x.shape, n) is not None:
            parts = [sq(c.contiguous())
                     for c in x.chunk(n, fsdp_dim(x.shape, n))]
        else:
            parts = [sq(x)]
        v = parts[0]
        for p in parts[1:]:
            v = v + p
        if s.model is not None:
            model_part = model_part + v
        else:
            rest = rest + v
    if any(s.model is not None for s in splits):
        model_part = mesh.model.psum_(model_part.reshape(1))[0]
    return torch.sqrt(model_part + rest)


def clip_by_global_norm(grads, max_norm: float, placements=None,
                        mesh=None):
    norm = global_norm(grads, placements, mesh)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


@torch.no_grad()
def update(cfg: AdamWConfig, state: AdamWState, params, grads,
           lr_scale: float = 1.0, placements=None, mesh=None):
    """One AdamW step. Returns (new_params, new_state, metrics).
    ``placements``/``mesh``: a split rank's slices (:func:`global_norm`)."""
    grads = tree_map(lambda g: g.float(), grads)
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip,
                                           placements, mesh)
    else:
        gnorm = global_norm(grads, placements, mesh)
    step = state.step + 1
    b1c = 1.0 - cfg.b1 ** step
    b2c = 1.0 - cfg.b2 ** step
    lr = cfg.lr * lr_scale
    base = state.master if cfg.use_master else params

    def upd(p, g, m, v):
        mf = m.float() * cfg.b1 + g * (1 - cfg.b1)
        vf = v.float() * cfg.b2 + g * g * (1 - cfg.b2)
        mhat = mf / b1c
        vhat = vf / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p.float()
        return p.float() - lr * delta, mf.to(m.dtype), vf.to(v.dtype)

    res = [upd(*leaf) for leaf in zip(*(tree_leaves(t) for t in
                                        (base, grads, state.m, state.v)))]

    def unflatten(i):
        it = iter(r[i] for r in res)
        return tree_map(lambda _: next(it), base)

    new_base, new_m, new_v = (unflatten(i) for i in range(3))
    new_params = tree_map(lambda nb, p: nb.to(p.dtype), new_base, params)
    new_state = AdamWState(step=step, m=new_m, v=new_v,
                           master=new_base if cfg.use_master else None)
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
