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
model-split leaves summed over the model group and those of the
data-split leaves over the data group (one ``all_reduce`` each), the
leaves held whole counted once (a leaf splits over one axis or none).
The update itself is leafwise and needs no collective; :func:`init` of
slices gives sliced moments and master.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

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
    :class:`~repro_torch.dist.sharding.Split`, ``mesh`` the rank's
    :class:`~repro_torch.dist.group.Mesh2D`): the squares of the leaves
    split over an axis are summed over that axis' group (one
    ``all_reduce`` an axis that splits any), the leaves held whole
    counted once."""
    if placements is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in tree_leaves(tree)))
    sq = tree_leaves(tree_map(
        lambda x, s: (torch.sum(torch.square(x.float())), s), tree,
        placements))
    total = zero = torch.zeros((), device=sq[0][0].device)
    for axis in ("model", "data"):
        mine = [x for x, s in sq if getattr(s, axis) is not None]
        if mine:
            total = total + getattr(mesh, axis).psum_(
                sum(mine, zero).reshape(1))[0]
    return torch.sqrt(total + sum((x for x, s in sq if s.whole), zero))


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
