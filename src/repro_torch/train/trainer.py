"""Training step factory: loss -> grads -> AdamW, with microbatch gradient
accumulation and the LR schedule.

The port of :mod:`repro.train.trainer`.
``make_train_step(model, tcfg, group=None)`` returns
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``;
``make_eval_step(model)`` returns ``eval_step(params, batch) -> metrics``.
Gradients are f32 on both microbatch paths, and metrics are averaged over
the microbatches, as in the reference; the microbatches split every batch
entry on its batch axis (axis 1 of M-RoPE ``positions``, (3, B, S); axis
0 of the others). Under a sequence ``group`` (a
:class:`~repro_torch.dist.group.SeqGroup`) each rank takes its slice of
the replicated batch along the sequence axis, and the f32 gradients are
summed over the group by one ``all_reduce`` of a flat buffer before
AdamW's clip and update, so the parameters and the optimizer state stay
bitwise equal on every rank. The reference's fourth argument,
the error-feedback state of compressed gradients, has no counterpart:
gradient compression is multi-GPU work (ROADMAP queue 1, 'multi-GPU') and
raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.optim import adamw
from repro_torch.optim.schedule import Schedule
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: adamw.AdamWConfig = adamw.AdamWConfig()
    schedule: Schedule = Schedule()
    microbatches: int = 1            # gradient accumulation
    compress_grads: bool = False     # int8 all-reduce (not ported)


def _batch_axis(key: str) -> int:
    """The batch axis of a batch entry: M-RoPE ``positions`` (3, B, S)
    carry it second."""
    return 1 if key == "positions" else 0


def _seq_slice(batch, group):
    """This rank's slice of every batch entry along its sequence axis
    (axis 1 of the (B, S) entries; the ranks' slices are contiguous and in
    rank order)."""
    out = {}
    for k, v in batch.items():
        S = v.shape[1]
        if S % group.size:
            raise ValueError(f"batch entry {k!r}: sequence length {S} is not "
                             f"divisible by the group's {group.size} shards")
        n = S // group.size
        out[k] = v[:, group.index * n:(group.index + 1) * n].contiguous()
    return out


def _psum_flat_(grads, group):
    """Sum f32 gradients over the group in place: ONE ``all_reduce`` of
    their concatenation."""
    leaves = tree_leaves(grads)
    flat = group.psum_(torch.cat([g.reshape(-1) for g in leaves]))
    off = 0
    for g in leaves:
        g.copy_(flat[off: off + g.numel()].view_as(g))
        off += g.numel()
    return grads


def make_train_step(model, tcfg: TrainConfig, group=None) -> Callable:
    """``group``: sequence-parallel training over a
    :class:`~repro_torch.dist.group.SeqGroup` (every rank calls the step
    with the same replicated batch)."""
    if tcfg.compress_grads:
        raise NotImplementedError(
            "compress_grads is multi-GPU work and is not ported yet: "
            "ROADMAP queue 1, 'multi-GPU'")

    def loss_and_grads(params, batch):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = model.loss(leaves, batch, group=group)
        grads = torch.autograd.grad(loss, tree_leaves(leaves))
        it = iter(grads)
        return (metrics["loss"].detach(),
                {k: v.detach() for k, v in metrics.items()},
                tree_map(lambda _: next(it), params))

    def grads_and_metrics(params, batch):
        """(grads, loss, metrics) with f32 grads on both microbatch paths
        and metrics averaged across microbatches."""
        mb = tcfg.microbatches
        if mb == 1:
            loss, metrics, grads = loss_and_grads(params, batch)
            return tree_map(lambda g: g.float(), grads), loss, metrics
        acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)
        loss_sum, metric_sums = 0.0, {}
        for i in range(mb):
            mbatch = {k: v.tensor_split(mb, dim=_batch_axis(k))[i]
                      for k, v in batch.items()}
            loss, metrics, grads = loss_and_grads(params, mbatch)
            acc = tree_map(torch.add, acc, grads)
            loss_sum = loss_sum + loss
            for k, v in metrics.items():
                metric_sums[k] = metric_sums.get(k, 0.0) + v
        return (tree_map(lambda g: g / mb, acc), loss_sum / mb,
                {k: v / mb for k, v in metric_sums.items()})

    def train_step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v).to(model.device)
                 for k, v in batch.items()}
        if group is not None:
            batch = _seq_slice(batch, group)
        if any(v.shape[_batch_axis(k)] % tcfg.microbatches
               for k, v in batch.items()):
            raise ValueError(f"batch axis must divide microbatches "
                             f"{tcfg.microbatches}")
        grads, loss, metrics = grads_and_metrics(params, batch)
        if group is not None:
            grads = _psum_flat_(grads, group)
        lr_scale = tcfg.schedule(opt_state.step)
        params, opt_state, opt_metrics = adamw.update(
            tcfg.optimizer, opt_state, params, grads, lr_scale)
        return params, opt_state, dict(metrics, **opt_metrics, loss=loss)

    return train_step


def make_eval_step(model) -> Callable:
    """``eval_step(params, batch) -> metrics``: the loss's metrics on one
    batch, no gradients."""

    @torch.no_grad()
    def eval_step(params, batch):
        batch = {k: torch.as_tensor(v).to(model.device)
                 for k, v in batch.items()}
        _, metrics = model.loss(params, batch)
        return metrics

    return eval_step
