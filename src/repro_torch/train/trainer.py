"""Training step factory: loss -> grads -> (optionally compressed) sum
over the ranks -> AdamW, with microbatch gradient accumulation and the LR
schedule.

The port of :mod:`repro.train.trainer`. ``make_train_step(model, tcfg,
group=None, data=None)`` returns ``train_step(params, opt_state, batch,
ef_state=None) -> (params, opt_state, metrics, ef_state)``, the
reference's fixed arity: ``ef_state`` (the int8 error-feedback residual)
is threaded always, ``None`` unless ``compress_grads`` is on, so no caller
switches shape on a flag. ``make_eval_step(model)`` returns
``eval_step(params, batch) -> metrics``. Gradients are f32 on both
microbatch paths, and metrics are averaged over the microbatches, as in
the reference; the microbatches split every batch entry on its batch axis
(axis 1 of M-RoPE ``positions``, (3, B, S); axis 0 of the others).

Every rank calls the step with the same global batch (``SyntheticLM
.batch(i)`` is a function of the step) and takes its part of it:

* a sequence ``group`` (:class:`~repro_torch.dist.group.SeqGroup`): its
  slice along the sequence axis;
* a ``data`` group (:class:`~repro_torch.dist.group.DataGroup`, the
  reference's ``batch`` -> ``data`` axis): its rows, contiguous and in
  rank order. Uncompressed, the step equals the global batch's on one
  device (pjit's data-parallel step): the loss is this rank's share
  (``Model.loss(data=...)``) and the f32 gradients are summed by one
  ``all_reduce`` of a flat buffer, as under a sequence group. With
  ``compress_grads`` it keeps the reference's ``shard_map`` semantics
  instead: each rank's plain loss on its rows, the gradient sent as
  ``compression.compressed_psum_with_residual(g + ef)`` (int8 values and
  one f32 scale a tensor on the wire) divided by n, the metrics averaged
  over the ranks, and ``ef_state`` this rank's own residual, shaped like
  ``params`` (its row of the reference's leading participant axis).
  Without a data group, or with one rank, ``compress_grads`` quantize-
  dequantizes locally (``compression.compress_decompress``).

Either way the parameters and the optimizer state stay bitwise equal on
every rank. The reference never composes ``seq`` and ``batch`` on separate
axes, so a step takes one group or the other.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.dist import compression
from repro_torch.dist.group import DataGroup, SeqGroup
from repro_torch.optim import adamw
from repro_torch.optim.schedule import Schedule
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: adamw.AdamWConfig = adamw.AdamWConfig()
    schedule: Schedule = Schedule()
    microbatches: int = 1            # gradient accumulation
    compress_grads: bool = False     # int8 all-reduce w/ error feedback


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


def _rows(batch, data, compress: bool):
    """This rank's rows of every batch entry (on its batch axis; the
    ranks' rows are contiguous and in rank order)."""
    n = data.size
    if any(v.shape[_batch_axis(k)] % n for k, v in batch.items()):
        raise ValueError(
            f"compress_grads: batch axis must divide the compress mesh axes "
            f"('data',) (x{n})" if compress else
            f"batch axis must divide the data group's {n} ranks")
    return {k: v.tensor_split(n, dim=_batch_axis(k))[data.index].contiguous()
            for k, v in batch.items()}


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


def _pmean(loss, metrics, data):
    """The loss and the metrics averaged over the data group (one
    ``all_reduce``)."""
    keys = list(metrics)
    mean = data.psum_(torch.stack([loss.reshape(())] + [
        metrics[k].reshape(()) for k in keys])) / data.size
    return mean[0], dict(zip(keys, mean[1:].unbind()))


def make_train_step(model, tcfg: TrainConfig, group=None,
                    data=None) -> Callable:
    """``group``: sequence-parallel training over a
    :class:`~repro_torch.dist.group.SeqGroup`; ``data``: data-parallel
    training over a :class:`~repro_torch.dist.group.DataGroup` (every
    rank calls the step with the same global batch). Not both: raises."""
    if group is not None and data is not None:
        raise ValueError("make_train_step takes a sequence group or a data "
                         "group, not both (the reference maps seq onto the "
                         "data axis only when the batch is unsharded)")
    if group is not None and not isinstance(group, SeqGroup):
        raise TypeError(f"group= takes a SeqGroup, got {type(group).__name__}")
    if data is not None and not isinstance(data, DataGroup):
        raise TypeError(f"data= takes a DataGroup, got {type(data).__name__}")
    n = 1 if data is None else data.size
    wire = tcfg.compress_grads and n > 1

    def loss_and_grads(params, batch, share):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = model.loss(leaves, batch, group=group, data=share)
        grads = torch.autograd.grad(loss, tree_leaves(leaves))
        it = iter(grads)
        return (metrics["loss"].detach(),
                {k: v.detach() for k, v in metrics.items()},
                tree_map(lambda _: next(it), params))

    def grads_and_metrics(params, batch, share):
        """(grads, loss, metrics) with f32 grads on both microbatch paths
        and metrics averaged across microbatches. ``share``: the data
        group whose global batch the loss is a share of, or None."""
        mb = tcfg.microbatches
        if mb == 1:
            loss, metrics, grads = loss_and_grads(params, batch, share)
            return tree_map(lambda g: g.float(), grads), loss, metrics
        acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)
        loss_sum, metric_sums = 0.0, {}
        for i in range(mb):
            mbatch = {k: v.tensor_split(mb, dim=_batch_axis(k))[i]
                      for k, v in batch.items()}
            loss, metrics, grads = loss_and_grads(params, mbatch, share)
            acc = tree_map(torch.add, acc, grads)
            loss_sum = loss_sum + loss
            for k, v in metrics.items():
                metric_sums[k] = metric_sums.get(k, 0.0) + v
        return (tree_map(lambda g: g / mb, acc), loss_sum / mb,
                {k: v / mb for k, v in metric_sums.items()})

    def train_step(params, opt_state, batch, ef_state=None):
        batch = {k: torch.as_tensor(v).to(model.device)
                 for k, v in batch.items()}
        if group is not None:
            batch = _seq_slice(batch, group)
        if data is not None:
            batch = _rows(batch, data, tcfg.compress_grads)
        if any(v.shape[_batch_axis(k)] % tcfg.microbatches
               for k, v in batch.items()):
            raise ValueError(f"batch axis must divide microbatches "
                             f"{tcfg.microbatches}")
        if wire:
            # the reference's shard_map region: the plain per-rank loss,
            # the gradient on the int8 wire, the metrics averaged
            grads, loss, metrics = grads_and_metrics(params, batch, None)
            if ef_state is None:
                ef_state = tree_map(torch.zeros_like, grads)
            total, ef_state = compression.compressed_psum_with_residual(
                tree_map(torch.add, grads, ef_state), data)
            grads = tree_map(lambda t: t / n, total)
            loss, metrics = _pmean(loss, metrics, data)
        else:
            grads, loss, metrics = grads_and_metrics(params, batch, data)
            if group is not None or data is not None:
                grads = _psum_flat_(grads, group or data)
            if tcfg.compress_grads:     # one participant: nothing to send
                grads, ef_state = compression.compress_decompress(
                    grads, ef_state)
        lr_scale = tcfg.schedule(opt_state.step)
        params, opt_state, opt_metrics = adamw.update(
            tcfg.optimizer, opt_state, params, grads, lr_scale)
        metrics = dict(metrics, **opt_metrics, loss=loss)
        return params, opt_state, metrics, ef_state

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
