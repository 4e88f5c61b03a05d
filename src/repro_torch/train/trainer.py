"""Training step factory: loss -> grads -> (optionally compressed) sum
over the ranks -> AdamW, with microbatch gradient accumulation and the LR
schedule.

The port of :mod:`repro.train.trainer`. ``make_train_step(model, tcfg,
group=None, data=None, model_group=None, fsdp=False)`` returns
``train_step(params,
opt_state, batch, ef_state=None) -> (params, opt_state, metrics,
ef_state)``, the
reference's fixed arity: ``ef_state`` (the int8 error-feedback residual)
is threaded always, ``None`` unless ``compress_grads`` is on, so no caller
switches shape on a flag (with one participant the step overwrites the
given ``ef_state``'s tensors and returns them). ``make_eval_step(model)``
returns ``eval_step(params, batch) -> metrics``. Gradients are f32 on both
microbatch paths, and metrics are averaged over the microbatches, as in
the reference; the microbatches split every batch entry on its batch axis
(axis 1 of M-RoPE ``positions``, (3, B, S); axis 0 of the others).

Every rank calls the step with the same global batch (``SyntheticLM
.batch(i)`` is a function of the step) and takes its part of it:

* a sequence ``group`` (:class:`~repro_torch.dist.group.SeqGroup`): its
  slice of each entry along that entry's sequence axis (``_seq_axis``:
  axis 2 of M-RoPE ``positions``, axis 1 of the others), whisper's
  ``audio_embeds`` whole;
* a ``data`` group (:class:`~repro_torch.dist.group.DataGroup`, the
  reference's ``batch`` -> ``data`` axis): its rows, contiguous and in
  rank order. Uncompressed, the step equals the global batch's on one
  device (pjit's data-parallel step): the loss is this rank's share
  (``Model.loss(data=...)``) and the f32 gradients are summed by one
  ``all_reduce`` of a flat buffer, as under a sequence group. Every rank
  then holds every parameter whole, unless ``fsdp``: the reference's
  FSDP fallback (ZeRO-3 under pjit), in which each weight that no model
  rule splits and that has at least 2 dims is held as this rank's slice
  of its largest dim, with its AdamW moments
  (:func:`train_placements`, from the whole
  shapes of ``Model.param_shapes``). The forward gathers each such
  weight where a layer uses it
  (:class:`~repro_torch.dist.group.SplitWeight`, inside the remat body),
  and the backward sums its gradient in f32 straight into this rank's
  slice (one ``reduce_scatter`` a weight, each microbatch's
  accumulated); the flat ``all_reduce`` sums only the leaves that stay
  whole (the 1-D ones, and the weights whose largest dim the group does
  not divide). With
  ``compress_grads`` it keeps the reference's ``shard_map`` semantics
  instead: each rank's plain loss on its rows, the gradient sent as
  ``compression.compressed_psum_with_residual(g + ef)`` (int8 values and
  one f32 scale a tensor on the wire) divided by n, the metrics averaged
  over the ranks, and ``ef_state`` this rank's own residual, shaped like
  ``params`` (its row of the reference's leading participant axis).
  Without a data group, or with one rank, ``compress_grads`` quantize-
  dequantizes locally (``compression.compress_decompress``). Under a
  model group the scales are the whole tensors' (each scale group's
  absmax maxed over the model group, after ``sum_model_shares_``), so a
  rank's int8 values and residual are its slices of the whole run's.
  Under ``fsdp`` an FSDP leaf's backward keeps this rank's WHOLE f32
  gradient (no ``reduce_scatter``), which is quantized whole with the
  whole residual; the wire then hands each rank the sum of its slice
  only (one ``all_to_all``), and AdamW runs on the slices. The residual
  stays whole-shape on every rank, as the reference's.

A ``model_group`` (:class:`~repro_torch.dist.group.ModelGroup`, the
reference's "model" axis) is tensor parallelism (and, for the MoE family,
expert parallelism: each rank holds E / N of every expert stack and its
router columns where N divides E, else every expert, the stacks split
over ffn where N divides ``d_ff_expert`` and whole otherwise, with the
router whole): every rank of the group
takes the same rows, its parameters and optimizer state are its slices of
the split leaves (:func:`shard_params` by
:func:`train_placements`), its gradients of them
its own, and the clip sees the whole model's norm. The whole leaves of
an RG-LRU or SSD block whose products split (``Split.model_sum``) get on
each rank only its share of their gradient; one flat f32 ``all_reduce``
over the model group sums them a step (:func:`sum_model_shares_`), before
the data group's sum. It composes with a
``data`` group (the ``(data, model)`` mesh of
:func:`repro_torch.dist.group.mesh_groups`): the one flat gradient
``all_reduce`` then runs over the data group, each rank holding its own
slices; with ``fsdp`` the leaves the model group leaves whole split over
the data group. A leaf splits over one axis or none.

Either way the parameters and the optimizer state stay bitwise equal on
every rank that holds them. The reference never composes ``seq`` and
``batch`` on separate axes, so a step takes one group or the other.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.dist import compression
from repro_torch.dist.group import (DataGroup, Mesh2D, ModelGroup,
                                    SeqGroup, SplitWeight)
from repro_torch.dist.sharding import mesh_placements
from repro_torch.models import moe as MOE
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


# The sequence axis of each batch entry a sequence group slices, or None
# for an entry every rank takes whole: M-RoPE ``positions`` (3, B, S)
# carry it third; whisper's ``audio_embeds`` (B, n_audio_frames, d) are
# the encoder's frames, not the token sequence (the reference's input
# spec leaves that axis unsplit), so every rank encodes all of them.
_SEQ_AXES = {"tokens": 1, "labels": 1, "mask": 1, "vision_embeds": 1,
             "vision_mask": 1, "positions": 2, "audio_embeds": None}


def _seq_axis(key: str):
    """The sequence axis of a batch entry (``_SEQ_AXES``); an entry it
    does not know raises rather than being guessed."""
    if key not in _SEQ_AXES:
        raise KeyError(f"batch entry {key!r}: no known sequence axis (one "
                       f"of {sorted(_SEQ_AXES)})")
    return _SEQ_AXES[key]


def _seq_slice(batch, group):
    """This rank's slice of every batch entry along its sequence axis
    (``_seq_axis``; the ranks' slices are contiguous and in rank order);
    an entry without one whole."""
    out = {}
    for k, v in batch.items():
        axis = _seq_axis(k)
        if axis is None:
            out[k] = v
            continue
        S = v.shape[axis]
        if S % group.size:
            raise ValueError(f"batch entry {k!r}: sequence length {S} is not "
                             f"divisible by the group's {group.size} shards")
        n = S // group.size
        out[k] = v.narrow(axis, group.index * n, n).contiguous()
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


def _psum_flat_(grads, group, placements=None, which=None):
    """Sum f32 gradients over the group in place: ONE ``all_reduce`` of
    their concatenation. ``placements``: a tree of
    :class:`~repro_torch.dist.sharding.Split`; the leaves ``which(split)``
    selects (by default those it does not split over the data group,
    which their ``reduce_scatter`` summed already)."""
    which = which or (lambda s: s.data is None)
    leaves = tree_leaves(grads) if placements is None else [
        g for g in tree_leaves(tree_map(
            lambda g, s: g if which(s) else None, grads, placements))
        if g is not None]
    if not leaves:
        return grads
    flat = group.psum_(torch.cat([g.reshape(-1) for g in leaves]))
    off = 0
    for g in leaves:
        g.copy_(flat[off: off + g.numel()].view_as(g))
        off += g.numel()
    return grads


def sum_model_shares_(grads, placements, model_group):
    """Sum over ``model_group``, in place, the f32 gradients of the leaves
    ``placements`` marks ``model_sum`` (whole leaves of which each rank
    uses only its part: its gradient is its share), in ONE ``all_reduce``
    of their concatenation; the other leaves as they are. Returns
    ``grads``."""
    if model_group is None or not any(
            s.model_sum for s in tree_leaves(placements)):
        return grads
    return _psum_flat_(grads, model_group, placements,
                       lambda s: s.model_sum)


def _pmean(loss, metrics, data):
    """The loss and the metrics averaged over the data group (one
    ``all_reduce``)."""
    keys = list(metrics)
    mean = data.psum_(torch.stack([loss.reshape(())] + [
        metrics[k].reshape(()) for k in keys])) / data.size
    return mean[0], dict(zip(keys, mean[1:].unbind()))


def _size(group) -> int:
    return 1 if group is None else group.size


def _axis(s, mesh):
    """(the group, the dim) a leaf placed ``s`` splits on over ``mesh``,
    or None for a whole leaf."""
    if s.model is not None:
        return mesh.model, s.model
    if s.data is not None:
        return mesh.data, s.data
    return None


def shard_params(full, placements, mesh):
    """This rank's slices of ``full`` (a tree of whole leaves): each leaf
    cut along its :class:`~repro_torch.dist.sharding.Split` dim over that
    axis' group of ``mesh`` (a :class:`~repro_torch.dist.group.Mesh2D`),
    the whole leaves kept as they are."""
    def one(x, s):
        at = _axis(s, mesh)
        return x if at is None else at[0].shard(x, at[1])
    return tree_map(one, full, placements)


def gather_params(shards, placements, mesh):
    """The whole leaves from every rank's slices (each split leaf
    ``unshard``-ed over its axis' group of ``mesh``); whole leaves as they
    are. Every rank of the groups calls it."""
    def one(x, s):
        at = _axis(s, mesh)
        return x if at is None else at[0].unshard(x, at[1])
    return tree_map(one, shards, placements)


def init_shards(model, generator, model_group=None, data=None,
                fsdp: bool = False):
    """This rank's slices of ``model.init(generator)``, cut as each layer
    (and the embedding) is drawn, so a rank never holds the whole model:
    the same parameters a single-device run draws from the same
    generator, as :func:`shard_params` would cut them by
    :func:`train_placements`. Where the model group splits the experts,
    an MoE layer's expert stacks are drawn expert by expert and only this
    rank's experts kept (``moe.expert_span``), so a rank's transient is
    one expert's draw, not a whole stack; stacks split over ffn, or
    whole, are cut as any other leaf."""
    mesh = Mesh2D(data if fsdp else None, model_group)
    n, cfg = _size(model_group), model.cfg
    span = None
    if cfg.moe is not None and n > 1:
        span = MOE.expert_span(cfg, model_group)

    def keep(path, sub):
        return shard_params(sub, mesh_placements(
            sub, cfg, _size(mesh.data), n, path,
            experts_cut=span is not None), mesh)
    return model.init(generator, keep=keep, span=span)


def train_placements(model, model_group=None, data=None,
                     fsdp: bool = False):
    """The one :class:`~repro_torch.dist.sharding.Split` tree of
    ``model``'s parameters on the mesh of ``model_group`` and, with
    ``fsdp``, ``data`` (``mesh_placements`` of their whole shapes,
    ``Model.param_shapes``): what :func:`make_train_step` splits, the
    optimizer reads and :func:`state_shardings` turns into checkpoint
    placements."""
    return mesh_placements(model.param_shapes(), model.cfg,
                           _size(data) if fsdp else 1, _size(model_group))


def state_shardings(placements, opt_state):
    """The checkpoint placements of a train state ``{"params", "opt"}``
    whose parameters split by ``placements`` (a
    :class:`~repro_torch.dist.sharding.Split` tree): per leaf a ``(data,
    model)`` tuple of ``Shard(dim)`` / ``Replicate()``,
    ``torch.distributed.tensor``'s idiom for a 2-D mesh; the AdamW
    moments (and a master copy) split as their parameters, the step count
    whole. What :mod:`repro_torch.ft.checkpoint` takes as ``shardings``."""
    from torch.distributed.tensor import Replicate, Shard

    def one(d):
        return Replicate() if d is None else Shard(d)

    sh = tree_map(lambda _, s: (one(s.data), one(s.model)), opt_state.m,
                  placements)
    return {"params": sh, "opt": adamw.AdamWState(
        step=None, m=sh, v=sh,
        master=None if opt_state.master is None else sh)}


def make_train_step(model, tcfg: TrainConfig, group=None, data=None,
                    model_group=None, fsdp: bool = False) -> Callable:
    """``group``: sequence-parallel training over a
    :class:`~repro_torch.dist.group.SeqGroup`; ``data``: data-parallel
    training over a :class:`~repro_torch.dist.group.DataGroup` (every
    rank calls the step with the same global batch); ``model_group``:
    tensor-parallel training over a
    :class:`~repro_torch.dist.group.ModelGroup` (the parameters and the
    optimizer state this rank's slices), alone or with ``data``;
    ``fsdp``: with ``data``, the FSDP fallback (the parameters the
    fallback splits and their optimizer state this rank's slices over
    ``data``: :func:`init_shards`, :func:`shard_params`; a no-op with one
    data rank). A sequence group takes no other: raises."""
    if group is not None and data is not None:
        raise ValueError("make_train_step takes a sequence group or a data "
                         "group, not both (the reference maps seq onto the "
                         "data axis only when the batch is unsharded)")
    if group is not None and model_group is not None:
        raise ValueError("make_train_step takes a sequence group or a model "
                         "group, not both (the reference never maps seq and "
                         "model together in training)")
    if group is not None and not isinstance(group, SeqGroup):
        raise TypeError(f"group= takes a SeqGroup, got {type(group).__name__}")
    if data is not None and not isinstance(data, DataGroup):
        raise TypeError(f"data= takes a DataGroup, got {type(data).__name__}")
    if model_group is not None and not isinstance(model_group, ModelGroup):
        raise TypeError(f"model_group= takes a ModelGroup, got "
                        f"{type(model_group).__name__}")
    if model_group is not None and model_group.size == 1:
        model_group = None
    n = 1 if data is None else data.size
    fsdp = fsdp and n > 1
    wire = tcfg.compress_grads and n > 1
    place = train_placements(model, model_group, data, fsdp) \
        if fsdp or model_group is not None else None
    mesh = Mesh2D(data, model_group)
    split = tree_map(lambda s: s.data, place) if wire and fsdp else None

    def inputs(params):
        """(the tree the model takes, the tensors differentiated
        against): each FSDP leaf as a ``SplitWeight`` whose gradient goes
        to an f32 zero of its slice's shape (a scalar expanded: no
        memory), or on the int8 wire of the whole weight's shape (the
        rank's own gradient, quantized whole before the sum), the other
        leaves themselves."""
        if not fsdp:
            leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
            return leaves, tree_leaves(leaves)

        def one(p, s):
            if s.data is None:
                return p.detach().requires_grad_()
            shape = list(p.shape)
            if wire:
                shape[s.data] *= n
            slot = torch.zeros((), dtype=torch.float32, device=p.device,
                               requires_grad=True).expand(shape)
            return SplitWeight(p.detach(), slot, s.data, data,
                               summed=not wire)
        tree = tree_map(one, params, place)
        return tree, [x.grad_to if isinstance(x, SplitWeight) else x
                      for x in tree_leaves(tree)]

    def loss_and_grads(params, batch, share):
        leaves, wrt = inputs(params)
        loss, metrics = model.loss(leaves, batch, group=group, data=share,
                                   model=model_group)
        grads = torch.autograd.grad(loss, wrt)
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
        acc = None
        loss_sum, metric_sums = 0.0, {}
        for i in range(mb):
            mbatch = {k: v.tensor_split(mb, dim=_batch_axis(k))[i]
                      for k, v in batch.items()}
            loss, metrics, grads = loss_and_grads(params, mbatch, share)
            acc = tree_map(lambda g: g.float(), grads) if acc is None \
                else tree_map(torch.add, acc, grads)
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
            # the gradient on the int8 wire (scales over the model group,
            # FSDP leaves quantized whole and summed into this rank's
            # slice), the metrics averaged
            grads, loss, metrics = grads_and_metrics(params, batch, None)
            grads = sum_model_shares_(grads, place, model_group)
            if ef_state is None:
                ef_state = tree_map(torch.zeros_like, grads)
            total, ef_state = compression.compressed_psum_with_residual(
                tree_map(torch.add, grads, ef_state), data, model_group,
                split)
            grads = tree_map(lambda t: t / n, total)
            loss, metrics = _pmean(loss, metrics, data)
        else:
            grads, loss, metrics = grads_and_metrics(params, batch, data)
            grads = sum_model_shares_(grads, place, model_group)
            if group is not None or data is not None:
                grads = _psum_flat_(grads, group or data, place)
            if tcfg.compress_grads:     # one participant: nothing to send
                grads, ef_state = compression.compress_decompress(
                    grads, ef_state, model_group)
        lr_scale = tcfg.schedule(opt_state.step)
        params, opt_state, opt_metrics = adamw.update(
            tcfg.optimizer, opt_state, params, grads, lr_scale, place,
            mesh)
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
