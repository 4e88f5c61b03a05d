"""Groups of ranks: the port's counterpart of a 1-D "seq" or "data" mesh.

The reference runs its sequence-parallel serving engine as ONE program
over a ``jax.make_mesh((S,), ("seq",))`` mesh, inside ``shard_map``, where
``jax.lax.axis_index`` names the shard and ``pmax``/``psum`` reduce over
the axis. The port runs S processes instead (SPMD: every rank runs the same
host control on replicated state), joined by a ``torch.distributed``
process group:

* :class:`SeqGroup` — the process group, this rank's shard ``index``, the
  ``size`` and the rank's ``device``, with in-place ``pmax_``/``psum_``
  (``all_reduce`` MAX / SUM), :meth:`SeqGroup.ppermute` (``jax.lax
  .ppermute``: the halo exchange of sequence-parallel training) and
  :meth:`SeqGroup.agree` (rank 0's scalar on every rank).
* :class:`DataGroup` — the data-parallel counterpart (the reference's
  ``batch`` -> ``data`` axis): the same fields, ``psum_`` and
  :meth:`DataGroup.all_gather` (the int8 gradient wire of
  :mod:`repro_torch.dist.compression`). Each rank holds whole sequences,
  its rows of the global batch. Under the FSDP fallback a rank also
  holds only its slice of each weight the fallback splits
  (:func:`repro_torch.dist.sharding.mesh_placements`):
  :meth:`DataGroup.shard`/:meth:`DataGroup.unshard` move whole trees, and
  :meth:`DataGroup.gather_weight` is the autograd collective of a layer's
  weight (``all_gather`` forward; backward, the f32 sum of the ranks'
  gradients, this rank's slice: one ``reduce_scatter``,
  :meth:`DataGroup.reduce_scatter`; on the int8 wire, this rank's whole
  gradient, which :meth:`DataGroup.all_to_all` later sums slice by
  slice).
* :class:`ModelGroup` — the tensor-parallel counterpart (the reference's
  "model" mesh axis: ``heads``, ``kv_heads``, ``ffn`` and ``vocab``
  split, :mod:`repro_torch.dist.sharding`): ``psum_``, ``pmax_``,
  :meth:`ModelGroup.all_gather`, and the two autograd collectives of a
  split product, :meth:`ModelGroup.enter` (identity forward, ``all_reduce``
  backward: the input of a column-split product) and
  :meth:`ModelGroup.reduce` (``all_reduce`` forward, identity backward:
  the output of a row-split product), :meth:`ModelGroup.gather`
  (``all_gather`` forward, this rank's slice of the gradient backward:
  the whole of a column-split output that every rank then uses alike,
  as an MoE router's logits; with ``summed``, the gradients' sum first,
  a ``reduce_scatter``, where each rank uses the whole differently).
  Every rank holds the same batch.
* :class:`StackedGroup` — the same collectives over a leading shard axis
  of one tensor on one device: what ``jax.vmap(..., axis_name="seq")``
  is to ``shard_map``. It holds every shard's tensors in one process (the
  merge checks on one card and the CPU tests use it).
* :func:`run_ranks` — start ``n`` local ranks, call ``fn(group, *args)``
  in each, join them under a deadline, and return every rank's result;
  with ``model=M`` the ranks form the reference's ``(data, model)`` mesh
  (:func:`mesh_groups`) and ``fn`` gets a :class:`Mesh2D`.

The backend is always the caller's choice, never guessed: ``"nccl"`` puts
rank ``r`` on ``cuda:r`` and needs that many cards; ``"gloo"`` puts every
rank on the one device the caller names (``"cpu"``, or one ``cuda:0``
that the ranks share). Gloo's ``all_reduce`` takes CUDA tensors; its
point-to-point ``send``/``recv`` take host memory only (given a CUDA
tensor it fails with "writev: Bad address", ``tools/gloo_p2p_probe.py``),
so :meth:`SeqGroup.ppermute` on a gloo group on a CUDA device copies its
buffers through host tensors (:attr:`SeqGroup.host_p2p`), a transport
step named by the backend, never taken on NCCL. Gloo's
``reduce_scatter`` and ``all_to_all_single`` take CUDA tensors
(``tools/gloo_reduce_scatter_probe.py``, ``tools/gloo_all_to_all_probe.py``),
so the FSDP gradient and its int8 wire need no such step.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class _Ranks:
    """What every group of ranks holds: ``pg``, the ``torch.distributed``
    process group (``None`` only for a group object that never runs a
    collective, as in a constructor's argument checks); ``index``, this
    rank's place; ``size``, the number of ranks; ``device``, the device
    this rank's tensors live on; ``backend``."""
    pg: Any
    index: int
    size: int
    device: torch.device
    backend: str = "gloo"

    def psum_(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise sum over the ranks, in place; returns ``t``."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.pg)
        return t


@dataclasses.dataclass(frozen=True)
class SeqGroup(_Ranks):
    """One rank's view of a sequence group: ``index`` is this rank's
    shard of every sequence, ``size`` the number of shards."""

    def pmax_(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise max over the ranks, in place; returns ``t``."""
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.pg)
        return t

    @property
    def host_p2p(self) -> bool:
        """Whether :meth:`ppermute` stages its buffers through host memory:
        on a gloo group whose tensors live on a CUDA device (gloo's
        point-to-point ``send``/``recv`` take host tensors only). NCCL and
        gloo on the CPU send the tensors as they are."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def ppermute(self, buf: torch.Tensor, perm) -> torch.Tensor:
        """``jax.lax.ppermute``: ``perm`` lists ``(src, dst)`` pairs, each
        rank at most once as a source and once as a destination. This rank
        sends ``buf`` to the ``dst`` of its pair and returns the buffer it
        receives (zeros where no pair names it as the destination). Every
        rank passes the same ``perm`` and a ``buf`` of the same shape and
        type; the sends and receives go out together through
        ``dist.batch_isend_irecv``. On a gloo group on a CUDA device
        (:attr:`host_p2p`) both buffers are copied through pinned host
        tensors."""
        dst = [d for s, d in perm if s == self.index]
        src = [s for s, d in perm if d == self.index]
        if len(dst) > 1 or len(src) > 1:
            raise ValueError(f"perm {perm} names rank {self.index} more "
                             f"than once as a source or a destination")
        stage = self.host_p2p
        send = buf.contiguous()
        if stage:       # through pinned host buffers (cached by torch)
            send = torch.empty(buf.shape, dtype=buf.dtype,
                               pin_memory=True).copy_(send)
        recv = torch.empty(send.shape, dtype=send.dtype, device=send.device,
                           pin_memory=stage)
        if not src:
            recv.zero_()
        ops = []
        if dst:
            ops.append(dist.P2POp(dist.isend, send, dst[0], group=self.pg))
        if src:
            ops.append(dist.P2POp(dist.irecv, recv, src[0], group=self.pg))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return recv.to(self.device) if stage else recv

    def agree(self, value: float) -> float:
        """Rank 0's ``value`` on every rank (an ``all_reduce`` MAX of one
        f64 in which the other ranks put ``-inf``). The engine reads its
        clock through this once a step, so a deadline expires on every
        rank at the same step."""
        t = torch.full((1,), float(value) if self.index == 0
                       else float("-inf"), dtype=torch.float64,
                       device=self.device)
        return float(self.pmax_(t)[0])


@dataclasses.dataclass(frozen=True)
class DataGroup(_Ranks):
    """One rank's view of a data-parallel group, the reference's ``data``
    mesh axis: ``index`` is this rank's place in the batch split, ``size``
    the number of ranks. Every rank holds whole sequences (its rows of the
    global batch), so a data group is never a :class:`SeqGroup`: the
    ``group=`` of the attention op, the model and the train step takes
    the sequence group alone."""

    @classmethod
    def of(cls, group: _Ranks) -> "DataGroup":
        """The data group over the ranks of ``group`` (what
        :func:`run_ranks` hands each rank)."""
        return cls(group.pg, group.index, group.size, group.device,
                   group.backend)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t``, stacked in rank order: ``(size, *t.shape)``
        (one ``all_gather`` of the flat tensor; gloo takes CUDA tensors
        here, ``tools/gloo_allgather_probe.py``)."""
        out = torch.empty(self.size * t.numel(), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t.contiguous().view(-1),
                                    group=self.pg)
        return out.view(self.size, *t.shape)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """The flat ``t`` cut into ``size`` equal parts, part j sent to
        rank j: returns ``(size, t.numel() // size)``, row r the part
        rank r sent this rank (one ``all_to_all_single``: the FSDP int8
        gradient wire of :mod:`repro_torch.dist.compression`; gloo takes
        CUDA tensors here, ``tools/gloo_all_to_all_probe.py``)."""
        if t.numel() % self.size:
            raise ValueError(f"all_to_all: {t.numel()} values do not split "
                             f"into {self.size} equal parts")
        send = t.contiguous().view(-1)
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send, group=self.pg)
        return out.view(self.size, -1)

    def shard(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's contiguous slice of the whole ``x`` along ``dim``
        (a copy, so the whole tensor can be freed)."""
        return x.chunk(self.size, dim)[self.index].clone(
            memory_format=torch.contiguous_format)

    def unshard(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole tensor from every rank's slice ``x`` along ``dim``
        (one ``all_gather``, joined in rank order); every rank calls it."""
        parts = self.all_gather(x)
        if dim == 0:
            return parts.view(self.size * x.shape[0], *x.shape[1:])
        return torch.cat(parts.unbind(0), dim=dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The elementwise sum of every rank's whole ``t``, this rank's
        contiguous slice of it along ``dim`` (one ``reduce_scatter``; gloo
        takes CUDA tensors here, ``tools/gloo_reduce_scatter_probe.py``).
        The sum is in ``t``'s type; two ranks' sums equal an
        ``all_reduce``'s bit for bit."""
        x = t.movedim(dim, 0).contiguous()
        out = x.new_empty((x.shape[0] // self.size, *x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM,
                                   group=self.pg)
        return out.movedim(0, dim).contiguous()

    def gather_weight(self, shard: torch.Tensor, dim: int,
                      grad_to: torch.Tensor,
                      summed: bool = True) -> torch.Tensor:
        """The whole weight from every rank's slice ``shard`` along
        ``dim`` (:meth:`unshard`, bitwise the whole tensor). Backward, the
        gradient of the whole weight is cast to f32, summed over the group
        and this rank's slice kept (:meth:`reduce_scatter`); it goes to
        ``grad_to``, an f32 tensor of the slice's shape that the caller
        differentiates against (autograd would round a gradient returned
        to a bf16 ``shard`` to bf16 after the sum), not to ``shard``.
        Without ``summed``, ``grad_to`` has the whole weight's shape and
        takes this rank's own f32 gradient of it, unsummed (the int8 wire
        quantizes that whole gradient before anything is summed)."""
        return _GatherWeight.apply(shard, grad_to, self, dim, summed)


class _GatherWeight(torch.autograd.Function):
    """A data-split weight: every rank's slice joined forward; the f32
    sum of the ranks' gradients of the whole, this rank's slice (or,
    without ``summed``, this rank's own gradient of the whole),
    backward, handed to ``grad_to``."""

    @staticmethod
    def forward(ctx, shard, grad_to, group, dim, summed):
        ctx.group, ctx.dim, ctx.summed = group, dim, summed
        return group.unshard(shard, dim)

    @staticmethod
    def backward(ctx, g):
        g = (ctx.group.reduce_scatter(g.float(), ctx.dim) if ctx.summed
             else g.float())
        return None, g, None, None, None


@dataclasses.dataclass(frozen=True)
class SplitWeight:
    """A weight split over a data group (the FSDP fallback), as the
    forward takes it: this rank's slice ``shard`` along ``dim``, and the
    f32 tensor ``grad_to`` its summed gradient goes to
    (:meth:`DataGroup.gather_weight`; without ``summed``, the whole
    weight's shape and this rank's own gradient). A leaf of a parameter
    tree: the model gathers it where a layer uses it
    (:func:`gather_weights`)."""
    shard: torch.Tensor
    grad_to: torch.Tensor
    dim: int
    group: DataGroup
    summed: bool = True

    def whole(self) -> torch.Tensor:
        return self.group.gather_weight(self.shard, self.dim, self.grad_to,
                                        self.summed)


def gather_weights(tree):
    """``tree`` (a parameter subtree, or None) with every
    :class:`SplitWeight` leaf gathered into the whole weight, the other
    leaves as they are. Every rank of the data group calls it at the same
    point of the forward (and of a remat replay)."""
    return tree_map(lambda x: x.whole() if isinstance(x, SplitWeight)
                    else x, tree)


class _Enter(torch.autograd.Function):
    """Identity forward; the gradient summed over the group backward.
    Placed on the input of a column-split product, whose backward leaves
    each rank only its columns' share of the input's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.psum_(g.contiguous().clone()), None


class _Reduce(torch.autograd.Function):
    """The partial outputs summed over the group forward; identity
    backward. Placed after a row-split product: every rank's output, and
    so every rank's gradient of it, is the whole sum. (Not
    ``torch.distributed.nn.functional.all_reduce``, whose backward is an
    ``all_reduce`` too and multiplies this gradient by the group's
    size.)"""

    @staticmethod
    def forward(ctx, x, group):
        return group.psum_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """Every rank's slice joined along ``dim`` in rank order forward.
    Backward, without ``summed``, this rank's slice of the gradient: what
    follows the gather runs alike on every rank, so every rank's gradient
    of the whole is already the whole gradient. With ``summed``, every
    rank uses the whole differently (each its own columns of a weight),
    so the ranks' gradients are shares: their sum, this rank's slice (one
    ``reduce_scatter``)."""

    @staticmethod
    def forward(ctx, x, group, dim, summed):
        ctx.group, ctx.dim, ctx.summed = group, dim, summed
        return group.unshard(x, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            return ctx.group.reduce_scatter(g, ctx.dim), None, None, None
        return (g.chunk(ctx.group.size, ctx.dim)[ctx.group.index]
                .contiguous(), None, None, None)


@dataclasses.dataclass(frozen=True)
class ModelGroup(_Ranks):
    """One rank's view of a tensor-parallel group, the reference's
    ``model`` mesh axis: ``index`` is this rank's slice of every split
    dim (:func:`repro_torch.dist.sharding.mesh_placements`), ``size`` the
    number of slices. Every rank of the group holds the same batch."""

    pmax_ = SeqGroup.pmax_
    all_gather = DataGroup.all_gather
    shard = DataGroup.shard
    unshard = DataGroup.unshard
    reduce_scatter = DataGroup.reduce_scatter

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` unchanged; its gradient summed over the group (the input
        of a column-split product, or a replicated weight that feeds one
        rank's slice of the work)."""
        return _Enter.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x``; the gradient passes unchanged
        (the output of a row-split product)."""
        return _Reduce.apply(x, self)

    def gather(self, x: torch.Tensor, dim: int,
               summed: bool = False) -> torch.Tensor:
        """Every rank's ``x`` joined along ``dim`` in rank order (one
        ``all_gather``); backward, this rank's slice of the gradient (the
        whole of a column-split output, used alike on every rank), or with
        ``summed`` this rank's slice of the gradients' sum over the group
        (one ``reduce_scatter``: the whole used differently on each rank,
        as the RG-LRU's gates take their columns of the whole input)."""
        return _Gather.apply(x, self, dim, summed)


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """One rank's groups in the reference's ``(data, model)`` mesh: its
    data group (``None`` when the data axis has one rank) and its model
    group (``None`` when the model axis has one rank)."""
    data: Optional[DataGroup]
    model: Optional[ModelGroup]


def mesh_groups(world: _Ranks, model: int) -> Mesh2D:
    """Split the ``world`` ranks into the ``(data, model)`` mesh with
    ``model`` as the fast axis: rank ``r`` has data index ``r // model``
    and model index ``r % model``. Every rank calls ``dist.new_group``
    for every group, in the same order (the collective contract of
    ``new_group``), and keeps its own two."""
    n = world.size
    if model < 1 or n % model:
        raise ValueError(f"the model axis ({model}) must divide the "
                         f"{n} ranks")
    D = n // model
    r = world.index
    mine = {"data": None, "model": None}
    if model > 1:                           # the model groups: one a row
        for d in range(D):
            pg = dist.new_group([d * model + m for m in range(model)])
            if d == r // model:
                mine["model"] = ModelGroup(pg, r % model, model,
                                           world.device, world.backend)
    if D > 1:                               # the data groups: one a column
        for m in range(model):
            pg = dist.new_group([d * model + m for d in range(D)])
            if m == r % model:
                mine["data"] = DataGroup(pg, r // model, D, world.device,
                                         world.backend)
    return Mesh2D(**mine)


class StackedGroup:
    """Every shard in one process: a tensor carries a leading shard axis
    of ``size``, and ``pmax_``/``psum_`` reduce over that axis and write
    the result into every shard's slice, as ``jax.vmap(...,
    axis_name=...)`` runs the reference's collectives."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"a group needs at least one shard, got {size}")
        self.size = size

    def _check(self, t: torch.Tensor) -> None:
        if t.dim() == 0 or t.shape[0] != self.size:
            raise ValueError(f"a stacked tensor leads with the {self.size} "
                             f"shards, got {tuple(t.shape)}")

    def pmax_(self, t: torch.Tensor) -> torch.Tensor:
        self._check(t)
        return t.copy_(t.amax(dim=0, keepdim=True).expand_as(t))

    def psum_(self, t: torch.Tensor) -> torch.Tensor:
        self._check(t)
        return t.copy_(t.sum(dim=0, keepdim=True).expand_as(t))

    def ppermute(self, buf: torch.Tensor, perm) -> torch.Tensor:
        """``jax.lax.ppermute`` over the leading shard axis: slice ``dst``
        of the result is slice ``src`` of ``buf`` for each ``(src, dst)``
        pair, zeros where no pair names the shard as the destination."""
        self._check(buf)
        out = torch.zeros_like(buf)
        for s, d in perm:
            out[d] = buf[s]
        return out


def _rank_devices(n: int, backend: str, device) -> List[str]:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl":
        if device not in (None, "cuda"):
            raise ValueError(f"backend='nccl' puts rank r on cuda:r; pass "
                             f"no device, got {device!r}")
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"backend='nccl' runs one rank per card: {n} ranks need {n} "
                f"CUDA devices and this machine has {have} (NCCL refuses two "
                f"ranks on one card); ranks sharing one device run with "
                f"backend='gloo' and device='cuda:0' (or 'cpu')")
        return [f"cuda:{r}" for r in range(n)]
    if device is None:
        raise ValueError("backend='gloo' needs the device every rank uses: "
                         "'cpu' or one CUDA device they share")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} needs a CUDA device and "
                               f"torch.cuda.is_available() is False")
        dev = torch.device("cuda", 0 if dev.index is None else dev.index)
    elif dev.type != "cpu":
        raise ValueError(f"device must be cpu or cuda, got {device!r}")
    return [str(dev)] * n


def _rank_main(fn, rank: int, n: int, backend: str, device: str, tmp: str,
               timeout_s: float, args: Sequence,
               model: Optional[int] = None) -> None:
    """One rank: join the group, run ``fn``, leave its result (or its
    traceback) in ``tmp``."""
    out = Path(tmp)
    try:
        torch.set_num_threads(1)
        # a local group talks over the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.FileStore(str(out / "store"), n)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=n,
                                timeout=timedelta(seconds=timeout_s))
        group = SeqGroup(dist.group.WORLD, rank, n, dev, backend)
        if model is not None:
            group = mesh_groups(group, model)
        res = fn(group, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.destroy_process_group()
        part = out / f"result{rank}.pkl.part"
        part.write_bytes(pickle.dumps(res))
        os.replace(part, out / f"result{rank}.pkl")
    except BaseException:
        (out / f"error{rank}.txt").write_text(traceback.format_exc())
        raise
    # The work is done and its result written. A spawned child would now
    # run the interpreter's teardown, in which the C++ destructors of
    # torch's distributed state sometimes abort ("terminate called without
    # an active exception", seen under load with gloo); end the process
    # here instead.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def run_ranks(fn: Callable, n: int, *, backend: str,
              device: Optional[str] = None, timeout_s: float = 120.0,
              args: Sequence = (), model: Optional[int] = None) -> List[Any]:
    """Run ``fn(group, *args)`` on ``n`` local ranks and return the ``n``
    results in rank order.

    ``fn`` must be picklable by reference (a module-level function) and
    return a picklable value (CPU tensors, numpy arrays, plain Python).
    Each rank is a process started with ``spawn``; it calls
    ``torch.set_num_threads(1)``, joins a process group through a
    ``FileStore`` in a fresh temporary directory (no port to find) with a
    collective timeout of ``timeout_s``, and gets a :class:`SeqGroup`.

    ``backend="nccl"``: rank ``r`` on ``cuda:r``; raises if the machine has
    fewer than ``n`` cards. ``backend="gloo"``: every rank on ``device``
    (``"cpu"`` or one CUDA device, required).

    ``model=M`` (M dividing n): the ranks form the reference's ``(data,
    model)`` mesh of n / M x M, model the fast axis (:func:`mesh_groups`),
    and ``fn`` gets the rank's :class:`Mesh2D` in place of the group.

    Raises ``RuntimeError`` (with each failed rank's traceback) if any rank
    fails or the ranks have not all finished within ``timeout_s``; every
    rank still running is then killed."""
    if n < 1:
        raise ValueError(f"run_ranks needs n >= 1, got {n}")
    if model is not None and (model < 1 or n % model):
        raise ValueError(f"run_ranks: the model axis ({model}) must divide "
                         f"the {n} ranks")
    devices = _rank_devices(n, backend, device)
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="seqgroup-")
    procs = []
    try:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, n, backend, devices[r], tmp,
                                   timeout_s, tuple(args), model),
                             daemon=True, name=f"seq-rank{r}")
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        first_fail = None
        while any(p.exitcode is None for p in procs):
            now = time.monotonic()
            if first_fail is None and any(p.exitcode not in (None, 0)
                                          for p in procs):
                first_fail = now
            # a failed rank leaves the others in a collective that their
            # timeout ends; give them a moment to report, then stop them
            if now > deadline or (first_fail is not None
                                  and now - first_fail > 10.0):
                break
            time.sleep(0.02)
        late = [r for r, p in enumerate(procs) if p.exitcode is None]
        for p in procs:
            if p.exitcode is None:
                p.kill()
        for p in procs:
            p.join()
        errors = []
        for r, p in enumerate(procs):
            err = Path(tmp) / f"error{r}.txt"
            if err.is_file():
                errors.append(f"rank {r} failed:\n{err.read_text()}")
            elif r in late:
                errors.append(f"rank {r} was killed: the ranks had not all "
                              f"finished within {timeout_s} s")
            elif p.exitcode != 0:
                errors.append(f"rank {r} exited with code {p.exitcode}")
        if errors:
            raise RuntimeError(f"run_ranks({n} ranks, backend={backend!r}): "
                               + "\n".join(errors))
        return [pickle.loads((Path(tmp) / f"result{r}.pkl").read_bytes())
                for r in range(n)]
    finally:
        for p in procs:
            if p.exitcode is None:
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
