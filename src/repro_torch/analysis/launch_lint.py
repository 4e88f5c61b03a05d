"""The GPU's counterpart of the reference's jaxpr effect linter
(:mod:`repro.analysis.jaxpr_lint`): the checks of it that still mean
something where eager PyTorch launches hand-written kernels and
``torch.distributed`` runs the collectives.

* **launch contract** (:func:`check_launch_contract`, the reference's
  ``check_launch_contract``): one forward of
  :func:`repro_torch.kernels.ops.salo_attention` books exactly
  ``LAUNCH_CONTRACT["forward"]`` launches in the registry counters that
  ``ops._launch_accounting`` increments, and one forward + backward
  ``LAUNCH_CONTRACT["grad"]`` (K1 + K2 + K3: the backward never re-runs
  the forward). The kernels' own counts are held too: on CUDA tensors
  the wrappers' ``launches`` (K3 launches twice a call: its row walk and
  the owner-tile sum), on the CPU their plain versions' ``calls``.
* **collective dtypes** (:func:`check_train_wire`,
  :func:`check_decode_merge`; the reference's ``check_psum_dtype``): every
  collective of one train step and of one sharded decode step is
  recorded with its op, dtype and element count by stand-in groups
  (:class:`RecDataGroup`, :class:`RecModelGroup`, :class:`RecSeqGroup`)
  that run in one process as :class:`~repro_torch.dist.group.StackedGroup`
  does, each computing its collectives as if every rank held this rank's
  tensors. The rules: the compressed wire (data-parallel, under a model
  group, and under the FSDP fallback) sends int8 values and f32 scales,
  and no float gradient crosses the data group; the uncompressed
  gradient sum is f32; the sharded merge's partials ``(out, m, l)`` are
  f32.

The reference's scatter-mode, double-dequant, shard_map-reduction and
VMEM checks read a jaxpr and have no counterpart here; its
write-ownership probe and a per-launch shared-memory budget are left to
a later port (ROADMAP queue 1, item 4).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.analysis import Finding
from repro_torch.dist.group import DataGroup, ModelGroup, SeqGroup

Record = Tuple[str, str, str, int, Optional[str]]   # axis, op, dtype, n, site
_SITE: List[Optional[str]] = [None]

# the registry's kernel labels of the training op, in launch order
KERNELS = ("salo_table_attention", "salo_table_backward_dq",
           "salo_table_backward_dkv")


# ---------------------------------------------------------------------- #
# Launch contract
# ---------------------------------------------------------------------- #
def _registry_launches() -> Dict[str, float]:
    from repro_torch.obs.metrics import global_registry
    reg = global_registry()
    if "kernel_launches" not in reg.families():
        return {k: 0.0 for k in KERNELS}
    return {k: reg.value("kernel_launches", kernel=k) for k in KERNELS}


def _kernel_counts(cuda: bool) -> Tuple[int, int, int]:
    """(K1, K2, K3) counts: the wrappers' launches on the card, their
    plain versions' calls on the CPU."""
    from repro_torch.kernels import salo_attention as A
    from repro_torch.kernels import salo_backward as B
    if cuda:
        return (A.salo_table_attention.launches,
                B.salo_table_backward_dq.launches,
                B.salo_table_backward_dkv.launches)
    return (A.salo_table_attention_plain.calls,
            B.salo_table_backward_dq_plain.calls,
            B.salo_table_backward_dkv_plain.calls)


def count_launches(pattern, n: int, block_q: int, block_k: int,
                   device="cpu", dtype=torch.float32, d: int = 16) -> dict:
    """One forward and one forward + backward of ``salo_attention`` on
    ``(1, n, d)`` tensors on ``device``: the registry's launches of each
    (summed over the kernels) and the kernels' own counts (K1, K2, K3)."""
    from repro_torch.kernels.ops import salo_attention

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, n, d), generator=gen).to(dev, dtype)
               for _ in range(3))
    out = {}
    for what in ("forward", "grad"):
        reg0, dev0 = _registry_launches(), _kernel_counts(cuda)
        if what == "forward":
            with torch.no_grad():
                salo_attention(q, k, v, pattern, block_q, block_k)
        else:
            qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
            salo_attention(qq, kk, vv, pattern, block_q,
                           block_k).float().sum().backward()
        if cuda:
            torch.cuda.synchronize(dev)
        reg1, dev1 = _registry_launches(), _kernel_counts(cuda)
        out[what] = int(sum(reg1[x] - reg0[x] for x in KERNELS))
        out[what + "_kernels"] = tuple(b - a for a, b in zip(dev0, dev1))
    return out


def check_launch_contract(pattern, n: int, block_q: int, block_k: int,
                          target: str = "", device="cpu",
                          counts: Optional[dict] = None) -> List[Finding]:
    """Forward = ``LAUNCH_CONTRACT["forward"]`` registry launches (K1
    once), forward + backward = ``LAUNCH_CONTRACT["grad"]`` (K1, K2 and
    K3 once each; on the card K3's wrapper launches twice). ``counts``:
    :func:`count_launches`'s result, taken here when None."""
    from repro_torch.kernels.ops import LAUNCH_CONTRACT

    c = count_launches(pattern, n, block_q, block_k, device) \
        if counts is None else counts
    cuda = torch.device(device).type == "cuda"
    findings: List[Finding] = []
    if c["forward"] != LAUNCH_CONTRACT["forward"]:
        findings.append(Finding(
            "launch-contract", target,
            f"forward books {c['forward']} kernel launches, the fused "
            f"single-launch contract requires exactly "
            f"{LAUNCH_CONTRACT['forward']}"))
    if c["grad"] != LAUNCH_CONTRACT["grad"]:
        findings.append(Finding(
            "launch-contract", target,
            f"gradient books {c['grad']} kernel launches, the "
            f"no-forward-recompute contract requires exactly "
            f"{LAUNCH_CONTRACT['grad']} (fwd + dQ + dK/dV)"))
    want = {"forward_kernels": (1, 0, 0),
            "grad_kernels": (1, 1, 2 if cuda else 1)}
    for key, w in want.items():
        if tuple(c[key]) != w:
            findings.append(Finding(
                "launch-contract", target,
                f"{key.split('_')[0]} ran the kernels (K1, K2, K3) "
                f"{tuple(c[key])} times, expected {w}"
                + (" (kernel launches)" if cuda else " (plain calls)")))
    return findings


# ---------------------------------------------------------------------- #
# Recording stand-in groups
# ---------------------------------------------------------------------- #
class _Recording:
    """Collectives recorded as ``(axis, op, dtype, numel, site)`` into
    ``self.log`` and computed in this process as if every rank of the
    group held this rank's tensors (``site``: the step's phase the lint
    marks, :func:`_sites`)."""
    axis = ""

    def _rec(self, op: str, t: torch.Tensor) -> None:
        self.log.append((self.axis, op, str(t.dtype).replace("torch.", ""),
                         t.numel(), _SITE[-1]))

    def psum_(self, t: torch.Tensor) -> torch.Tensor:
        self._rec("all_reduce_sum", t)
        return t.mul_(self.size)

    def pmax_(self, t: torch.Tensor) -> torch.Tensor:
        self._rec("all_reduce_max", t)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        self._rec("all_gather", t)
        return t.reshape(1, *t.shape).expand(self.size, *t.shape).clone()

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        self._rec("all_to_all", t)
        part = t.reshape(self.size, -1)[self.index]
        return part.reshape(1, -1).expand(self.size, -1).clone()

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        self._rec("reduce_scatter", t)
        return (t.chunk(self.size, dim)[self.index] * self.size).contiguous()

    def ppermute(self, buf: torch.Tensor, perm) -> torch.Tensor:
        self._rec("ppermute", buf)
        got = any(d == self.index for _, d in perm)
        return buf.clone() if got else torch.zeros_like(buf)

    def agree(self, value: float) -> float:
        self._rec("all_reduce_max", torch.zeros(1, dtype=torch.float64))
        return float(value)


@dataclasses.dataclass(frozen=True)
class RecDataGroup(_Recording, DataGroup):
    """A recording :class:`~repro_torch.dist.group.DataGroup`."""
    log: list = dataclasses.field(default_factory=list, compare=False)
    axis = "data"


@dataclasses.dataclass(frozen=True)
class RecModelGroup(_Recording, ModelGroup):
    """A recording :class:`~repro_torch.dist.group.ModelGroup`."""
    log: list = dataclasses.field(default_factory=list, compare=False)
    axis = "model"


@dataclasses.dataclass(frozen=True)
class RecSeqGroup(_Recording, SeqGroup):
    """A recording :class:`~repro_torch.dist.group.SeqGroup`."""
    log: list = dataclasses.field(default_factory=list, compare=False)
    axis = "seq"


def rec_group(cls, size: int, log: list):
    """A recording group of ``size`` CPU ranks, this one rank 0, sharing
    the record list ``log``."""
    return cls(None, 0, size, torch.device("cpu"), "gloo", log)


@contextlib.contextmanager
def _site(name: str):
    _SITE.append(name)
    try:
        yield
    finally:
        _SITE.pop()


def _marked(fn, name: str):
    def call(*a, **k):
        with _site(name):
            return fn(*a, **k)
    return call


@contextlib.contextmanager
def _sites():
    """Mark the phases of a train step and of a decode step: the int8
    wire (``compression``'s two entry points), the gradient sums
    (``trainer._psum_flat_``), the clip's norm and the sharded merge."""
    from repro_torch.dist import compression, sharded_plan
    from repro_torch.models import layers
    from repro_torch.optim import adamw
    from repro_torch.train import trainer

    patches = [(compression, "compressed_psum_with_residual", "wire"),
               (compression, "compress_decompress", "wire"),
               (trainer, "_psum_flat_", "grad-sum"),
               (adamw, "global_norm", "norm"),
               (sharded_plan, "masked_psum_merge", "merge"),
               (layers, "masked_psum_merge", "merge")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, site in patches:
            setattr(mod, name, _marked(getattr(mod, name), site))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# ---------------------------------------------------------------------- #
# One train step, one sharded decode step
# ---------------------------------------------------------------------- #
def record_train_step(cfg, *, data: int = 1, model: int = 1,
                      fsdp: bool = False, compress: bool = False,
                      seq: int = 32, batch: int = 4
                      ) -> Tuple[List[Record], int]:
    """(every collective of one train step of ``cfg`` on the CPU, rank 0
    of a ``(data, model)`` mesh of recording groups; the number of the
    wire's scale groups)."""
    from repro_torch.dist.compression import scale_groups
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import (TrainConfig, init_shards,
                                           make_train_step)

    log: list = []
    dg = rec_group(RecDataGroup, data, log) if data > 1 else None
    mg = rec_group(RecModelGroup, model, log) if model > 1 else None
    m = build_model(cfg, "cpu")
    tcfg = TrainConfig(compress_grads=compress)
    gen = torch.Generator().manual_seed(0)
    params = init_shards(m, gen, mg, dg, fsdp) if (mg or fsdp) \
        else m.init(gen)
    opt = adamw.init(tcfg.optimizer, params)
    step = make_train_step(m, tcfg, data=dg, model_group=mg, fsdp=fsdp)
    b = SyntheticLM(cfg, DataConfig(seq, batch, seed=0, branch=2,
                                    n_docs=4)).batch(0)
    del log[:]
    with _sites():
        step(params, opt, b, None)
    return list(log), scale_groups(params)[1]


def record_decode_step(cfg, shards: int = 2) -> List[Record]:
    """Every collective of the sharded continuous engine's decode steps
    of one short request on the CPU, rank 0 of a recording sequence
    group of ``shards``."""
    from repro_torch.models.layers import salo_pattern
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ContinuousConfig, ContinuousEngine
    from repro_torch.serve.paged_cache import layout_for_pattern

    log: list = []
    group = rec_group(RecSeqGroup, shards, log)
    lay = layout_for_pattern(salo_pattern(cfg, causal=True), 8,
                             shards=shards)
    m = build_model(cfg, "cpu")
    eng = ContinuousEngine(m, ContinuousConfig(
        n_pages=1 + 2 * lay.pages_per_shard, page=8, chunk=8, max_batch=2,
        seq_shards=shards), device="cpu", group=group)
    params = m.init(torch.Generator().manual_seed(0))
    decode_fn = eng._decode_fn
    steps: list = []

    def marked(*a, **k):
        steps.append(len(log))
        with _site("decode"):
            return decode_fn(*a, **k)

    eng._decode_fn = marked
    eng.submit(list(range(1, 12)), 3)
    with _sites():
        eng.run(params)
    if not steps:
        raise RuntimeError("the engine ran no decode step")
    return [r for r in log[steps[0]:] if r[4] in ("decode", "merge")]


# ---------------------------------------------------------------------- #
# The dtype rules
# ---------------------------------------------------------------------- #
def check_train_wire(log: List[Record], compress: bool, n_groups: int,
                     target: str, data: int) -> List[Finding]:
    """The rules over one train step's records. Compressed: the wire's
    collectives are int8, or f32 of at most ``n_groups`` values (the
    scales, and their MAX over the model group); over ``data`` > 1 ranks
    the wire ran (int8 crossed); no gradient sum and no
    ``reduce_scatter`` crosses the data group. Uncompressed: every
    gradient sum (and every data-group ``reduce_scatter``) is f32."""
    findings: List[Finding] = []
    if compress:
        wire = [r for r in log if r[4] == "wire"]
        if data > 1 and not any(r[2] == "int8" for r in wire):
            findings.append(Finding(
                "collective-dtype", target,
                "the compressed step sent no int8 values: the wire did not "
                "run"))
        for axis, op, dt, n, _ in wire:
            if dt == "int8" or (dt == "float32" and n <= n_groups):
                continue
            findings.append(Finding(
                "collective-dtype", target,
                f"the compressed wire sends a {dt} payload of {n} values "
                f"({op} over {axis}): only int8 values and {n_groups} f32 "
                f"scales may cross"))
        for axis, op, dt, n, site in log:
            if axis == "data" and (site == "grad-sum"
                                   or op == "reduce_scatter"):
                findings.append(Finding(
                    "collective-dtype", target,
                    f"a {dt} gradient of {n} values crosses the data group "
                    f"({op}) beside the int8 wire"))
    else:
        sums = [r for r in log if r[4] == "grad-sum"
                or (r[0] == "data" and r[1] == "reduce_scatter")]
        if not sums:
            findings.append(Finding(
                "collective-dtype", target,
                "the uncompressed step summed no gradient"))
        for axis, op, dt, n, _ in sums:
            if dt != "float32":
                findings.append(Finding(
                    "collective-dtype", target,
                    f"gradient sum over {axis} ({op}) of {n} values in {dt}"
                    f": the sum must be f32"))
    return findings


def check_decode_merge(log: List[Record], target: str = "") -> List[Finding]:
    """The reference's ``check_psum_dtype``: the sharded merge's
    collectives (its MAX and its one SUM of the partials) are f32, and a
    merge ran."""
    merge = [r for r in log if r[4] == "merge"]
    findings: List[Finding] = []
    if not merge:
        findings.append(Finding(
            "collective-dtype", target, "the sharded decode step merged no "
            "partials"))
    for axis, op, dt, n, _ in merge:
        if dt not in ("float32", "float64"):
            findings.append(Finding(
                "collective-dtype", target,
                f"{op} over {axis} of {dt} operand ({n} values): partial "
                f"(out, m, l) stats were downcast before the cross-shard "
                f"merge (must be f32)"))
    return findings
