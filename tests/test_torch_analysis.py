"""``repro_torch.analysis`` against the reference's ``repro.analysis``,
on the CPU.

* The plan prover: for every registry target (plans, padded sharded
  plans, dynamic targets, every prefill chunk slice) the port's findings
  on its own plans equal the reference's on its plans, both empty.
* Every seeded mutation of ``tests/test_analysis.py`` (dropped tile,
  duplicated tile, wrong flag, transposed row swap, broken halo hop,
  unfilled view slot), applied alike to both packages' plans, gives the
  same findings, counterexample for counterexample.
* The reference's hypothesis property tests on the port: random
  patterns prove sound (and equal to the reference's findings), and a
  random dropped step is caught.
* The code lint: the port's files (``src/repro_torch``, ``tools``,
  ``chip_smoke.py``) are clean; a synthetic source gets the reference's
  findings.
* The launch lint: the launch contract holds for every registry target
  (plain calls on the CPU); a launch added to the forward is caught. The
  collective dtypes of one train step on each wire and of one sharded
  decode step are clean; an f32 payload injected on the compressed wire
  (the gather and the FSDP ``all_to_all``), a gradient sum in bf16 and a
  merge of bf16 partials are caught.
* ``python -m repro_torch.analysis.lint`` exits 0.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.analysis import Finding, plan_verify as pv, render
from repro_torch.analysis import launch_lint as ll
from repro_torch.analysis.code_lint import lint_paths, lint_source
from repro_torch.analysis.registry import chunk_targets, plan_targets
from repro_torch.core import patterns as P
from repro_torch.core.scheduler import build_chunk_plan, build_plan, schedule

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ModuleNotFoundError:
    HAVE_HYPOTHESIS = False


def _ref():
    from repro.analysis import plan_verify as jpv
    from repro.core import patterns as JP
    from repro.core import scheduler as JS
    return jpv, JP, JS


def _dicts(findings):
    return [f.as_dict() for f in findings]


def _target_findings(t, verify, sched_mod):
    """Every plan proof of one registry target, as the gate runs it."""
    sched = sched_mod.schedule(t.pattern, t.n)
    plan = sched.plan(t.block_q, t.block_k)
    out = verify.verify_plan(plan, t.name, never_drop=t.dynamic,
                             local_window=t.local_window)
    if t.dynamic:
        out += verify.verify_dynamic_full_keep(plan, t.name)
    for S in t.n_shards:
        padded = sched_mod.build_plan(sched, t.block_q, t.block_k,
                                      S * math.lcm(t.block_q, t.block_k))
        out += verify.verify_plan(padded, t.name, n_shards=(S,))
    return out


@pytest.mark.parametrize("i", range(len(plan_targets())))
def test_registry_target_findings_are_the_references(i):
    from repro.analysis.registry import plan_targets as jtargets
    jpv, _, JS = _ref()
    import repro_torch.core.scheduler as S

    t, jt = plan_targets()[i], jtargets()[i]
    assert t.name == jt.name
    got = _dicts(_target_findings(t, pv, S))
    assert got == _dicts(_target_findings(jt, jpv, JS)) == []


def _chunk_findings(ct, verify, build, layout_for_pattern):
    lay = layout_for_pattern(ct.pattern, ct.page)
    out, c0 = [], 0
    while c0 < ct.prompt:
        clen = min(ct.chunk, ct.prompt - c0)
        cp = build(ct.pattern, c0, clen, n_sink=lay.n_sink,
                   ring_cap=lay.ring_cap, block=ct.page)
        out += verify.verify_chunk(cp, f"{ct.name}[{c0}:{c0 + clen}]",
                                   n_shards=ct.n_shards)
        c0 += clen
    return out


@pytest.mark.parametrize("i", range(len(chunk_targets())))
def test_chunk_target_findings_are_the_references(i):
    from repro.analysis.registry import chunk_targets as jtargets
    from repro.serve.paged_cache import layout_for_pattern as jlay

    from repro_torch.serve.paged_cache import layout_for_pattern
    jpv, _, JS = _ref()
    ct, jct = chunk_targets()[i], jtargets()[i]
    assert ct.name == jct.name
    got = _dicts(_chunk_findings(ct, pv, build_chunk_plan,
                                 layout_for_pattern))
    assert got == _dicts(_chunk_findings(jct, jpv, JS.build_chunk_plan,
                                         jlay)) == []


# ---------------------------------------------------------------------- #
# Seeded mutations, applied alike to both packages' plans
# ---------------------------------------------------------------------- #
def _plans(pad=None, n=256, bq=32, bk=32):
    """(the port's plan, the reference's plan) of the reference tests'
    longformer(64, 8) geometry."""
    _, JP, JS = _ref()
    out = []
    for pat, S in ((P.longformer(64, n_global=8), schedule),
                   (JP.longformer(64, n_global=8), JS.schedule)):
        sched = S(pat, n)
        out.append(sched.plan(bq, bk) if pad is None else
                   (build_plan if S is schedule else JS.build_plan)(
                       sched, bq, bk, pad))
    return out


def _drop_covering_step(plan):
    kv, fl = plan.kv_blocks.copy(), plan.flags.copy()
    i, s = next((i, s) for i in range(plan.nq)
                for s in range(int(plan.num_steps[i]))
                if kv[i, s] == i and fl[i, s] != 0)
    kv[i, s] = 0
    fl[i, s] = 0
    return dataclasses.replace(plan, kv_blocks=kv, flags=fl), i


def _duplicate(plan):
    kv, fl = plan.kv_blocks.copy(), plan.flags.copy()
    r = int(np.nonzero(plan.num_steps < plan.max_steps)[0][0])
    ns = int(plan.num_steps[r])
    kv[r, ns], fl[r, ns] = kv[r, 0], fl[r, 0]
    return dataclasses.replace(plan, kv_blocks=kv, flags=fl)


def _wrong_flag(plan):
    kv, fl = plan.kv_blocks.copy(), plan.flags.copy()
    i, s = (int(x) for x in np.argwhere(fl == 1)[0])
    fl[i, s] = 2
    return dataclasses.replace(plan, kv_blocks=kv, flags=fl)


def _swap_rows(tp):
    qb, fl, ns = (tp.q_blocks.copy(), tp.flags.copy(), tp.num_steps.copy())
    qb[[0, 1]], fl[[0, 1]], ns[[0, 1]] = qb[[1, 0]], fl[[1, 0]], ns[[1, 0]]
    return dataclasses.replace(tp, q_blocks=qb, flags=fl, num_steps=ns)


def _break_hop(sp):
    vm = np.asarray(sp.view_map)
    send = tuple(a.copy() for a in sp.send_idx)
    off = sp.nkb_l
    for d_i, T in enumerate(sp.halo_counts):
        for s in range(sp.n_shards):
            for slot in range(T):
                gt = int(vm[s, off + slot])
                if gt >= 0:
                    owner = gt // sp.nkb_l
                    send[d_i][owner, slot] = \
                        (send[d_i][owner, slot] + 1) % sp.nkb_l
                    return dataclasses.replace(sp, send_idx=send), gt
        off += T
    raise AssertionError("config must produce halo traffic")


def _unfill(sp):
    vm = np.asarray(sp.view_map).copy()
    used = np.unique(np.asarray(sp.tables)[np.asarray(sp.flags) != 0])
    vm[:, int(used[-1])] = -1
    return dataclasses.replace(sp, view_map=vm)


def _mutated(name):
    """(the port's findings, the reference's) for one mutation class."""
    jpv, _, _ = _ref()
    out, extra = [], []
    if name in ("halo", "unfilled"):
        from repro.dist.sharded_plan import shard_plan as jshard

        from repro_torch.dist.sharded_plan import shard_plan
        for plan, verify, shard in zip(_plans(pad=64), (pv, jpv),
                                       (shard_plan, jshard)):
            sp = shard(plan, 2)
            if name == "halo":
                mut, gt = _break_hop(sp)
                extra.append(gt)
            else:
                mut = _unfill(sp)
            out.append(verify.verify_sharded(plan, 2, mut, "mut"))
        return out, extra
    for plan, verify in zip(_plans(), (pv, jpv)):
        if name == "dropped":
            mut, i = _drop_covering_step(plan)
            extra.append(i)
            out.append(verify.verify_coverage(mut, "mut"))
        elif name == "duplicated":
            out.append(verify.verify_coverage(_duplicate(plan), "mut"))
        elif name == "flag":
            out.append(verify.verify_coverage(_wrong_flag(plan), "mut"))
        else:
            out.append(verify.verify_transposed(
                plan, _swap_rows(plan.transposed()), "mut"))
    return out, extra


@pytest.mark.parametrize("name,needle", [
    ("dropped", "missing"), ("duplicated", "double-counted"),
    ("flag", "missing"), ("transposed", "transposed walk"),
    ("halo", "no scheduled ppermute hop delivers"),
    ("unfilled", "no exchange ever fills")])
def test_mutation_findings_are_the_references(name, needle):
    (got, want), extra = _mutated(name)
    assert got, f"{name} not caught"
    assert _dicts(got) == _dicts(want)
    assert any(needle in f.message for f in got)
    if name == "dropped":
        assert extra[0] == extra[1] == got[0].q_block
        assert f"q_block={got[0].q_block}" in got[0].counterexample()
    if name == "halo":
        assert extra[0] == extra[1]
        assert any(needle in f.message and f.kv_block == extra[0]
                   for f in got)


def test_finding_counterexample_and_render():
    f = Finding("coverage", "t", "msg", q_block=3, kv_block=7)
    assert "(q_block=3, kv_block=7)" in f.counterexample()
    assert Finding(**f.as_dict()) == f
    assert "coverage" in render([f])
    assert render([]) == ""


# ---------------------------------------------------------------------- #
# The reference's property tests, on the port
# ---------------------------------------------------------------------- #
@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
def test_property_random_patterns_prove_sound():
    jpv, JP, JS = _ref()

    @settings(max_examples=15, deadline=None)
    @given(window=st.integers(4, 24), n_global=st.integers(0, 6),
           causal=st.booleans(), dilation=st.sampled_from([1, 2]),
           block=st.sampled_from([8, 16]))
    def inner(window, n_global, causal, dilation, block):
        got = []
        for mod, verify, sch in ((P, pv, schedule), (JP, jpv, JS.schedule)):
            if dilation > 1:
                pat = mod.causal_sliding_window(window, n_sinks=n_global,
                                                dilation=dilation)
            else:
                pat = mod.longformer(2 * window, n_global=n_global,
                                     causal=causal)
            plan = sch(pat, 96).plan(block, block)
            got.append(_dicts(verify.verify_coverage(plan)
                              + verify.verify_transposed(plan)
                              + verify.verify_packed(plan)))
        assert got[0] == got[1] == []
    inner()


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
def test_property_random_step_drop_is_caught():
    @settings(max_examples=10, deadline=None)
    @given(row=st.integers(0, 7))
    def inner(row):
        plan = schedule(P.longformer(64, n_global=8), 256).plan(32, 32)
        kv, fl = plan.kv_blocks.copy(), plan.flags.copy()
        r = row % plan.nq
        s = int(np.nonzero(fl[r])[0][0])
        kv[r, s], fl[r, s] = 0, 0
        mut = dataclasses.replace(plan, kv_blocks=kv, flags=fl)
        assert pv.verify_coverage(mut) or pv.verify_transposed(
            plan, mut.transposed())
    inner()


# ---------------------------------------------------------------------- #
# Code lint
# ---------------------------------------------------------------------- #
def test_code_lint_port_clean():
    from repro_torch.analysis.lint import CODE_PATHS, ROOT
    assert lint_paths([str(ROOT / p) for p in CODE_PATHS]) == []


def test_code_lint_findings_are_the_references():
    from repro.analysis.code_lint import lint_source as jlint
    src = ("import os\nfrom typing import List\ndef f(x=[]):\n    try:\n"
           "        pass\n    except:\n        pass\nlist = 3\n"
           "__all__ = ['nothing']\n")
    got = _dicts(lint_source(src, "x.py"))
    assert got == _dicts(jlint(src, "x.py"))
    assert len(got) == 6


# ---------------------------------------------------------------------- #
# Launch lint
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("i", range(len(plan_targets())))
def test_launch_contract_holds_for_every_target(i):
    t = plan_targets()[i]
    c = ll.count_launches(t.pattern, t.n, t.block_q, t.block_k)
    assert c == {"forward": 1, "forward_kernels": (1, 0, 0), "grad": 3,
                 "grad_kernels": (1, 1, 1)}
    assert ll.check_launch_contract(t.pattern, t.n, t.block_q, t.block_k,
                                    t.name, counts=c) == []


def test_a_launch_added_to_the_forward_is_caught(monkeypatch):
    from repro_torch.kernels import ops

    real = ops._forward

    def twice(*a):
        real(*a)
        return real(*a)

    monkeypatch.setattr(ops, "_forward", twice)
    got = ll.check_launch_contract(P.longformer(32, n_global=4), 128, 32,
                                   32, "t")
    msgs = [f.message for f in got]
    assert any("forward books 2 kernel launches" in m for m in msgs)
    assert any("gradient books 4" in m for m in msgs)
    assert any("(2, 0, 0) times" in m for m in msgs)


def _cfg():
    from repro_torch.configs import get_smoke
    return get_smoke("smollm-135m")


@pytest.mark.parametrize("i", range(len(
    __import__("repro_torch.analysis.lint",
               fromlist=["TRAIN_WIRES"]).TRAIN_WIRES)))
def test_train_step_collectives_are_clean(i):
    from repro_torch.analysis.lint import TRAIN_WIRES
    name, mesh = TRAIN_WIRES[i]
    log, n_groups = ll.record_train_step(_cfg(), **mesh)
    assert ll.check_train_wire(log, mesh.get("compress", False), n_groups,
                               name, mesh.get("data", 1)) == []
    dtypes = {(r[0], r[1], r[2]) for r in log if r[4] == "wire"}
    if mesh.get("compress") and mesh.get("data", 1) > 1:
        op = "all_to_all" if mesh.get("fsdp") else "all_gather"
        assert ("data", op, "int8") in dtypes
        assert ("data", "all_gather", "float32") in dtypes
    if mesh.get("compress") and mesh.get("model", 1) > 1:
        assert ("model", "all_reduce_max", "float32") in dtypes


@pytest.mark.parametrize("fsdp", [False, True])
def test_an_f32_payload_on_the_wire_is_caught(monkeypatch, fsdp):
    from repro_torch.dist import compression as C

    name = "_split_sum" if fsdp else "_gathered_sum"
    real = getattr(C, name)

    def leak(group, q, *rest):
        group.all_gather(q.float())
        return real(group, q, *rest)

    monkeypatch.setattr(C, name, leak)
    log, n_groups = ll.record_train_step(_cfg(), data=2, fsdp=fsdp,
                                         compress=True)
    got = ll.check_train_wire(log, True, n_groups, "t", 2)
    assert len(got) == 1 and "float32 payload" in got[0].message


def test_a_bf16_gradient_sum_is_caught(monkeypatch):
    from repro_torch.train import trainer

    real = trainer._psum_flat_

    def bf16(grads, group, *a):
        leaves = [g for g in trainer.tree_leaves(grads)]
        group.psum_(torch.cat([g.reshape(-1) for g in leaves]).bfloat16())
        return real(grads, group, *a)

    monkeypatch.setattr(trainer, "_psum_flat_", bf16)
    log, n_groups = ll.record_train_step(_cfg(), data=2)
    got = ll.check_train_wire(log, False, n_groups, "t", 2)
    assert any("bfloat16" in f.message for f in got)


def test_decode_merge_is_f32_and_a_bf16_merge_is_caught(monkeypatch):
    cfg = _cfg()
    log = ll.record_decode_step(cfg)
    assert ll.check_decode_merge(log, "d") == []
    assert {r[1] for r in log if r[4] == "merge"} == {"all_reduce_max",
                                                      "all_reduce_sum"}
    from repro_torch.dist import sharded_plan

    def low(out, m, l, group, return_stats=False):
        group.psum_(out.bfloat16())
        return sharded_plan.masked_psum_merge(out, m, l, group,
                                              return_stats)

    from repro_torch.models import layers
    monkeypatch.setattr(layers, "masked_psum_merge", low)
    got = ll.check_decode_merge(ll.record_decode_step(cfg), "d")
    assert got and "bfloat16" in got[0].message


def test_lint_cli_exits_zero(capsys):
    from repro_torch.analysis.lint import main
    assert main([]) == 0
    assert "0 errors, 0 findings" in capsys.readouterr().out
