"""The static soundness gate of the port: ``python -m
repro_torch.analysis.lint [--json]``.

The port of :mod:`repro.analysis.lint`. Runs the five passes over every
registered target and exits nonzero on any error finding:

1. the plan soundness prover (:mod:`repro_torch.analysis.plan_verify`)
   over the registry's plan targets — coverage, adjoint, per-shard
   exchange, never-drop for the dynamic targets, dynamic full-keep
   replay — and over every prefill chunk slice of the chunk targets;
2. the launch and collective lint (:mod:`repro_torch.analysis
   .launch_lint`): the forward/backward launch contract of
   ``kernels.ops.salo_attention`` for every plan target, and the
   collective dtypes of one train step on each wire (data-parallel f32
   and int8, int8 under a model group, FSDP f32 and int8; under a
   sequence group the MoE, recurrent, VLM and encoder-decoder steps, and
   smollm at dilation 2 with its stride exchanges) and
   of one sharded decode step, on the CPU with recording stand-in groups;
3. slab write ownership (:mod:`repro_torch.analysis.ownership`): the
   sequence-parallel decode's write routing probed over every cache
   position and shard of the registry's paged layouts;
4. the shared-memory budget (:mod:`repro_torch.analysis.smem_budget`):
   every kernel launch of every plan target at head dims 64, 128 and 256
   in f32, bf16 and f16, and every decode instantiation, against the
   H100's per-block limits, with the largest sequence length each
   target's owner-tile sum takes;
5. the stdlib AST code lint (:mod:`repro_torch.analysis.code_lint`) over
   ``src/repro_torch``, ``tools`` and ``chip_smoke.py``.

``--json`` prints the machine-readable report (``{"targets": [...],
"findings": [...], "smem": [...], "summary": {...}}``) instead of the
rendered findings and the checked targets.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path
from typing import List

from repro_torch.analysis import Finding, render

ROOT = Path(__file__).resolve().parents[3]
CODE_PATHS = ("src/repro_torch", "tools", "chip_smoke.py")
# the train steps whose collectives are linted: (name, arch, recording
# groups and shapes; a ``dilation`` there sets the attention's, see
# :func:`train_wire`)
TRAIN_WIRES = (
    ("train.data2", "smollm-135m", dict(data=2)),
    ("train.data2.int8", "smollm-135m", dict(data=2, compress=True)),
    ("train.model2.int8", "smollm-135m", dict(model=2, compress=True)),
    ("train.data2.model2.int8", "smollm-135m",
     dict(data=2, model=2, compress=True)),
    ("train.data2.fsdp", "smollm-135m", dict(data=2, fsdp=True)),
    ("train.data2.fsdp.int8", "smollm-135m",
     dict(data=2, fsdp=True, compress=True)),
    ("train.seq2.moe", "arctic-480b", dict(shards=2, seq=64)),
    ("train.seq2.rec", "recurrentgemma-9b", dict(shards=2, seq=64)),
    ("train.seq2.ssm", "mamba2-370m", dict(shards=2, seq=64)),
    ("train.seq2.vlm", "qwen2-vl-2b", dict(shards=2, seq=64)),
    ("train.seq2.xattn", "whisper-base", dict(shards=2, seq=64)),
    # seq 128: at 64 the one tile the halo would carry is a global tile
    ("train.seq2.dilated", "smollm-135m", dict(shards=2, seq=128,
                                               dilation=2)),
)


def train_wire(entry):
    """(name, smoke config, ``record_train_step``'s keywords) of a
    ``TRAIN_WIRES`` entry: its ``dilation``, where it has one, goes into
    the config (a reordered schedule)."""
    from repro_torch.configs import get_smoke, with_dilation

    name, arch, mesh = entry
    mesh = dict(mesh)
    cfg = get_smoke(arch)
    if "dilation" in mesh:
        cfg = with_dilation(cfg, mesh.pop("dilation"))
    return name, cfg, mesh


def run_plan_pass(findings: List[Finding], targets: List[str]) -> None:
    from repro_torch.analysis import plan_verify as pv
    from repro_torch.analysis.registry import chunk_targets, plan_targets
    from repro_torch.core.scheduler import (build_chunk_plan, build_plan,
                                            schedule)
    from repro_torch.serve.paged_cache import layout_for_pattern

    for t in plan_targets():
        sched = schedule(t.pattern, t.n)
        plan = sched.plan(t.block_q, t.block_k)
        findings += pv.verify_plan(plan, t.name, never_drop=t.dynamic,
                                   local_window=t.local_window)
        if t.dynamic:
            findings += pv.verify_dynamic_full_keep(plan, t.name)
        for S in t.n_shards:
            padded = build_plan(sched, t.block_q, t.block_k,
                                S * math.lcm(t.block_q, t.block_k))
            findings += pv.verify_plan(padded, t.name, n_shards=(S,))
        targets.append(t.name)

    for ct in chunk_targets():
        lay = layout_for_pattern(ct.pattern, ct.page)
        c0 = 0
        while c0 < ct.prompt:
            clen = min(ct.chunk, ct.prompt - c0)
            cp = build_chunk_plan(ct.pattern, c0, clen, n_sink=lay.n_sink,
                                  ring_cap=lay.ring_cap, block=ct.page)
            findings += pv.verify_chunk(
                cp, f"{ct.name}[{c0}:{c0 + clen}]", n_shards=ct.n_shards)
            c0 += clen
        targets.append(ct.name)


def run_launch_pass(findings: List[Finding], targets: List[str]) -> None:
    """The launch contract for every plan target and the collective
    dtypes, on the CPU (``chip_smoke.py``'s analysis phase holds the
    contract on the card)."""
    from repro_torch.analysis import launch_lint as ll
    from repro_torch.analysis.registry import plan_targets

    for t in plan_targets():
        findings += ll.check_launch_contract(
            t.pattern, t.n, t.block_q, t.block_k, f"kernels.ops[{t.name}]")
        targets.append(f"kernels.ops[{t.name}]")

    from repro_torch.configs import get_smoke
    for entry in TRAIN_WIRES:
        name, cfg, mesh = train_wire(entry)
        log, n_groups = ll.record_train_step(cfg, **mesh)
        findings += ll.check_train_wire(log, mesh.get("compress", False),
                                        n_groups, name, mesh.get("data", 1))
        if mesh.get("shards", 1) > 1 and cfg.moe is not None:
            findings += ll.check_seq_gathers(log, name)
        elif mesh.get("shards", 1) > 1 and ll.recurrent_layers(cfg):
            findings += ll.check_seq_carries(log, name,
                                             ll.recurrent_layers(cfg))
        elif mesh.get("shards", 1) > 1 and cfg.salo.dilation > 1:
            findings += ll.check_seq_exchanges(
                log, name, ll.attention_layers(cfg),
                ll.stride_exchanges(cfg))
        elif mesh.get("shards", 1) > 1:
            findings += ll.check_seq_halos(log, name,
                                           ll.attention_layers(cfg))
        targets.append(name)
    findings += ll.check_decode_merge(
        ll.record_decode_step(get_smoke("smollm-135m")),
        "engine.decode@2shards")
    targets.append("engine.decode@2shards")


def run_ownership_pass(findings: List[Finding], targets: List[str]) -> None:
    from repro_torch.analysis.ownership import check_write_ownership
    from repro_torch.analysis.registry import ownership_targets
    from repro_torch.serve.paged_cache import layout_for_pattern

    for t in ownership_targets():
        lay = layout_for_pattern(t.pattern, t.page, shards=t.shards)
        findings += check_write_ownership(lay, t.name)
        targets.append(t.name)


def run_smem_pass(findings: List[Finding], targets: List[str]) -> list:
    """The shared-memory budget; returns its one row a target."""
    from repro_torch.analysis.registry import plan_targets
    from repro_torch.analysis.smem_budget import check_budget

    got, rows = check_budget(plan_targets())
    findings += got
    targets += [r["target"] for r in rows] + ["smem[decode]"]
    return rows


def run_code_pass(findings: List[Finding], targets: List[str]) -> None:
    from repro_torch.analysis.code_lint import lint_paths
    findings += lint_paths([str(ROOT / p) for p in CODE_PATHS])
    targets += list(CODE_PATHS)


def collect() -> dict:
    """Run every pass; the report dict the CLI prints."""
    findings: List[Finding] = []
    targets: List[str] = []
    run_plan_pass(findings, targets)
    run_launch_pass(findings, targets)
    run_ownership_pass(findings, targets)
    smem = run_smem_pass(findings, targets)
    run_code_pass(findings, targets)
    errors = [f for f in findings if f.severity == "error"]
    by_pass: dict = {}
    for f in findings:
        by_pass[f.pass_name] = by_pass.get(f.pass_name, 0) + 1
    return {
        "targets": targets,
        "findings": [f.as_dict() for f in findings],
        "smem": smem,
        "summary": {
            "targets_checked": len(targets),
            "findings": len(findings),
            "errors": len(errors),
            "by_pass": by_pass,
            "plans_sound": 1.0 if not errors else 0.0,
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="static soundness gate of the port: plan prover + "
                    "launch and collective lint + write ownership + "
                    "shared-memory budget + code lint")
    ap.add_argument("--json", action="store_true",
                    help="print the JSON report instead of the findings")
    args = ap.parse_args(argv)

    report = collect()
    s = report["summary"]
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        findings = [Finding(**d) for d in report["findings"]]
        if findings:
            print(render(findings))
        print("targets: " + ", ".join(report["targets"]))
        for r in report["smem"]:
            print(f"{r['target']}: blocks {r['blocks'][0]}/{r['blocks'][1]}"
                  f", n {r['n']}: {r['rows']} packed rows; largest launch "
                  f"{r['largest']} {r['largest_bytes']} bytes; the owner "
                  f"sum takes n up to {r['owner_sum_max_n'] or 'its grid'}")
        print(f"checked {s['targets_checked']} targets: "
              f"{s['errors']} errors, {s['findings']} findings")
    return 1 if s["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
