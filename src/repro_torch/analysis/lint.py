"""The static soundness gate of the port: ``python -m
repro_torch.analysis.lint [--json]``.

The port of :mod:`repro.analysis.lint`. Runs the three passes over every
registered target and exits nonzero on any error finding:

1. the plan soundness prover (:mod:`repro_torch.analysis.plan_verify`)
   over the registry's plan targets — coverage, adjoint, per-shard
   exchange, never-drop for the dynamic targets, dynamic full-keep
   replay — and over every prefill chunk slice of the chunk targets;
2. the launch and collective lint (:mod:`repro_torch.analysis
   .launch_lint`): the forward/backward launch contract of
   ``kernels.ops.salo_attention`` for every plan target, and the
   collective dtypes of one train step on each wire (data-parallel f32
   and int8, int8 under a model group, FSDP f32 and int8) and of one
   sharded decode step, on the CPU with recording stand-in groups;
3. the stdlib AST code lint (:mod:`repro_torch.analysis.code_lint`) over
   ``src/repro_torch``, ``tools`` and ``chip_smoke.py``.

``--json`` prints the machine-readable report (``{"targets": [...],
"findings": [...], "summary": {...}}``) instead of the rendered
findings.
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
# the train steps whose collectives are linted: (name, recording mesh)
TRAIN_WIRES = (
    ("train.data2", dict(data=2)),
    ("train.data2.int8", dict(data=2, compress=True)),
    ("train.model2.int8", dict(model=2, compress=True)),
    ("train.data2.model2.int8", dict(data=2, model=2, compress=True)),
    ("train.data2.fsdp", dict(data=2, fsdp=True)),
    ("train.data2.fsdp.int8", dict(data=2, fsdp=True, compress=True)),
)


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
    cfg = get_smoke("smollm-135m")
    for name, mesh in TRAIN_WIRES:
        log, n_groups = ll.record_train_step(cfg, **mesh)
        findings += ll.check_train_wire(log, mesh.get("compress", False),
                                        n_groups, name, mesh.get("data", 1))
        targets.append(name)
    findings += ll.check_decode_merge(ll.record_decode_step(cfg),
                                      "engine.decode@2shards")
    targets.append("engine.decode@2shards")


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
    run_code_pass(findings, targets)
    errors = [f for f in findings if f.severity == "error"]
    by_pass: dict = {}
    for f in findings:
        by_pass[f.pass_name] = by_pass.get(f.pass_name, 0) + 1
    return {
        "targets": targets,
        "findings": [f.as_dict() for f in findings],
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
                    "launch and collective lint + code lint")
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
        print(f"checked {s['targets_checked']} targets: "
              f"{s['errors']} errors, {s['findings']} findings")
    return 1 if s["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
