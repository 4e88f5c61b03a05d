#!/usr/bin/env python3
"""Compare the 16-bit training kernels K1 (forward), K2 (dQ) and K3 (dK/dV)
of several checkouts of this repository on one GPU, in one run.

    python3 tools/ab_backward.py ROOT [ROOT ...] [--rounds 1] [--seed 0]
                                 [--case a]

Each ROOT is a directory holding a checkout's ``src/repro_torch`` (for
example a ``git archive`` unpacked under the git-ignored ``build/``). Every
ROOT's kernels are built first, all at once, and the ptxas registers and
spills of the tensor-core kernels of ``salo_table_attention.cu`` and
``salo_table_backward.cu`` printed. Then each ROOT runs in a process of
its own, in the order ROOT_1 .. ROOT_n, ROOT_n .. ROOT_1 (``--rounds``
times), so that a drift of the card shows as a gap between two visits of
one ROOT. A process times K1, K2 and K3 at ``chip_smoke.py``'s
train-kernels case ``--case`` (by default (a): smollm-135m's pattern, 72
flat heads, n 4096, hd 64, block 256; (f) is gemma-7b's at hd 256), in
bf16 and again in f16, with ``chip_smoke.Timer`` (L2
flushed, calls queued behind a sleep kernel), and reports, not gated, how
far each ROOT's kernels lie from the plain versions: K1's out, m and l,
and K2/K3's gradients, at that case, and K2/K3's at case (c) (ViL, hd 128,
f16) with dout at 2^-20 of unit scale, relative to that scale. The last
lines are one JSON object per visit, the card's name and power limit from
``nvidia-smi``, and a summary JSON line with each ROOT's mean times.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]     # holds chip_smoke.py
SMALL = 2.0 ** -20


def _off_share(torch, dq, dq_f32) -> float:
    """``salo_backward.dq_off_share``, which older checkouts lack."""
    return float((dq != dq_f32.to(dq.dtype)).float().mean())


def _inputs(torch, CS, name, seed, dtype=None):
    from repro_torch.core.blockwise import plan_tables
    from repro_torch.core.scheduler import schedule
    from repro_torch.kernels import salo_attention as KA

    c = CS.TRAIN_CASES[name]
    dtype = dtype or getattr(torch, c["dtype"])
    sched = schedule(CS._case_pattern(c["pat"]), c["n"])
    plan = sched.plan(c["bq"], c["bk"])
    t = plan_tables(plan, torch.device("cuda", 0))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (c["bh"], plan.n_pad, c["hd"])
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    dout = torch.randn(shape, generator=gen, device="cuda")
    pos_q = t.pos.reshape(plan.nq, plan.block_q)
    pos_k = t.pos.reshape(plan.nkb, plan.block_k)
    kw = dict(sched=sched, scale=c["hd"] ** -0.5)
    out, m, l = KA.salo_table_attention_plain(q, k, v, pos_q, pos_k,
                                              t.kv_blocks, t.flags, **kw)
    delta = (dout * out.float()).sum(-1)
    return (dout, delta, m, l, q, k, v, pos_q, pos_k), t, kw


def _fwd_errors(KA, bwd, t, kw):
    """Max |kernel - plain| of K1's out, m and l."""
    fwd = (*bwd[4:], t.kv_blocks, t.flags)
    got = KA.salo_table_attention(*fwd, **kw)
    ref = KA.salo_table_attention_plain(*fwd, **kw)
    return {w: float((a.float() - b.float()).abs().max())
            for w, a, b in zip(("out", "m", "l"), got, ref)}


def _errors(torch, KB, bwd, t, kw, scale=1.0):
    """Max |kernel - plain| of dq, dk, dv (relative to ``scale``) and the
    share of dq off the plain f32 dq rounded to dq's type."""
    dkv_t = (t.row_tile, t.q_blocks, t.pk_flags)
    dq = KB.salo_table_backward_dq(*bwd, t.kv_blocks, t.flags, **kw)
    rdq = KB.salo_table_backward_dq_plain(*bwd, t.kv_blocks, t.flags, **kw)
    dk, dv = KB.salo_table_backward_dkv(*bwd, *dkv_t, **kw)
    rdk, rdv = KB.salo_table_backward_dkv_plain(*bwd, *dkv_t, **kw)
    err = {w: float(((a.float() - b) / scale).abs().max())
           for w, a, b in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv))}
    err["dq_off_share"] = _off_share(torch, dq, rdq)
    return err


def visit(root: Path, seed: int, case: str = "a") -> dict:
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(HERE))
    import torch

    import chip_smoke as CS
    import repro_torch
    from repro_torch.kernels import salo_attention as KA
    from repro_torch.kernels import salo_backward as KB

    src = Path(repro_torch.__file__).resolve()
    assert src.is_relative_to(root.resolve()), f"{src} is not under {root}"
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = CS.Timer(torch)
    rec = {"root": str(root)}
    for dtype, tag in ((torch.bfloat16, ""), (torch.float16, "_f16")):
        bwd, t, kw = _inputs(torch, CS, case, seed + 100, dtype)
        dkv_t = (t.row_tile, t.q_blocks, t.pk_flags)
        fwd = (*bwd[4:], t.kv_blocks, t.flags)
        rec[f"K1{tag}_ms"] = timer(lambda: KA.salo_table_attention(*fwd,
                                                                   **kw))
        rec[f"K2{tag}_ms"] = timer(lambda: KB.salo_table_backward_dq(
            *bwd, t.kv_blocks, t.flags, **kw))
        rec[f"K3{tag}_ms"] = timer(lambda: KB.salo_table_backward_dkv(
            *bwd, *dkv_t, **kw))
        rec[f"{case}{tag or '_bf16'}"] = {**_fwd_errors(KA, bwd, t, kw),
                                     **_errors(torch, KB, bwd, t, kw)}
    cbwd, ct, ckw = _inputs(torch, CS, "c", seed + 102)
    small = (cbwd[0] * SMALL, cbwd[1] * SMALL, *cbwd[2:])
    rec["c_f16_small_dout"] = _errors(torch, KB, small, ct, ckw, SMALL)
    return rec


def _build(roots):
    """Build every ROOT's training kernels at once; print ptxas lines."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import _build; _build.build_all(); "
            "print(_build.build_log('salo_table_attention')); "
            "print(_build.build_log('salo_table_backward'))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r / "src")],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in roots]
    for r, p in zip(roots, procs):
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"build of {r} failed:\n{log}")
        fn = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif ("mma_kernel" in fn and ("registers" in line
                                           or "spill" in line)):
                print(f"[build] {r.name}: {fn}: {line.strip()}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--case", default="a",
                    help="chip_smoke.TRAIN_CASES key whose shapes are timed")
    ap.add_argument("--visit", action="store_true",
                    help=argparse.SUPPRESS)    # one ROOT, in this process
    args = ap.parse_args(argv)
    if args.visit:
        print(json.dumps(visit(args.roots[0], args.seed, args.case)),
              flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("ab_backward: no CUDA device", file=sys.stderr)
        return 2
    roots = [r.resolve() for r in args.roots]
    _build(roots)
    order = (roots + roots[::-1]) * args.rounds
    recs = []
    for r in order:
        p = subprocess.run([sys.executable, __file__, "--visit", str(r),
                            "--seed", str(args.seed), "--case", args.case],
                           capture_output=True, text=True)
        if p.returncode != 0:
            raise SystemExit(f"visit of {r} failed:\n{p.stdout}{p.stderr}")
        rec = json.loads(p.stdout.strip().splitlines()[-1])
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else f"nvidia-smi failed: {smi.stderr}")
    summary = {}
    for r in roots:
        mine = [x for x in recs if x["root"] == str(r)]
        summary[r.name] = {k: sum(x[k] for x in mine) / len(mine)
                           for k in ("K1_ms", "K2_ms", "K3_ms", "K1_f16_ms",
                                     "K2_f16_ms", "K3_f16_ms")}
        summary[r.name]["visits"] = len(mine)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
