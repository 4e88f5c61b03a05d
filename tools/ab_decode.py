#!/usr/bin/env python3
"""Compare the decode kernels K4 (paged slab) and K5 (contiguous caches)
of several checkouts of this repository on one GPU, in one run.

    python3 tools/ab_decode.py ROOT [ROOT ...] [--rounds 1] [--seed 0]

Each ROOT is a directory holding a checkout's ``src/repro_torch`` (for
example a ``git archive`` unpacked under the git-ignored ``build/``). Every
ROOT's decode kernels are built first, all at once, and their ptxas
registers and spills printed. Then each ROOT runs in a process of its own,
in the order ROOT_1 .. ROOT_n, ROOT_n .. ROOT_1 (``--rounds`` times), so
that a drift of the card shows as a gap between two visits of one ROOT. A
process times K4 at ``chip_smoke.py``'s kernel cases (a) bf16, (d) int8 +
page stats, (e) f32 state + page stats and (f) one request, and K5 at its
cases (a) bf16, (b) f32 and (c) ring + dilation, on the same operands for
every ROOT (made by this checkout's ``chip_smoke.py`` from ``--seed``),
with ``chip_smoke.Timer`` (L2 flushed, calls queued behind a sleep
kernel), and reports, not gated, each output's largest distance from the
ROOT's plain version on the live rows. The last lines are one JSON object
per visit, the card's name and power limit from ``nvidia-smi``, and a
summary JSON line with each ROOT's mean times.

    python3 tools/ab_decode.py --sweep [--seed 0]

times, in this checkout only, what sets the floor of K4 at case (a): the
Timer's own floor (one tiny kernel), case (a) with L2 warm (no flush), and
case (a) at forced splits (``plan_splits`` replaced by each
``n_split`` in ``SWEEP``, split length the 16-slot multiple that covers
S), each checked against the plain version.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]     # holds chip_smoke.py
K4_CASES, K5_CASES = ("a", "d", "e", "f"), ("a", "b", "c")
SWEEP = (1, 2, 3, 6, 11, 22, 33, 64)


def _err(torch, got, ref, rows) -> float:
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    n = 3 if len(got) >= 3 else 1              # out[, m, l]; not page_m
    return max(float((a[rows].float() - b[rows].float()).abs().max())
               for a, b in zip(got[:n], ref[:n]))


def visit(root: Path, seed: int) -> dict:
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(HERE))
    import torch

    import chip_smoke as CS
    import repro_torch
    from repro_torch.kernels import salo_decode as SD

    src = Path(repro_torch.__file__).resolve()
    assert src.is_relative_to(root.resolve()), f"{src} is not under {root}"
    timer = CS.Timer(torch)
    rec = {"root": str(root)}
    for i, (name, kw) in enumerate(CS.k4_cases(torch)):
        if name not in K4_CASES:
            continue
        gen = torch.Generator(device="cuda").manual_seed(seed + i)
        pat, ops, (ks, vs) = CS.decode_case(torch, gen, **kw)
        var = dict(pattern=pat, k_scale=ks, v_scale=vs,
                   return_state=kw.get("state", False),
                   return_page_stats=kw.get("stats", False))
        rows = CS.live_mask(torch, pat, ops[4], ops[5]).any(dim=1)
        rec[f"K4{name}_ms"] = timer(lambda: SD.salo_paged_decode(*ops, **var))
        rec[f"K4{name}_err"] = _err(torch, SD.salo_paged_decode(*ops, **var),
                                    SD.salo_paged_decode_plain(*ops, **var),
                                    rows)
    for i, (name, c) in enumerate(CS.k5_cases(torch)):
        if name not in K5_CASES:
            continue
        gen = torch.Generator(device="cuda").manual_seed(seed + 50 + i)
        pat, q, k, v, positions, t = CS.k5_case(torch, gen, c)
        args = (q, k, v, positions, t)
        rec[f"K5{name}_ms"] = timer(lambda: SD.salo_decode(*args,
                                                           pattern=pat))
        rec[f"K5{name}_err"] = _err(torch, SD.salo_decode(*args, pattern=pat),
                                    SD.salo_decode_plain(*args, pattern=pat),
                                    slice(None))
    return rec


def sweep(seed: int) -> dict:
    """The floor of K4 at case (a) in this checkout (``--sweep``)."""
    sys.path.insert(0, str(HERE / "src"))
    sys.path.insert(1, str(HERE))
    import torch

    import chip_smoke as CS
    from repro_torch.kernels import salo_decode as SD

    timer = CS.Timer(torch)
    tiny = torch.zeros(1, device="cuda")
    rec = {"timer_floor_ms": timer(lambda: tiny.add_(1.0))}
    kw = dict(CS.k4_cases(torch))["a"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pat, ops, _ = CS.decode_case(torch, gen, **kw)
    rows = CS.live_mask(torch, pat, ops[4], ops[5]).any(dim=1)
    ref = SD.salo_paged_decode_plain(*ops, pattern=pat)
    rec["a_planned_ms"] = timer(lambda: SD.salo_paged_decode(*ops,
                                                             pattern=pat))
    warm = CS.Timer(torch)
    warm.flush = torch.empty(16, dtype=torch.uint8, device="cuda")
    rec["a_warm_l2_ms"] = warm(lambda: SD.salo_paged_decode(*ops,
                                                            pattern=pat))
    S = ops[4].shape[1]
    planner = SD.split_plan
    try:
        for n in SWEEP:
            length = -(-(-(-S // n)) // 16) * 16
            n_eff = -(-S // length)
            SD.split_plan = lambda *a, _p=(n_eff, length): _p
            ms = timer(lambda: SD.salo_paged_decode(*ops, pattern=pat))
            err = _err(torch, SD.salo_paged_decode(*ops, pattern=pat), ref,
                       rows)
            rec[f"a_split{n_eff}x{length}"] = {"ms": ms, "err": err}
    finally:
        SD.split_plan = planner
    return rec


def _build(roots):
    """Build every ROOT's decode kernels at once; print ptxas lines."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import _build; "
            "[_build.load(n) for n in ('salo_decode', 'salo_paged_decode')]; "
            "print(_build.build_log('salo_decode')); "
            "print(_build.build_log('salo_paged_decode'))")
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
            elif "registers" in line or "spill" in line:
                print(f"[build] {r.name}: {fn}: {line.strip()}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--sweep", action="store_true",
                    help="time K4 case (a)'s floor in this checkout")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--visit", action="store_true",
                    help=argparse.SUPPRESS)    # one ROOT, in this process
    args = ap.parse_args(argv)
    if args.visit:
        print(json.dumps(visit(args.roots[0], args.seed)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("ab_decode: no CUDA device", file=sys.stderr)
        return 2
    if args.sweep:
        print(json.dumps(sweep(args.seed)), flush=True)
        return 0
    if not args.roots:
        ap.error("give at least one ROOT, or --sweep")
    roots = [r.resolve() for r in args.roots]
    _build(roots)
    order = (roots + roots[::-1]) * args.rounds
    recs = []
    for r in order:
        p = subprocess.run([sys.executable, __file__, "--visit", str(r),
                            "--seed", str(args.seed)], capture_output=True,
                           text=True)
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
    keys = [f"K4{n}_ms" for n in K4_CASES] + [f"K5{n}_ms" for n in K5_CASES]
    summary = {}
    for r in roots:
        mine = [x for x in recs if x["root"] == str(r)]
        summary[r.name] = {k: sum(x[k] for x in mine) / len(mine)
                           for k in keys}
        summary[r.name]["visits"] = len(mine)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
