#!/usr/bin/env python3
"""Probe of gloo's ``all_reduce`` on CUDA tensors between ranks that share
one card, the way the sequence-parallel serving phases run on a one-card
machine.

    python3 tools/gloo_allreduce_probe.py

Run from the root of a checkout on a machine with a CUDA device. Two ranks
(``repro_torch.dist.group.run_ranks``, gloo, both on cuda:0) check SUM and
MAX of f32, bf16 and f64 CUDA tensors and ``SeqGroup.agree``, then time 50
``all_reduce`` SUMs (after 5 warm-up calls, synchronized) at the decode
merge's shape (8 rows x 9 heads x (64 + 1)), a prefill chunk's (9 heads x
128 rows x (64 + 1)) and the page statistics' (8 x 66). Last, NCCL at two
ranks must be refused with fewer than two cards. Prints each rank's
results, the card's name and its power limit.
"""
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.dist.group import run_ranks  # noqa: E402


def body(g):
    out = {}
    for dt in (torch.float32, torch.bfloat16, torch.float64):
        x = torch.full((4,), float(g.index + 1), dtype=dt, device=g.device)
        g.psum_(x)
        y = torch.full((4,), float(g.index + 1), dtype=dt, device=g.device)
        g.pmax_(y)
        out[str(dt)] = (x.cpu().tolist(), y.cpu().tolist(), str(x.device))
    out["agree"] = g.agree(123.5 + g.index)
    times = {}
    for shape in ((8, 9, 1, 65), (1, 9, 128, 65), (8, 66)):
        t = torch.randn(shape, device=g.device)
        for _ in range(5):
            g.psum_(t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            g.psum_(t)
        torch.cuda.synchronize()
        times[str(shape)] = (time.perf_counter() - t0) / 50 * 1e3
    out["ms"] = times
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(sys.version, torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), torch.cuda.device_count(),
          flush=True)
    t0 = time.time()
    res = run_ranks(body, 2, backend="gloo", device="cuda:0", timeout_s=200)
    print("gloo on cuda:0 x2:", res, f"{time.time() - t0:.1f}s", flush=True)
    if torch.cuda.device_count() < 2:
        try:
            run_ranks(body, 2, backend="nccl")
            return 1
        except RuntimeError as e:
            print("nccl refused as expected:", e)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
