#!/usr/bin/env python3
"""Probe of gloo's ``all_gather`` on CUDA tensors between ranks that share
one card, the way the data-parallel training phases run on a one-card
machine.

    python3 tools/gloo_allgather_probe.py

Run from the root of a checkout on a machine with a CUDA device. Ranks
(``repro_torch.dist.group.run_ranks``, gloo, all on cuda:0):

1. ``dist.all_gather_into_tensor`` and ``dist.all_gather`` (a list of
   outputs) given int8 and f32 CUDA tensors directly, each in a spawn of
   its own: whether gloo takes them (and returns every rank's values), or
   the error it raises, or how the rank died.
2. Timed at 2 and 4 ranks (2 warm-up calls, 3 timed, synchronized) at
   smollm-135m's gradient (134.5M elements): the int8 payload's
   ``all_gather_into_tensor`` on CUDA tensors (where gloo took them) and
   through pinned host buffers, beside one f32 ``all_reduce`` SUM.

Prints each result, the card's name and its power limit.
"""
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.dist.group import run_ranks  # noqa: E402

GRAD_ELEMS = 134_515_008


def _timed(fn, n=3):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def direct(g, how):
    out = {}
    for dt in (torch.int8, torch.float32):
        x = torch.full((15,), g.index + 1, dtype=dt, device=g.device)
        try:
            if how == "into_tensor":       # flat: the ranks' parts end to end
                y = torch.zeros(g.size * 15, dtype=dt, device=g.device)
                dist.all_gather_into_tensor(y, x, group=g.pg)
                parts = list(y.view(g.size, 15))
            else:
                parts = [torch.zeros_like(x) for _ in range(g.size)]
                dist.all_gather(parts, x, group=g.pg)
            torch.cuda.synchronize()
            out[str(dt)] = ("taken", all(bool((p == r + 1).all())
                                         for r, p in enumerate(parts)))
        except Exception as e:          # what gloo says about CUDA tensors
            out[str(dt)] = ("raised", f"{type(e).__name__}: {e}"[:400])
    return out


def timed(g, on_device):
    q = torch.randint(-127, 128, (GRAD_ELEMS,), dtype=torch.int8,
                      device=g.device)
    out = {}
    if on_device:
        y = torch.empty(g.size * GRAD_ELEMS, dtype=torch.int8,
                        device=g.device)
        out["int8 all_gather, CUDA tensors ms"] = _timed(
            lambda: dist.all_gather_into_tensor(y, q, group=g.pg))
    hq = torch.empty(GRAD_ELEMS, dtype=torch.int8, pin_memory=True)
    hy = torch.empty(g.size * GRAD_ELEMS, dtype=torch.int8, pin_memory=True)
    dy = torch.empty(g.size * GRAD_ELEMS, dtype=torch.int8, device=g.device)

    def staged():
        hq.copy_(q)
        dist.all_gather_into_tensor(hy, hq, group=g.pg)
        dy.copy_(hy, non_blocking=True)

    out["int8 all_gather, pinned host staging ms"] = _timed(staged)
    del q
    y = None
    flat = torch.randn(GRAD_ELEMS, device=g.device)
    out["f32 all_reduce ms"] = _timed(
        lambda: dist.all_reduce(flat, group=g.pg))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(sys.version, torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), torch.cuda.device_count(),
          flush=True)
    taken = True
    for how in ("into_tensor", "list"):
        try:
            res = run_ranks(direct, 2, backend="gloo", device="cuda:0",
                            timeout_s=120, args=(how,))
            print(f"direct all_gather ({how}) on CUDA tensors:", res,
                  flush=True)
            taken = taken and all(v[0] == "taken" and v[1] for r in res
                                  for v in r.values())
        except RuntimeError as e:
            print(f"direct all_gather ({how}) on CUDA tensors: a rank "
                  f"failed:", str(e)[-2000:], flush=True)
            taken = False
    for n in (2, 4):
        t0 = time.time()
        res = run_ranks(timed, n, backend="gloo", device="cuda:0",
                        timeout_s=600, args=(taken,))
        print(f"{n} ranks, {GRAD_ELEMS} elements:", res,
              f"{time.time() - t0:.1f}s", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
