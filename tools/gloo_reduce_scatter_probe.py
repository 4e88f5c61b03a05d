#!/usr/bin/env python3
"""Probe of gloo's ``reduce_scatter`` on CUDA tensors between ranks that
share one card, the way the FSDP training phases run on a one-card
machine.

    python3 tools/gloo_reduce_scatter_probe.py

Run from the root of a checkout on a machine with a CUDA device. Ranks
(``repro_torch.dist.group.run_ranks``, gloo, all on cuda:0):

1. ``dist.reduce_scatter_single`` (where this torch has it) and
   ``dist.reduce_scatter_tensor`` given f32 CUDA tensors, each in a spawn
   of its own at 2 ranks: whether gloo takes them and returns the rank's
   slice of the sum, bitwise equal to an ``all_reduce`` of the same
   random values followed by the slice; or the error it raises, or how
   the rank died.
2. Timed at 2 ranks (2 warm-up calls, 3 timed, synchronized) at
   smollm-135m's gradient (134.5M f32 elements): the reduce-scatter where
   gloo took it, beside one ``all_reduce`` SUM (and its slice).

Prints each result, the card's name and its power limit, and on its last
line ``reduce_scatter on CUDA tensors: taken`` or ``... : not taken``.
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
NAMES = ("reduce_scatter_single", "reduce_scatter_tensor")


def _timed(fn, n=3):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def direct(g, name):
    gen = torch.Generator(device=g.device).manual_seed(g.index)
    x = torch.randn(g.size * 1000, generator=gen, device=g.device)
    try:
        fn = getattr(dist, name)
        out = torch.empty(1000, device=g.device)
        fn(out, x, group=g.pg)
        ref = x.clone()
        dist.all_reduce(ref, group=g.pg)
        want = ref.view(g.size, 1000)[g.index]
        torch.cuda.synchronize()
        return ("taken", bool(torch.equal(out, want)))
    except Exception as e:          # what gloo says about CUDA tensors
        return ("raised", f"{type(e).__name__}: {e}"[:400])


def timed(g, name):
    x = torch.randn(GRAD_ELEMS, device=g.device)
    out = {}
    if name is not None:
        y = torch.empty(GRAD_ELEMS // g.size, device=g.device)
        out[f"f32 {name} ms"] = _timed(
            lambda: getattr(dist, name)(y, x, group=g.pg))

    def by_all_reduce():
        dist.all_reduce(x, group=g.pg)
        return x.view(g.size, -1)[g.index].clone()

    out["f32 all_reduce + slice ms"] = _timed(by_all_reduce)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(sys.version, torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), torch.cuda.device_count(),
          flush=True)
    taken = None
    for name in NAMES:
        if not hasattr(dist, name):
            print(f"{name}: not in torch {torch.__version__}", flush=True)
            continue
        try:
            res = run_ranks(direct, 2, backend="gloo", device="cuda:0",
                            timeout_s=120, args=(name,))
            print(f"{name} on CUDA tensors:", res, flush=True)
            if taken is None and all(r == ("taken", True) for r in res):
                taken = name
        except RuntimeError as e:
            print(f"{name} on CUDA tensors: a rank failed:",
                  str(e)[-2000:], flush=True)
    t0 = time.time()
    res = run_ranks(timed, 2, backend="gloo", device="cuda:0",
                    timeout_s=600, args=(taken,))
    print(f"2 ranks, {GRAD_ELEMS} elements:", res,
          f"{time.time() - t0:.1f}s", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    print(f"reduce_scatter on CUDA tensors: "
          f"{'taken (' + taken + ')' if taken else 'not taken'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
