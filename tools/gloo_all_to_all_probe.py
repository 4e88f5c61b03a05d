#!/usr/bin/env python3
"""Probe of gloo's ``all_to_all_single`` on CUDA tensors between ranks that
share one card, the way the FSDP int8 gradient wire runs on a one-card
machine.

    python3 tools/gloo_all_to_all_probe.py

Run from the root of a checkout on a machine with a CUDA device. Ranks
(``repro_torch.dist.group.run_ranks``, gloo, all on cuda:0):

1. ``dist.all_to_all_single`` given int8 and f32 CUDA tensors, each in a
   spawn of its own at 2 ranks: whether gloo takes them and hands each
   rank every rank's part for it, bitwise equal to an ``all_gather`` of
   the same random values followed by the parts; or the error it raises,
   or how the rank died.
2. Timed at 2 and 4 ranks (2 warm-up calls, 3 timed, synchronized) at
   smollm-135m's gradient (134.5M int8 values): ``all_to_all_single`` on
   CUDA tensors where gloo took them, the same staged through host
   tensors (copied to the host, sent, copied back), and the int8
   ``all_gather`` of the whole payload (``DataGroup.all_gather``).

Prints each result, the card's name and its power limit, and on its last
line ``all_to_all_single on CUDA tensors: taken`` or ``... : not taken``.
"""
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.dist.group import DataGroup, run_ranks  # noqa: E402

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


def direct(g, dtype):
    gen = torch.Generator(device=g.device).manual_seed(g.index)
    x = (torch.randn(g.size * 1000, generator=gen, device=g.device) * 50
         ).to(dtype)
    try:
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=g.pg)
        every = torch.empty(g.size * x.numel(), dtype=dtype, device=g.device)
        dist.all_gather_into_tensor(every, x, group=g.pg)
        want = every.view(g.size, g.size, 1000)[:, g.index].reshape(-1)
        torch.cuda.synchronize()
        return ("taken", bool(torch.equal(out, want)))
    except Exception as e:          # what gloo says about CUDA tensors
        return ("raised", f"{type(e).__name__}: {e}"[:400])


def timed(g, taken):
    data = DataGroup.of(g)
    n = GRAD_ELEMS - GRAD_ELEMS % g.size
    x = torch.zeros(n, dtype=torch.int8, device=g.device)
    out = {}
    if taken:
        y = torch.empty_like(x)
        out["int8 all_to_all_single ms"] = _timed(
            lambda: dist.all_to_all_single(y, x, group=g.pg))

    def staged():
        h = x.cpu()
        r = torch.empty_like(h)
        dist.all_to_all_single(r, h, group=g.pg)
        return r.to(g.device)

    out["int8 all_to_all staged through the host ms"] = _timed(staged)
    out["int8 all_gather ms"] = _timed(lambda: data.all_gather(x))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(sys.version, torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), torch.cuda.device_count(),
          flush=True)
    taken = True
    for dtype in (torch.int8, torch.float32):
        try:
            res = run_ranks(direct, 2, backend="gloo", device="cuda:0",
                            timeout_s=120, args=(dtype,))
            print(f"all_to_all_single on CUDA {dtype}:", res, flush=True)
            taken = taken and all(r == ("taken", True) for r in res)
        except RuntimeError as e:
            print(f"all_to_all_single on CUDA {dtype}: a rank failed:",
                  str(e)[-2000:], flush=True)
            taken = False
    for n in (2, 4):
        t0 = time.time()
        res = run_ranks(timed, n, backend="gloo", device="cuda:0",
                        timeout_s=600, args=(taken,))
        print(f"{n} ranks, {GRAD_ELEMS} int8 values:", res,
              f"{time.time() - t0:.1f}s", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    print(f"all_to_all_single on CUDA tensors: "
          f"{'taken' if taken else 'not taken'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
