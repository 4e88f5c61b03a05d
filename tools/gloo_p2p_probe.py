#!/usr/bin/env python3
"""Probe of gloo's point-to-point sends on CUDA tensors between ranks that
share one card, the way the sequence-parallel training phases run on a
one-card machine.

    python3 tools/gloo_p2p_probe.py

Run from the root of a checkout on a machine with a CUDA device. Two ranks
(``repro_torch.dist.group.run_ranks``, gloo, both on cuda:0):

1. ``SeqGroup.ppermute`` (host-staged on a gloo group on a CUDA device)
   exchanges f32 and bf16 buffers in both directions and must return the
   peer's values; then it is timed (5 warm-up calls, 20 timed,
   synchronized) at the halo buffers of the sharded train phases:
   smollm-135m's (K and V stacked, 72 flat heads, 4 tiles of 256 keys, hd
   64, bf16) and longformer-4k's (96 flat heads, 2 tiles), and one
   ``all_reduce`` SUM of smollm-135m's f32 gradient (134.5M elements).
2. ``dist.batch_isend_irecv`` given the CUDA tensors directly, in a spawn
   of its own: whether gloo takes them (and returns the peer's values), or
   the error it raises, or how the rank died.

Prints each rank's results, the card's name and its power limit.
"""
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.dist.group import run_ranks  # noqa: E402

HALOS = {"smollm-135m": (2, 72, 4, 256, 64),
         "longformer-4k": (2, 96, 2, 256, 64)}
GRAD_ELEMS = 134_515_008


def _timed(fn, n=20):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def staged(g):
    out = {"host_p2p": g.host_p2p}
    peer = 1 - g.index
    perm = [(0, 1), (1, 0)]
    for dt in (torch.float32, torch.bfloat16):
        x = torch.full((3, 5), float(g.index + 1), dtype=dt, device=g.device)
        y = g.ppermute(x, perm)
        out[str(dt)] = (bool((y == peer + 1).all()), str(y.device))
    for name, shape in HALOS.items():
        buf = torch.randn(shape, device=g.device).to(torch.bfloat16)
        out[f"ppermute {name} ms"] = _timed(lambda: g.ppermute(buf, perm))
    flat = torch.randn(GRAD_ELEMS, device=g.device)
    out["all_reduce grad f32 ms"] = _timed(lambda: g.psum_(flat), n=3)
    return out


def direct(g):
    peer = 1 - g.index
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.full((3, 5), float(g.index + 1), dtype=dt, device=g.device)
        y = torch.zeros_like(x)
        try:
            works = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, peer, group=g.pg),
                dist.P2POp(dist.irecv, y, peer, group=g.pg)])
            for w in works:
                w.wait()
            torch.cuda.synchronize()
            out[str(dt)] = ("taken", bool((y == peer + 1).all()))
        except Exception as e:          # what gloo says about CUDA tensors
            out[str(dt)] = ("raised", f"{type(e).__name__}: {e}"[:400])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(sys.version, torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), torch.cuda.device_count(),
          flush=True)
    t0 = time.time()
    res = run_ranks(staged, 2, backend="gloo", device="cuda:0",
                    timeout_s=300)
    print("staged ppermute, gloo on cuda:0 x2:", res,
          f"{time.time() - t0:.1f}s", flush=True)
    ok = all(r[str(dt)][0] for r in res
             for dt in (torch.float32, torch.bfloat16))
    try:
        res = run_ranks(direct, 2, backend="gloo", device="cuda:0",
                        timeout_s=120)
        print("direct batch_isend_irecv on CUDA tensors:", res, flush=True)
    except RuntimeError as e:
        print("direct batch_isend_irecv on CUDA tensors: a rank failed:",
              str(e)[-2000:], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
