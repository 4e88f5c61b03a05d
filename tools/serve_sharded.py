#!/usr/bin/env python3
"""The sequence-parallel serving phases of ``chip_smoke.py`` alone.

    python3 tools/serve_sharded.py [--seed N]

Run from the root of a checkout on a machine with a CUDA device. Builds
the paged-decode kernel, runs K4 case (s), serves the serve phases'
traffic unsharded on the bf16 and the int8 page-sparse slabs (the
references), then ``chip_smoke.phase_serve_sharded`` at 2 shards (with the
narrowed serve-sharded-check) and at 4 shards on the int8 slab, all 8
requests of each (``chip_smoke.py`` serves fewer, and the int8 slab on 2
shards, for time). The ranks
use NCCL, one card each, where the machine has the cards, else gloo ranks
sharing cuda:0; every line names the backend. Prints the card's name and
power limit last. Any failed check raises, so the exit code is nonzero.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as C  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    C.log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    _build.load("salo_paged_decode")
    C.k4_shard_case(torch, C.Timer(torch), args.seed)
    refs = {}
    for name, extra in (("bf16", {}), ("int8", C.INT8_SPARSE)):
        _, eng, params, _, _ = C._serve_engine(torch, args.seed,
                                               f"unsharded {name}", **extra)
        ts = time.perf_counter()
        refs[name] = eng.run(params)
        torch.cuda.synchronize()
        C.log(f"[unsharded {name}] run {time.perf_counter() - ts:.3f} s, "
              f"counters {dict(eng.counters)}")
        del eng, params
        torch.cuda.empty_cache()
    C.phase_serve_sharded(torch, args.seed, 2, (
        ("serve-sharded", refs["bf16"], {}, C.SERVE_R),), with_check=True)
    C.phase_serve_sharded(torch, args.seed, 4, (
        ("serve-sharded-int8", refs["int8"], C.INT8_SPARSE, C.SERVE_R),))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    C.log(f"[wall] {time.perf_counter() - t0:.1f} s")
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
