#!/usr/bin/env python3
"""The data-parallel training phases of ``chip_smoke.py`` alone.

    python3 tools/train_data.py [--seed N] [--matrix]

Run from the root of a checkout on a machine with a CUDA device. Builds the
kernels, runs train-dp-check (the narrowed f32 smollm on 2 ranks, the f32
and int8 wires), the unsharded reference (smollm-135m trained at full size,
20 steps, as ``chip_smoke.py``'s train phase, without the checkpoint), then
``chip_smoke.phase_train_dp`` for train-dp (2 ranks, f32 all_reduce) and
train-dp-int8 (4 ranks, int8 wire). With ``--matrix``: smollm-135m and
longformer-4k each at 2 and 4 ranks on both wires, every run beside its
arch's unsharded step. The ranks use NCCL, one card each, where the machine
has the cards, else gloo ranks sharing cuda:0; every line names the
backend. Prints the card's name and power limit last. Any failed check
raises, so the exit code is nonzero.
"""
import argparse
import os
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
    ap.add_argument("--matrix", action="store_true",
                    help="smollm-135m and longformer-4k at 2 and 4 ranks, "
                         "f32 and int8 wires")
    args = ap.parse_args(argv)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    C.log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    C.phase_build()
    C.train_dp_check(torch, args.seed)
    archs = ("smollm-135m", "longformer-4k") if args.matrix \
        else ("smollm-135m",)
    for arch in archs:
        _, _, ref = C.phase_train(torch, args.seed, arch)
        torch.cuda.empty_cache()
        if not args.matrix:
            _, losses, _ = C.phase_train_dp(torch, args.seed, "train-dp", ref)
            C.phase_train_dp(torch, args.seed, "train-dp-int8", ref, losses)
            continue
        for n in (2, 4):
            _, losses, _ = C.phase_train_dp(
                torch, args.seed, f"train-dp {arch} x{n}", ref, arch=arch,
                n=n, compress=False)
            C.phase_train_dp(torch, args.seed, f"train-dp-int8 {arch} x{n}",
                             ref, losses, arch=arch, n=n, compress=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    C.log(f"[wall] {time.perf_counter() - t0:.1f} s")
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
