#!/usr/bin/env python3
"""The tensor-parallel training phases of ``chip_smoke.py`` alone.

    python3 tools/train_tensor.py [--seed N] [--matrix]

Run from the root of a checkout on a machine with a CUDA device. Builds the
kernels, runs the unsharded gemma-7b train phase (full width, the depth
that fits one card, 10 steps, as ``chip_smoke.py``'s), then
``chip_smoke.phase_train_tp``: train-tp-check (the narrowed f32 gemma-like
and smollm-like configs on 2 model ranks against one rank) and train-tp
gemma-7b (full width on 2 model ranks, the depth that fits, against the
unsharded phase). With ``--matrix``: gemma-7b at 2 and at 4 model ranks
and longformer-4k at 2 (its odd vocabulary whole, its attention split),
each at the depth its ranks' reckoned peak allows (at 4 ranks on 4 cards
the full 28 layers of gemma-7b), beside the unsharded phase where that
depth fits one card. The ranks use NCCL, one card each, where the machine
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
                    help="gemma-7b at 2 and 4 model ranks, longformer-4k "
                         "at 2")
    args = ap.parse_args(argv)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
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
    depth = C.train_depth(torch, "gemma-7b", 4096, C.GEMMA_BATCH)
    _, _, ref = C.phase_train(torch, args.seed, "gemma-7b", n_layers=depth,
                              steps=C.GEMMA_STEPS, batch=C.GEMMA_BATCH,
                              lr=1e-3, warmup=3)
    torch.cuda.empty_cache()
    if not args.matrix:
        C.phase_train_tp(torch, args.seed, "gemma-7b", ref, depth)
    else:
        for n in (2, 4):
            C.phase_train_tp(torch, args.seed, "gemma-7b", ref, depth, n=n,
                             with_check=n == 2)
            torch.cuda.empty_cache()
        _, _, lf = C.phase_train(torch, args.seed, "longformer-4k")
        torch.cuda.empty_cache()
        from repro_torch.configs import get_config
        C.phase_train_tp(torch, args.seed, "longformer-4k", lf,
                         get_config("longformer-4k").n_layers,
                         with_check=False)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    C.log(f"[wall] {time.perf_counter() - t0:.1f} s")
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
