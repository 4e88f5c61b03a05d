#!/usr/bin/env python3
"""The tensor-parallel training phases of ``chip_smoke.py`` alone.

    python3 tools/train_tensor.py [--seed N] [--matrix]
    python3 tools/train_tensor.py --arch recurrentgemma-9b [--full]
    python3 tools/train_tensor.py --arch mamba2-370m

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
depth fits one card. With ``--arch recurrentgemma-9b`` or ``--arch
mamba2-370m``: that arch's unsharded train phase, then the arch at 2 and
4 model ranks (4 only on a machine with 4 cards), each at the depth its
ranks' reckoned peak allows; with ``--full`` also recurrentgemma-9b at
all 38 layers on 4 ranks if one rank's reckoned peak fits a card (the
reckoning printed first). The ranks use NCCL, one card each, where the
machine has the cards, else gloo ranks sharing cuda:0; every line names
the backend. Prints the card's name and power limit last. Any failed check
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


def unsharded(torch, seed, arch):
    """(depth, stats) of ``arch``'s unsharded train phase at its train-tp
    schedule (``chip_smoke.TP_SCHED``) and the depth that fits one card
    (``chip_smoke.train_depth``), run here."""
    batch, steps, lr, warmup = C.TP_SCHED[arch]
    depth = C.train_depth(torch, arch, 4096, batch)
    _, _, ref = C.phase_train(torch, seed, arch, n_layers=depth,
                              steps=steps, batch=batch, lr=lr,
                              warmup=warmup)
    torch.cuda.empty_cache()
    return depth, ref


def run_arch(torch, args):
    """``--arch``: the arch on 2 model ranks, then on 4 where the machine
    has 4 cards, each at the depth its ranks' reckoned peak allows, beside
    its unsharded phase where that depth fits one card; with ``--full``,
    recurrentgemma-9b at all 38 layers on 4 ranks if one rank's reckoned
    peak fits a card (the reckoning printed first)."""
    from repro_torch.configs import get_config

    arch = args.arch
    depth, ref = unsharded(torch, args.seed, arch)
    for n in (2, 4):
        if n > 2 and torch.cuda.device_count() < n:
            C.log(f"[train-tp {arch}] {n} ranks: {n} cards needed, "
                  f"{torch.cuda.device_count()} here: not run")
            continue
        C.phase_train_tp(torch, args.seed, ((arch, ref, depth, None),), n=n,
                         with_check=False)
        torch.cuda.empty_cache()
    if args.full and arch == "recurrentgemma-9b":
        full = get_config(arch)
        b = C.train_bytes_tp(full, 4096, C.TP_SCHED[arch][0], 4)
        budget = 0.92 * torch.cuda.get_device_properties(0).total_memory
        fits = b["peak"] <= budget
        C.log(f"[train-tp {arch} full] reckoned at {full.n_layers} layers "
              f"on 4 ranks, a card each: {b['params'] / 1e6:.1f}M params a "
              f"rank, update peak {b['update_peak'] / 1e9:.2f} GB, loss peak "
              f"{b['loss_peak'] / 1e9:.2f} GB, against {budget / 1e9:.2f} GB "
              f"(92 % of a card): {'fits' if fits else 'does not fit'}")
        if fits and torch.cuda.device_count() >= 4:
            C.phase_train_tp(torch, args.seed,
                             ((arch, None, None, full.n_layers),), n=4,
                             with_check=False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--matrix", action="store_true",
                    help="gemma-7b at 2 and 4 model ranks, longformer-4k "
                         "at 2")
    ap.add_argument("--arch", default="gemma-7b",
                    choices=("gemma-7b", "recurrentgemma-9b", "mamba2-370m"),
                    help="recurrentgemma-9b or mamba2-370m: that arch at 2 "
                         "and 4 model ranks")
    ap.add_argument("--full", action="store_true",
                    help="with --arch recurrentgemma-9b: all 38 layers on "
                         "4 ranks if the reckoning fits")
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
    from repro_torch.configs import get_config
    if args.arch in ("recurrentgemma-9b", "mamba2-370m"):
        run_arch(torch, args)
    elif not args.matrix:
        depth, ref = unsharded(torch, args.seed, "gemma-7b")
        C.phase_train_tp(torch, args.seed, (("gemma-7b", ref, depth, None),))
    else:
        depth, ref = unsharded(torch, args.seed, "gemma-7b")
        for n in (2, 4):
            C.phase_train_tp(torch, args.seed,
                             (("gemma-7b", ref, depth, None),), n=n,
                             with_check=n == 2)
            torch.cuda.empty_cache()
        _, _, lf = C.phase_train(torch, args.seed, "longformer-4k")
        torch.cuda.empty_cache()
        C.phase_train_tp(torch, args.seed, (
            ("longformer-4k", lf, get_config("longformer-4k").n_layers,
             None),), with_check=False)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    C.log(f"[wall] {time.perf_counter() - t0:.1f} s")
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
