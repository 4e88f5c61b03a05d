#!/usr/bin/env python3
"""The expert-parallel training phases of ``chip_smoke.py`` alone.

    python3 tools/train_expert.py [--seed N] [--matrix]

Run from the root of a checkout on a machine with a CUDA device. Builds the
kernels, runs train-kernels case (ep) (K1-K3 at one model rank's heads of
arctic-480b's train attention, against their plain versions, timed), then
``chip_smoke.prepare_train_ep`` (the narrowed f32 MoE configs on one rank,
the expert count ``train_ep_experts`` picks and, where the ranks share the
card, the unsharded arctic-480b reference at every published width, one
layer) and ``chip_smoke.phase_train_ep``: train-ep-check (the narrowed
configs on 2 model ranks against one rank, the routing's slots hashed on
every rank) and train-ep arctic-480b (every published width on 2 model
ranks against the reference). With ``--matrix``, in place of those:
train-ep-check and arctic-480b at 2 model ranks (the expert count its
reckoning picks for a card a rank), the same at 4 with 64 experts (the
check's parameter limit 1e-4 there: ``chip_smoke.EP_CHECK_PARAMS_TOL``),
arctic-480b at 8 with all 128 where the machine has 8 cards, and kimi-k2
(its leading dense layer and one MoE layer, vocab split) at 4 with the
expert count its reckoning picks; one card a rank, no unsharded reference
(the loss must fall). The ranks use
NCCL, one card each, where the machine has the cards, else gloo ranks
sharing cuda:0; every line names the backend. Prints the card's name and
power limit last. Any failed check raises, so the exit code is nonzero
(``--matrix`` runs every entry first and names the failed ones).
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

# --matrix: (arch, model ranks, experts (None: the reckoning's pick),
# whether train-ep-check runs first at those ranks)
MATRIX = (("arctic-480b", 2, None, True), ("arctic-480b", 4, 64, True),
          ("arctic-480b", 8, 128, False),
          ("kimi-k2-1t-a32b", 4, None, False))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--matrix", action="store_true",
                    help="arctic-480b at 2, 4 and 8 model ranks, kimi-k2 "
                         "at 4, a card a rank")
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
    cards = torch.cuda.device_count()
    C.log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x {cards}")
    C.phase_build()
    if not args.matrix:
        C.TRAIN_CASES = {"ep": C.TRAIN_CASES["ep"]}
        C.phase_train_kernels(torch, C.Timer(torch), args.seed)
        torch.cuda.empty_cache()
        ep = C.prepare_train_ep(torch, args.seed)
        torch.cuda.empty_cache()
        C.phase_train_ep(torch, args.seed, ep)
    else:
        failed = []
        for arch, n, experts, with_check in MATRIX:
            if cards < n:
                C.log(f"[train-ep {arch} x{n}] skipped: {n} model ranks need "
                      f"{n} cards, this machine has {cards}")
                continue
            # every entry runs and reports; a failed check fails the run
            # at its end
            try:
                ep = C.prepare_train_ep(torch, args.seed, n=n, arch=arch,
                                        experts=experts,
                                        with_check=with_check)
                torch.cuda.empty_cache()
                C.phase_train_ep(torch, args.seed, ep)
                del ep
            except (AssertionError, RuntimeError) as err:
                failed.append(f"{arch} x{n}")
                C.log(f"[train-ep {arch} x{n}] FAILED: {err}")
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    C.log(f"[wall] {time.perf_counter() - t0:.1f} s")
    print(smi.stdout.strip())
    if args.matrix and failed:
        print(f"failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
