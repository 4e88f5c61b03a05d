#!/usr/bin/env python3
"""The sequence-parallel training phases of ``chip_smoke.py`` alone.

    python3 tools/train_sharded.py [--seed N] [--recurrent | --families |
                                    --dilated]

Run from the root of a checkout on a machine with a CUDA device. Builds the
kernels, runs the unsharded references (smollm-135m and longformer-4k
trained at full size, 20 steps each, as ``chip_smoke.py``'s train phases,
without the checkpoint, arctic-480b's MoE layer at the cut of
``chip_smoke.seq_moe_inputs``, mamba2-370m at 12 layers as its train
phase, recurrentgemma-9b at one griffin group,
``chip_smoke.seq_rec_inputs``, qwen2-vl-2b at the depth 2 whole copies
fit and whisper-base at full size, ``chip_smoke.seq_fam_inputs``, and
smollm-135m at dilation 2 for ``chip_smoke.SHARDED_STEPS`` steps), then
``chip_smoke.phase_train_sharded``: the narrowed train-sharded-check,
both archs, smollm-135m at dilation 2, the MoE layer, the two recurrent
archs and the VLM and the encoder-decoder in one spawn. The ranks use
NCCL, one card each, where the machine has the cards, else gloo ranks
sharing cuda:0; every line names the backend. recurrentgemma-9b takes
whole train steps where the ranks have a card each
(``chip_smoke.seq_rg_whole_steps``), else its forward and backward
alone. ``--recurrent``: only the recurrent parts
(K1-K3 case (t-k), mamba2's unsharded phase cut to 3 steps, the
recurrentgemma-9b reference, then train-sharded-check and the two
recurrent runs in one spawn). ``--families``: only the VLM and the
encoder-decoder (K1-K3 case (t-v), whisper-base's unsharded phase cut to
its first ``chip_smoke.SEQ_FAM_STEPS`` steps, qwen2-vl-2b's reference at
its cut, then train-sharded-check and the two runs in one spawn).
``--dilated``: only the reordered schedule (K1-K3 case (t-d), the
unsharded smollm-135m at dilation 2, then train-sharded-check and
train-sharded smollm-135m dilation 2 in one spawn). Prints the card's
name and power limit last. Any failed check raises, so the exit code is
nonzero.
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
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--recurrent", action="store_true",
                      help="only case (t-k), the checks and the recurrent "
                      "runs")
    only.add_argument("--families", action="store_true",
                      help="only case (t-v), the checks and the VLM and "
                      "encoder-decoder runs")
    only.add_argument("--dilated", action="store_true",
                      help="only case (t-d), the checks and smollm-135m at "
                      "dilation 2")
    args = ap.parse_args(argv)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    from repro_torch.configs import with_dilation

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
    runs, moe, recs, fams = [], None, [], []
    if args.recurrent:
        C.train_kernels_shard(torch, C.Timer(torch), args.seed, "t-k")
    elif args.families:
        C.train_kernels_shard(torch, C.Timer(torch), args.seed, "t-v")
    elif args.dilated:
        C.train_kernels_shard(torch, C.Timer(torch), args.seed, "t-d")
    else:
        for arch in ("smollm-135m", "longformer-4k"):
            _, _, ref = C.phase_train(torch, args.seed, arch)
            runs.append((arch, ref, 1))
            torch.cuda.empty_cache()
        moe = C.seq_moe_inputs(torch, args.seed)
        torch.cuda.empty_cache()
    if not (args.recurrent or args.families):
        d = C.SHARDED_DILATION
        _, _, ref = C.phase_train(
            torch, args.seed, f"smollm-135m dilation {d}",
            run=C.SHARDED_STEPS["smollm-135m"],
            cfg=with_dilation(C._train_cfg(smoke=False), d))
        runs.append(("smollm-135m", ref, d))
        torch.cuda.empty_cache()
    if not (args.families or args.dilated):
        _, _, mamba = C.phase_train(
            torch, args.seed, "mamba2-370m", n_layers=C.MAMBA_TRAIN_LAYERS,
            steps=C.GEMMA_STEPS, batch=C.MAMBA_BATCH, lr=1e-3, warmup=3,
            run=3 if args.recurrent else None)
        torch.cuda.empty_cache()
        recs = [C.seq_rec_inputs(torch, args.seed, "mamba2-370m", mamba),
                C.seq_rec_inputs(torch, args.seed, "recurrentgemma-9b")]
    if not (args.recurrent or args.dilated):
        _, _, whisper = C.phase_train(
            torch, args.seed, "whisper-base", steps=C.GEMMA_STEPS,
            batch=C.TRAIN_BATCH, lr=1e-3, warmup=3,
            run=C.SEQ_FAM_STEPS if args.families else None)
        torch.cuda.empty_cache()
        fams = [C.seq_fam_inputs(torch, args.seed, "qwen2-vl-2b"),
                C.seq_fam_inputs(torch, args.seed, "whisper-base", whisper)]
    C.phase_train_sharded(torch, args.seed, tuple(runs), moe=moe,
                          recs=recs, fams=fams)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    C.log(f"[wall] {time.perf_counter() - t0:.1f} s")
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
