#!/usr/bin/env python3
"""The FSDP training phases of ``chip_smoke.py`` alone, and the runs that
need a card a rank.

    python3 tools/train_fsdp.py [--seed N] [--matrix] [--compress-grads]

Run from the root of a checkout on a machine with a CUDA device. Builds the
kernels, runs train-dp-check (the narrowed f32 smollm on 2 ranks), the
unsharded reference (smollm-135m trained at full size, 20 steps, as
``chip_smoke.py``'s train phase, without the checkpoint), then
``chip_smoke.phase_train_dp`` for train-dp with the FSDP phases in its
spawn: train-fsdp-check (against train-dp-check) and train-fsdp
(smollm-135m at full size, against train-dp). With ``--matrix`` (meant for
a call with 4 cards, NCCL a card a rank): smollm-135m at 2 and at 4 data
ranks, each with and without ``--fsdp`` in one spawn (the check at 2
only: its global batch has 2 rows), then gemma-7b at all 28 layers, every
published width, on 4 data ranks under FSDP: batch 4 (a row a rank), seq
4096, the gemma train phase's 10-step schedule (lr 1e-3, warmup 3), the
state a rank holds reckoned and printed before the run, the loss gated to
fall. With ``--compress-grads``: then train-dp-int8 with the FSDP int8
phases and the (data 2, model 2) int8 check in its spawn, as
``chip_smoke.py`` runs them (train-fsdp-int8-check, train-fsdp-int8
against train-dp-int8's losses bitwise); under ``--matrix`` at 2 and 4
ranks, and gemma-7b at 28 layers on 4 data ranks under FSDP on the int8
wire where one rank's reckoned state (its slices, the whole f32 gradient
and the whole f32 residual, printed first) fits 92 % of a card. The ranks
use NCCL, one card each, where the machine has the cards, else gloo ranks
sharing cuda:0; every line names the backend. Prints the card's name and
power limit last. Any failed check raises, so the exit code is nonzero.
"""
import argparse
import gc
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as C  # noqa: E402

DEEP_ARCH, DEEP_RANKS, DEEP_BATCH = "gemma-7b", 4, 4
DEEP_TIMEOUT_S = 1500.0


def fsdp_state_bytes(cfg, n: int, compress: bool = False) -> dict:
    """The state one of ``n`` FSDP ranks holds, reckoned from the whole
    shapes and the placements: each leaf's bf16 (stored-type) parameter,
    f32 m and v and f32 gradient (14 bytes a bf16 parameter), its slice's
    share where the fallback splits it; with ``compress`` the gradient
    whole (the wire quantizes it before the sum) and an f32 residual
    whole beside it (8 bytes a parameter more, none of them split)."""
    from repro_torch.models.model import build_model
    from repro_torch.dist.sharding import mesh_placements
    from repro_torch.tree import tree_leaves, tree_map

    whole = build_model(cfg, "cpu").param_shapes()
    dims = mesh_placements(whole, cfg, data=n)
    split = held = 0
    for x, s in zip(tree_leaves(whole),
                    tree_leaves(tree_map(lambda _, s: s, whole, dims))):
        b = x.numel() * (x.element_size() + 12)
        if s.whole:
            held += b
        elif compress:
            split += x.numel() * (x.element_size() + 8) // n
            held += x.numel() * 8
        else:
            split += b // n
    total = sum(x.numel() for x in tree_leaves(whole))
    return dict(params=total, whole_state=total * 14, split=split,
                held=held, rank=split + held)


def deep_rank(group, seed, arch, steps, batch, lr, warmup, compress=False):
    """One rank of the deep FSDP run: ``arch`` at every published width
    and depth, bf16, remat full, seq 4096, this rank's rows of the global
    batch, ``steps`` steps of the schedule, its slices drawn layer by
    layer from the seed's single-device draw."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist.group import DataGroup
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import init_shards, train_placements

    C._rank_prelude(torch)
    data = DataGroup.of(group)
    dev = str(group.device)
    cfg = get_config(arch)
    model = build_model(cfg, dev)
    dims = train_placements(model, data=data, fsdp=True)
    params = init_shards(model, torch.Generator(device=dev).manual_seed(seed),
                         None, data, fsdp=True)
    step, opt, ds = C._trainer(cfg, dev, params, seq=4096, batch=batch,
                               steps=steps, lr=lr, warmup=warmup, seed=seed,
                               data=data, fsdp=True, compress=compress)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    C._counters(reset=True)
    losses, times, ef = [], [], None
    for i in range(steps):
        b = ds.batch(i)
        t0 = time.perf_counter()
        params, opt, met, ef = step(params, opt, b, ef)
        losses.append(float(met["loss"]))
        times.append(time.perf_counter() - t0)
        if data.index == 0:
            C.log(f"[train-fsdp {arch} x{data.size}] rank 0 step {i} loss "
                  f"{losses[-1]:.4f} grad norm "
                  f"{float(met['grad_norm']):.4f} {times[-1] * 1e3:.1f} ms")
    launches, plain = C._counters()
    return dict(losses=losses, times=times, launches=launches, plain=plain,
                peak=torch.cuda.max_memory_allocated(),
                digest=C._whole_digest(torch, params, opt, dims))


def phase_deep(torch, seed, arch=DEEP_ARCH, n=DEEP_RANKS, batch=DEEP_BATCH,
               compress=False):
    """gemma-7b (by default) at every published width and depth under FSDP
    over ``n`` data ranks, the gemma train phase's 10-step schedule (on
    the int8 wire with ``compress``, run only if the reckoned state of a
    rank fits 92 % of a card). Gates: equal losses and leaves held whole
    on every rank, the loss falling, per rank and step 2 K1, 1 K2 and 1 K3
    call an attention layer, no plain version."""
    from repro_torch.configs import get_config
    from repro_torch.dist.group import run_ranks

    cfg = get_config(arch)
    tag = f"train-fsdp{'-int8' if compress else ''} {arch} x{n}"
    sb = fsdp_state_bytes(cfg, n, compress)
    budget = 0.92 * torch.cuda.get_device_properties(0).total_memory
    C.log(f"[{tag}] reckoned: {sb['params']} parameters, "
          f"{sb['whole_state']} bytes of bf16 parameters, f32 m, v and "
          f"gradient on one device; a rank holds {sb['rank']} bytes "
          f"({sb['split']} of slices, {sb['held']} of leaves held whole"
          f"{' and of the whole gradient and residual' if compress else ''})"
          f", against {int(budget)} (92 % of a card)")
    if compress and sb["rank"] > budget:
        C.log(f"[{tag}] does not fit a card: not run")
        return
    backend, device = C._shard_backend(torch, n)
    t0 = time.perf_counter()
    recs = run_ranks(deep_rank, n, backend=backend, device=device,
                     timeout_s=DEEP_TIMEOUT_S,
                     args=(seed, arch, C.GEMMA_STEPS, batch, 1e-3, 3,
                           compress))
    wall = time.perf_counter() - t0
    r0 = recs[0]
    n_attn = C._train_attention_layers(cfg)
    steps = C.GEMMA_STEPS
    want = {"K1": 2 * n_attn * steps, "K2": n_attn * steps,
            "K3": 2 * n_attn * steps}
    for r, rec in enumerate(recs):
        C.check(rec["losses"] == r0["losses"],
                f"{tag}: rank {r}'s losses differ from rank 0's")
        C.check(rec["launches"] == want and rec["plain"] == 0,
                f"{tag} rank {r}: launches {rec['launches']} != "
                f"{want}, plain {rec['plain']}")
    C.check(len({rec["digest"] for rec in recs}) == 1,
            f"{tag}: the leaves held whole differ across the ranks")
    losses = r0["losses"]
    C.check(all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0],
            f"{tag}: the loss did not fall: {losses}")
    med = sorted(r0["times"][1:])[(steps - 1) // 2] * 1e3
    C.log(f"[{tag}] {cfg.n_layers} layers bf16 remat full, "
          f"backend {backend} ({device or 'one card a rank'}), global batch "
          f"{batch} = {n} x {batch // n} at seq 4096, {steps} steps: "
          f"{wall:.1f} s with the ranks' start; losses {losses}; step median "
          f"{med:.3f} ms over steps 1..{steps - 1} (rank 0; "
          f"{batch * 4096 / med * 1e3:.1f} tokens/s over the ranks); peak "
          f"per rank {[round(rec['peak'] / 2**30, 3) for rec in recs]} GiB")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--matrix", action="store_true",
                    help="smollm-135m at 2 and 4 data ranks with and "
                         "without fsdp, then gemma-7b at 28 layers on 4")
    ap.add_argument("--compress-grads", action="store_true",
                    help="also the int8 wire's FSDP phases (train-dp-int8's "
                         "spawn)")
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
    _, dp_check = C.train_dp_check(torch, args.seed)
    _, _, ref = C.phase_train(torch, args.seed)
    torch.cuda.empty_cache()
    fsdp = C.fsdp_inputs(torch, args.seed, dp_check,
                         C.DP_STEPS - 1 if args.matrix else C.FSDP_STEPS)
    if not args.matrix:
        _, dp_l, _ = C.phase_train_dp(torch, args.seed, "train-dp", ref,
                                      fsdp=fsdp)
        if args.compress_grads:
            torch.cuda.empty_cache()
            C.phase_train_dp(torch, args.seed, "train-dp-int8", ref, dp_l,
                             fsdp=C.fsdp_inputs(torch, args.seed, None),
                             tp=C.tp_int8_inputs(torch, args.seed))
    else:
        for n in (2, 4):
            # the narrowed check's global batch (2 rows) splits over 2
            _, dp_l, _ = C.phase_train_dp(
                torch, args.seed, f"train-dp x{n}", ref, n=n,
                compress=False,
                fsdp=fsdp if n == 2 else dict(fsdp, cfg=None))
            torch.cuda.empty_cache()
            if args.compress_grads:
                C.phase_train_dp(
                    torch, args.seed, f"train-dp-int8 x{n}", ref, dp_l, n=n,
                    compress=True, fsdp=C.fsdp_inputs(
                        torch, args.seed, None, C.DP_STEPS - 1),
                    tp=C.tp_int8_inputs(torch, args.seed) if n == 4
                    else None)
                torch.cuda.empty_cache()
        phase_deep(torch, args.seed)
        if args.compress_grads:
            phase_deep(torch, args.seed, compress=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    C.log(f"[wall] {time.perf_counter() - t0:.1f} s")
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
