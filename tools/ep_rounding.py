#!/usr/bin/env python3
"""How far f32 rounding alone moves the parameters of train-ep-check, and
how far a wrong gradient does: the readings its parameter gate sits
between.

    PYTHONPATH=src python3 tools/ep_rounding.py [--seed N] [--ranks 2 4]
    python3 tools/ep_rounding.py --card [--seed N]

Runs on the CPU (gloo ranks), at ``chip_smoke._moe_check_cfgs``' narrowed
f32 arctic-480b and kimi-k2, 3 steps of ``chip_smoke._check_steps`` (seq
128, batch 2, lr 3e-3). Every reading is the largest absolute difference
of a parameter after the 3 steps from the one-rank run's, and the leaf it
is in:

* reordered: one rank, each batch's two rows swapped and the hidden units
  of every MLP, shared expert and expert reversed (the ``w_in``/``w_gate``
  columns and the ``w_out`` rows; reversed back before comparing). The
  loss (a mean over the tokens), the routing (16 dispatch groups: each
  row holds whole groups, so every group keeps its tokens and their
  order), every activation and every gradient are the same numbers,
  summed in another order over the tokens and over each ffn contraction,
  as a model group's partial sums are. What moves the parameters is f32
  rounding alone.
* model N: the expert-parallel step on N model ranks, gathered (what
  train-ep-check gates on the card at 2 ranks).
* planted: model 2 with ``ModelGroup.enter``'s backward ``all_reduce``
  taken out, so each rank keeps only its own share of every MoE and MLP
  input's gradient: a defect of the kind the gate is there to catch.

With ``--card`` (on a machine with a CUDA device) in place of those: the
unsharded run train-ep compares its ranks with (``chip_smoke.phase_train``
at arctic-480b's every width, one layer, the expert count
``chip_smoke.train_ep_experts`` picks for 2 ranks sharing the card, the
``EP_SCHED`` schedule, bf16) twice from one seed: as drawn, and with the
ffn hidden units reversed as above. The two are the same function summed
in another order; the loss and dropped share of every step are printed
for both, with the largest loss difference before and after the router
saturates (the reference's dropped share above 0.1). Prints the card's
name and power limit last.
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as C  # noqa: E402


def _flat(tree):
    from repro_torch.tree import tree_flatten_with_path
    return {"/".join(p): x.detach().float().cpu()
            for p, x in tree_flatten_with_path(tree)[0]}


def _largest_diff(got, want):
    """(max abs difference, the leaf it is in) of two flat trees."""
    return max((float((got[k] - want[k]).abs().max()), k) for k in want)


def _reverse_ffn(tree):
    """``tree`` with the ffn dim of every MLP and expert leaf reversed:
    the last of ``w_in``/``w_gate``, the one before it of ``w_out``."""
    import torch

    from repro_torch.tree import tree_flatten_with_path, tree_unflatten

    flat, treedef = tree_flatten_with_path(tree)
    dim = {"w_in": -1, "w_gate": -1, "w_out": -2}
    return tree_unflatten(treedef, [
        torch.flip(x, (dim[path[-1]],)) if path[-1] in dim else x
        for path, x in flat])


def _steps(cfg, params, seed, reorder=False, model_group=None):
    """``chip_smoke._check_steps``' 3 steps, with each batch's rows and
    the ffn hidden units reversed where ``reorder``; the final parameters,
    gathered."""
    import numpy as np

    from repro_torch.dist.group import Mesh2D
    from repro_torch.dist.sharding import mesh_placements
    from repro_torch.train.trainer import gather_params, shard_params

    p, pl = _reverse_ffn(params) if reorder else params, None
    if model_group is not None:
        pl = mesh_placements(params, cfg, model=model_group.size)
        p = shard_params(params, pl, Mesh2D(None, model_group))
    step, opt, ds = C._trainer(cfg, "cpu", p, seq=128, batch=2, steps=3,
                               lr=3e-3, warmup=1, seed=seed,
                               model_group=model_group)
    for i in range(3):
        b = ds.batch(i)
        if reorder:
            b = {k: np.ascontiguousarray(v[::-1]) for k, v in b.items()}
        p, opt, _, _ = step(p, opt, b)
    if model_group is not None:
        p = gather_params(p, pl, Mesh2D(None, model_group))
    return _flat(_reverse_ffn(p) if reorder else p)


def _rank(mesh, seed, params, planted):
    from repro_torch.dist.group import ModelGroup

    if planted:
        ModelGroup.enter = lambda self, x: x
    out = {arch: _steps(cfg, params[arch], seed, model_group=mesh.model)
           for arch, cfg in C._moe_check_cfgs().items()}
    return out if mesh.model.index == 0 else None


def _card(seed: int) -> int:
    """The ``--card`` reading."""
    import gc
    import os
    import subprocess

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch

    from repro_torch.models import model as MM

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    C.phase_build()
    batch, steps, lr, warmup = C.EP_SCHED
    E = C.train_ep_experts(torch, C.EP_ARCH, 4096, batch, C.EP_RANKS)
    cfg = C._ep_cfg(C.EP_ARCH, E)
    init = MM.Model.init
    runs = {}
    for what in ("as drawn", "reordered"):
        if what == "reordered":
            MM.Model.init = lambda self, *a, **k: _reverse_ffn(
                init(self, *a, **k))
        try:
            runs[what] = C.phase_train(torch, seed, C.EP_ARCH, cfg=cfg,
                                       steps=steps, batch=batch, lr=lr,
                                       warmup=warmup)[2]
        finally:
            MM.Model.init = init
        gc.collect()
        torch.cuda.empty_cache()
    a, b = runs["as drawn"], runs["reordered"]
    for what, r in runs.items():
        print(f"[ep-rounding] {C.EP_ARCH} {E} experts, 1 layer, {what}: "
              f"losses {r['losses']}; dropped share per step {r['dropped']}")
    sat = next((i for i, x in enumerate(a["dropped"]) if x > 0.1),
               len(a["losses"]))
    gap = [abs(x - y) for x, y in zip(a["losses"], b["losses"])]
    print(f"[ep-rounding] the two runs' losses differ by at most "
          f"{max(gap[:sat], default=0.0)} over steps 0..{sat - 1} and by "
          f"{max(gap[sat:], default=0.0)} from step {sat} (the dropped "
          f"share above 0.1 from there)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ranks", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--card", action="store_true",
                    help="the unsharded train-ep run, as drawn and "
                         "reordered, on the card")
    args = ap.parse_args(argv)
    if args.card:
        return _card(args.seed)
    import torch

    from repro_torch.dist.group import run_ranks
    from repro_torch.models.model import build_model

    torch.manual_seed(args.seed)
    cfgs = C._moe_check_cfgs()
    params = {arch: build_model(cfg, "cpu").init(
        torch.Generator().manual_seed(args.seed))
        for arch, cfg in cfgs.items()}
    one = {arch: _steps(cfg, params[arch], args.seed)
           for arch, cfg in cfgs.items()}
    rows = {arch: [("reordered", _largest_diff(
        _steps(cfg, params[arch], args.seed, reorder=True), one[arch]))]
        for arch, cfg in cfgs.items()}
    for n, planted in [(n, False) for n in args.ranks] + [(2, True)]:
        got = run_ranks(_rank, n, backend="gloo", device="cpu",
                        timeout_s=600.0, model=n,
                        args=(args.seed, params, planted))[0]
        for arch in cfgs:
            rows[arch].append(("planted" if planted else f"model {n}",
                               _largest_diff(got[arch], one[arch])))
    for arch, rs in rows.items():
        for what, (err, leaf) in rs:
            print(f"[ep-rounding] {arch} {what}: parameters off the one-rank "
                  f"run's by at most {err:.4g} (in {leaf})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
