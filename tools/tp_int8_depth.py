#!/usr/bin/env python3
"""The int8 wire's gap to f32 gradients at depth: the wire's own noise, or
a fault of the wire under tensor parallelism?

    PYTHONPATH=src python3 tools/tp_int8_depth.py [--layers 5 28] [--model 4]
    python3 tools/tp_int8_depth.py --card [--layers 5 28]

Without ``--card`` it runs on the CPU, f32, no card. For each depth, a narrowed gemma-like
config (d 256, 4 / 4 heads of hd 256, ffn 512, vocab 256: at 4 model
ranks every placement splits) trains 3 steps of gemma-7b's train-tp
schedule (``chip_smoke.TP_SCHED``: lr 1e-3, warmup 3) at seq 128, batch
2, from one seeded draw, three ways: (a) f32 gradients on one rank, (b)
the int8 wire on one rank, (c) the int8 wire on ``--model`` gloo ranks.
Prints per step the losses, |b - a| (the wire's noise), |c - b| (what
the split adds; each rank runs (b) itself too, so the two share its
thread settings), the share of (b)'s int8 values that are 0, and (c)'s
int8 values that differ from its slices of (b)'s, per rank. Exits
nonzero if |c - b| exceeds 1e-4 at any step.

With ``--card`` (a machine with 4 cards): gemma-7b at full width, bf16,
remat full, seq 4096, on 4 model ranks over NCCL, a card a rank, at each
depth: 3 steps of train-tp's schedule from the same draw in f32
(train-tp), on the int8 wire (train-tp-int8), and two diagnostics, not
the reference's semantics: the int8 wire with one scale a leaf, i.e. a
layer (the reference's is one a stacked tensor), and with the tied
embedding's gradient unquantized; each run as
``chip_smoke._tp_main_run`` runs it (its profiled fourth step too).
Prints the runs' losses, the int8 runs' gaps to f32 a step, and the
share of the int8 values that are 0 over each int8 run's steps (rank
0's), in the largest leaf quantized (the embedding where it is) and in
the rest. Exits 0 when
the runs end; nothing is gated.
"""
import argparse
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

SEED = 0
STEPS = 3


def _cfg(layers):
    return C._narrow("gemma-7b", d_model=256, n_heads=4, n_kv_heads=4,
                     head_dim=256, d_ff=512, n_layers=layers)


def _steps(torch, cfg, p, compress, model_group=None, qs=None):
    """Each step's loss of 3 steps from ``p`` (on this rank of
    ``model_group``, on the int8 wire with ``compress``; ``qs`` gets each
    step's int8 values)."""
    _, total, lr, warmup = C.TP_SCHED["gemma-7b"]
    step, opt, ds = C._trainer(cfg, "cpu", p, seq=128, batch=2,
                               steps=total, lr=lr, warmup=warmup, seed=SEED,
                               model_group=model_group, compress=compress)
    losses, ef = [], None
    for i in range(STEPS):
        with C._Int8Tap(qs):
            p, opt, met, ef = step(p, opt, ds.batch(i), ef)
        losses.append(float(met["loss"]))
    return losses


def _rank(mesh, layers):
    """(c) on this model rank, and its int8 values' flips against (b)'s."""
    import torch

    from repro_torch.dist.group import Mesh2D
    from repro_torch.dist.sharding import mesh_placements
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import shard_params
    from repro_torch.tree import tree_leaves, tree_map

    torch.manual_seed(SEED)
    cfg = _cfg(layers)
    full = build_model(cfg, "cpu").init(torch.Generator().manual_seed(SEED))
    n = mesh.model.size
    pl = mesh_placements(full, cfg, model=n)
    q_tp, q_one = [], []
    split = _steps(torch, cfg, shard_params(full, pl, Mesh2D(None,
                                                             mesh.model)),
                   True, mesh.model, q_tp)
    one = _steps(torch, cfg, full, True, qs=q_one)
    shapes = [tuple(x.shape) for x in tree_leaves(full)]
    dims = tree_leaves(tree_map(lambda _, s: s.model, full, pl))
    return dict(losses=split, one=one,
                flips=C._int8_flips(q_one, q_tp, shapes, dims,
                                    mesh.model.index, n),
                values=[q.numel() for q in q_tp])


class _ZeroTap:
    """Within the block, each call of the compressed wire's quantizer
    (``compression._quantize``: one a leaf a step) adds (its values, its
    zeros) to ``calls``, the zeros counted on the device. ``variant``
    (a diagnostic; None is the reference's wire): ``"per-leaf"``, every
    leaf its own scale group (``compression.scale_groups``);
    ``"embed-f32"``, the embedding's gradient passes the one-participant
    wire unquantized (``compression.compress_decompress``)."""

    def __init__(self, variant=None):
        self.variant, self.calls = variant, []

    def __enter__(self):
        import torch

        from repro_torch.dist import compression as CP
        from repro_torch.tree import tree_leaves
        self.real = CP._quantize, CP.scale_groups, CP.compress_decompress

        def tap(x, s):
            q = self.real[0](x, s)
            self.calls.append((q.numel(), (q == 0).sum()))
            return q

        def one_a_leaf(tree):
            n = len(tree_leaves(tree))
            return list(range(n)), n

        def embed_f32(grads, ef_state=None, model=None):
            keep = lambda t: {k: v for k, v in t.items()  # noqa: E731
                              if k != "embed"}
            out, ef = self.real[2](
                keep(grads), None if ef_state is None else keep(ef_state),
                model)
            zero = {k: torch.zeros_like(v)
                    for k, v in grads["embed"].items()}
            return ({k: grads[k] if k == "embed" else out[k]
                     for k in grads},
                    {k: (zero if ef_state is None else ef_state[k])
                     if k == "embed" else ef[k] for k in grads})

        CP._quantize = tap
        if self.variant == "per-leaf":
            CP.scale_groups = one_a_leaf
        elif self.variant == "embed-f32":
            CP.compress_decompress = embed_f32
        return self

    def __exit__(self, *exc):
        from repro_torch.dist import compression as CP
        CP._quantize, CP.scale_groups, CP.compress_decompress = self.real
        return False

    def shares(self):
        """(the zero share of the largest leaf, of the others), or None
        when nothing was quantized."""
        if not self.calls:
            return None
        big = max(n for n, _ in self.calls)
        out = []
        for pick in (lambda n: n == big, lambda n: n != big):
            n = sum(k for k, _ in self.calls if pick(k))
            z = sum(float(z) for k, z in self.calls if pick(k))
            out.append(z / n if n else None)
        return tuple(out)


# the runs of ``--card``: (name, compress, ``_ZeroTap`` variant)
CARD_RUNS = (("f32", False, None), ("int8", True, None),
             ("int8 one scale a layer", True, "per-leaf"),
             ("int8 the embedding unquantized", True, "embed-f32"))


def _card_rank(mesh, layers_list, seed):
    """The ``CARD_RUNS`` of gemma-7b at each depth on this model rank:
    {(depth, name): (losses, the int8 zero shares or None)}."""
    import torch

    C._rank_prelude(torch)
    out = {}
    for layers in layers_list:
        for name, compress, variant in CARD_RUNS:
            with _ZeroTap(variant) as tap:
                rec = C._tp_main_run(mesh.model, seed, "gemma-7b", layers,
                                     STEPS, compress)
            out[(layers, name)] = (rec["losses"], tap.shares())
            del rec
            torch.cuda.empty_cache()
    return out


def card(layers_list) -> int:
    """``--card``: see the module's docstring."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch

    from repro_torch.dist.group import run_ranks

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("--card needs 4 CUDA devices", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    C.phase_build()
    recs = run_ranks(_card_rank, 4, backend="nccl", model=4,
                     args=(layers_list, SEED), timeout_s=1500.0)
    same = all(r[k][0] == recs[0][k][0] for r in recs for k in r)
    for layers in layers_list:
        f32 = recs[0][(layers, "f32")][0]
        for name, compress, _ in CARD_RUNS:
            losses, zeros = recs[0][(layers, name)]
            gap = "" if not compress else (
                f"; |{name} - f32| per step "
                f"{[abs(a - b) for a, b in zip(f32, losses)]}; zeros over "
                f"its steps (rank 0): the largest leaf quantized (the "
                f"embedding where it is) {zeros[0]}, the others {zeros[1]}")
            C.log(f"[tp-int8-depth card] gemma-7b {layers} layers, 4 model "
                  f"ranks (nccl), {name}: losses {losses}{gap}")
    C.log(f"[tp-int8-depth card] the ranks' losses equal: {same}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    C.log(f"[wall] {time.perf_counter() - t0:.1f} s")
    print(smi.stdout.strip())
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[5, 28])
    ap.add_argument("--model", type=int, default=4)
    ap.add_argument("--card", action="store_true",
                    help="gemma-7b at full width on 4 cards (NCCL)")
    args = ap.parse_args(argv)
    if args.card:
        return card(args.layers)

    import torch

    from repro_torch.dist.group import run_ranks
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_leaves

    torch.manual_seed(SEED)
    ok = True
    for layers in args.layers:
        cfg = _cfg(layers)
        full = build_model(cfg, "cpu").init(
            torch.Generator().manual_seed(SEED))
        n_params = sum(math.prod(x.shape) for x in tree_leaves(full))
        f32 = _steps(torch, cfg, full, False)
        qs = []
        int8 = _steps(torch, cfg, full, True, qs=qs)
        zeros = [float((q == 0).sum()) / q.numel() for q in qs]
        recs = run_ranks(_rank, args.model, backend="gloo", device="cpu",
                         model=args.model, args=(layers,), timeout_s=1800.0)
        split = recs[0]["losses"]
        noise = [abs(b - a) for a, b in zip(f32, int8)]
        gap = [max(abs(c - b) for c, b in zip(r["losses"], r["one"]))
               for r in recs]
        print(f"[tp-int8-depth] {layers} layers ({n_params} parameters): "
              f"f32 {f32}; int8 one rank {int8}; int8 model {args.model} "
              f"{split}")
        print(f"[tp-int8-depth] {layers} layers: |int8 - f32| per step "
              f"{noise}; |int8 model {args.model} - int8 one rank| max per "
              f"rank {gap}; int8 zeros a step (one rank) {zeros}; int8 values "
              f"differing from the one-rank run's slices, per rank and step "
              f"{[r['flips'] for r in recs]} of "
              f"{[r['values'] for r in recs]}")
        ok = ok and max(gap) <= 1e-4
    print(f"[tp-int8-depth] {'ok' if ok else 'FAILED'}: the split int8 run "
          f"within 1e-4 of the one-rank int8 run at every depth")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
