"""End-to-end training driver of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 20 --seq 4096 --batch 8 [--smoke] [--device cuda|cpu] \\
      [--ckpt DIR [--ckpt-every N] [--resume]]

One device. ``--device cuda`` (the default) runs the attention kernels and
raises without a CUDA device; ``--device cpu`` runs their plain versions.
SALO attention, grad clip + schedule, straggler watchdog, restart-safe
data stream (stateless in the step). ``--ckpt DIR`` saves ``{"params",
"opt"}`` every ``--ckpt-every`` steps and at the end through the atomic,
keep-3, async :class:`~repro_torch.ft.checkpoint.CheckpointManager`;
``--resume`` restores the latest checkpoint there and continues from its
step; a checkpoint written by the reference's CLI (``repro.launch.train
--ckpt``: stacked segments) is unstacked on the way in
(:func:`repro_torch.convert.checkpoint_from_jax`). The batches are a
function of the step, so a resumed run sees the batches an uninterrupted
run would. ``--trace-out`` writes a Chrome trace
of the step spans, ``--metrics-out`` the metrics registry (step-time
histogram, token/step counters, per-kernel launch accounting). MoE
models log their aux losses (load balance, router z) and the share of
dropped (token, expert) entries beside the loss. Every arch of the registry
trains here, the VLM with its vision extras and M-RoPE positions and
whisper with its audio frames (``SyntheticLM``).

Not ported yet, and raising ``NotImplementedError``: ``--compress-grads``
and ``--data``/``--model`` > 1 (ROADMAP queue 1, 'multi-GPU').
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.convert import checkpoint_from_jax, is_jax_checkpoint
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.ft.checkpoint import CheckpointManager, latest_step
from repro_torch.ft.manager import StragglerWatchdog
from repro_torch.models.model import build_model
from repro_torch.obs import Observability
from repro_torch.obs.metrics import global_registry
from repro_torch.optim import adamw
from repro_torch.optim.schedule import Schedule
from repro_torch.train.trainer import TrainConfig, make_train_step
from repro_torch.tree import tree_leaves


# the MoE aux metrics the step log shows, by their short names
_AUX_LOG = (("load_balance", "lb"), ("router_z", "z"),
            ("dropped_frac", "dropped"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda runs the kernels; cpu their plain versions")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-branch", type=int, default=16)
    ap.add_argument("--data-docs", type=int, default=64)
    ap.add_argument("--trace-out", default=None,
                    help="write Chrome trace-event JSON of the step "
                         "timeline here at exit")
    ap.add_argument("--metrics-out", default=None,
                    help="write the full metrics-registry JSON here at exit")
    args = ap.parse_args(argv)

    if args.resume and not args.ckpt:
        ap.error("--resume needs --ckpt")
    if args.compress_grads or args.data > 1 or args.model > 1:
        raise NotImplementedError(
            "--compress-grads and --data/--model > 1 are not ported yet: "
            "ROADMAP queue 1, 'multi-GPU'")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device and "
                           "torch.cuda.is_available() is False; pass "
                           "--device cpu to run the plain versions")

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, args.device)
    tcfg = TrainConfig(
        optimizer=adamw.AdamWConfig(lr=args.lr),
        schedule=Schedule(warmup_steps=max(10, args.steps // 20),
                          total_steps=args.steps),
        microbatches=args.microbatches)
    params = model.init(torch.Generator().manual_seed(args.seed))
    opt = adamw.init(tcfg.optimizer, params)
    n_par = sum(x.numel() for x in tree_leaves(params))
    print(f"# arch={cfg.name} params={n_par / 1e6:.1f}M device={args.device}"
          f" window={cfg.salo.window} sinks={cfg.salo.n_global}")

    mgr = CheckpointManager(args.ckpt, keep=3) if args.ckpt else None
    start = 0
    if mgr and args.resume:
        like = {"params": params, "opt": opt}
        step0 = latest_step(args.ckpt)
        if step0 is None:
            restored = None
        elif is_jax_checkpoint(args.ckpt, step0):
            restored, _ = checkpoint_from_jax(args.ckpt, like, step0)
        else:
            restored, _ = mgr.restore_latest(like)
        if restored is not None:
            params, opt = restored["params"], restored["opt"]
            start = step0
            print(f"# resumed from step {start}")

    step = make_train_step(model, tcfg)
    ds = SyntheticLM(cfg, DataConfig(args.seq, args.batch, seed=args.seed,
                                     branch=args.data_branch,
                                     n_docs=args.data_docs))
    wd = StragglerWatchdog()
    obs = Observability(tracing=bool(args.trace_out))
    reg = obs.registry
    loss = float("nan")
    try:
        for i in range(start, args.steps):
            t0 = time.perf_counter()
            with obs.tracer.span("train.step", track="train", step=i):
                params, opt, metrics = step(params, opt, ds.batch(i))
                loss = float(metrics["loss"])   # host sync inside the span
            dt = time.perf_counter() - t0
            reg.inc("train_steps")
            reg.inc("train_tokens", args.batch * args.seq)
            reg.observe("train_step_s", dt)
            straggler = wd.observe(dt)
            if straggler:
                reg.inc("ft_straggler_events")
                obs.tracer.instant("ft.straggler", track="ft", step=i,
                                   step_time_s=round(dt, 6))
            if i % args.log_every == 0 or i == args.steps - 1:
                toks = args.batch * args.seq / dt
                aux = "".join(f" {name} {float(metrics[key]):.4g}"
                              for key, name in _AUX_LOG if key in metrics)
                print(f"step {i:5d} loss {loss:8.4f} "
                      f"gnorm {float(metrics['grad_norm']):7.3f}{aux} "
                      f"{dt * 1e3:7.1f} ms {toks / 1e3:7.1f} ktok/s"
                      + (" [straggler]" if straggler else ""), flush=True)
            if mgr and (i + 1) % args.ckpt_every == 0:
                mgr.save({"params": params, "opt": opt}, i + 1)
                obs.tracer.instant("ft.snapshot", track="ft", step=i + 1)
        if mgr:
            mgr.save({"params": params, "opt": opt}, args.steps)
    finally:
        if mgr:   # a checkpoint in flight lands even when a step raised
            mgr.wait()
    if args.trace_out:
        obs.write_trace(args.trace_out)
        print(f"# trace: {args.trace_out} ({len(obs.tracer)} events)",
              file=sys.stderr)
    if args.metrics_out:
        reg.merge(global_registry().snapshot())
        obs.write_metrics(args.metrics_out)
        print(f"# metrics: {args.metrics_out}", file=sys.stderr)
    st = reg.percentiles("train_step_s")
    print(f"# done: final loss {loss:.4f}, straggler events {wd.events}, "
          f"step p50 {st['p50'] * 1e3:.1f} ms")
    return loss


if __name__ == "__main__":
    main()
