"""End-to-end training driver of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 20 --seq 4096 --batch 8 [--smoke] [--device cuda|cpu] \\
      [--ckpt DIR [--ckpt-every N] [--resume]] \\
      [--data N [--fsdp]] [--model M] [--dist-backend nccl|gloo] \\
      [--compress-grads]

``--device cuda`` (the default) runs the attention kernels and raises
without a CUDA device; ``--device cpu`` runs their plain versions.
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

``--data N`` trains data-parallel over N local ranks started by
:func:`repro_torch.dist.group.run_ranks`: every rank draws the global
batch of the step and trains on its ``--batch / N`` rows, the f32
gradients summed by one ``all_reduce`` a step, so the losses equal
``--data 1``'s. ``--compress-grads`` sends the gradient as int8 with
per-rank error feedback instead (:mod:`repro_torch.dist.compression`;
with ``--data 1`` it quantize-dequantizes locally). ``--dist-backend``
picks the ranks' backend: ``nccl`` (the default with ``--device cuda``)
puts rank r on ``cuda:r`` and needs N cards, ``gloo`` (the default with
``--device cpu``) puts every rank on the one device ``--device`` names.
With fewer cards than ranks, NCCL is an error that names ``--dist-backend
gloo``. Rank 0 alone prints and writes the checkpoint, the trace and the
metrics; every rank resumes from the same checkpoint, so a checkpoint of
an N-rank run resumes on any rank count. The error-feedback residual is
not checkpointed (nor is it in the reference's CLI):

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --smoke --device cpu --data 2 --dist-backend gloo --steps 3

``--model M`` trains tensor-parallel (the reference's "model" mesh axis)
over M ranks, alone or with ``--data D`` on D x M ranks (the ``(data,
model)`` mesh, model the fast axis): each rank holds its slices of the
attention heads, the MLP's ffn and the vocabulary
(:func:`repro_torch.dist.sharding.mesh_placements`, printed once), cut
from the single-device draw of ``--seed``, so the losses equal ``--model
1``'s. Every arch runs so. The MoE archs (arctic-480b, kimi-k2-1t-a32b)
split their expert stacks too, E / M experts a rank (expert parallelism;
M must divide the expert count), each rank drawing only its own experts;
recurrentgemma-9b and mamba2-370m split their RG-LRU and SSD blocks on
``d_rnn`` and their heads, the whole gate and conv leaves' gradients
summed over the model group once a step; qwen2-vl-2b merges its vision
tokens after the vocab-parallel lookup, and whisper-base splits its
encoder and its cross attention's heads as well. An expert count M does
not divide raises ``NotImplementedError`` (ROADMAP queue 1,
'multi-GPU'). ``--compress-grads`` runs with it: each int8 scale is the
whole tensor's (the ranks' absmax maxed over the model group), so a
rank's int8 values are its slices of ``--model 1``'s. The checkpoint
holds the whole leaves, gathered over the model group, so it is the
single-device checkpoint of the same state and resumes on any layout:

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --smoke --device cpu --dist-backend gloo --model 2 [--data 2]
  PYTHONPATH=src python -m repro_torch.launch.train --arch arctic-480b \\
      --smoke --device cpu --dist-backend gloo --model 2
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch recurrentgemma-9b --smoke --device cpu --dist-backend gloo \\
      --model 2

``--fsdp`` (with ``--data N``, alone or with ``--model M``) is the
reference's FSDP fallback, ``DEFAULT_RULES["fsdp"]``, which the
reference's own CLI turns off: each weight that no model rule splits and
that has at least 2 dims is held as this rank's slice of its largest dim
over the N data ranks (with its AdamW moments), gathered a layer at a
time inside the remat replay, its gradient reduce-scattered in f32
(:func:`repro_torch.dist.sharding.mesh_placements`, printed once). The
losses equal ``--data N``'s; every rank takes part in a checkpoint's
gather, whose file is the single-device one. With ``--data 1`` it changes
nothing. With ``--compress-grads`` each rank quantizes its whole
gradient of a split weight and receives only its slice's sum (one
``all_to_all`` of int8 values), so the losses and the slices equal
``--data N --compress-grads``'s; the residual stays whole on every rank:

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --smoke --device cpu --dist-backend gloo --data 2 --fsdp [--model 2]
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --smoke --device cpu --dist-backend gloo --data 2 --fsdp \\
      --compress-grads
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.convert import checkpoint_from_jax, is_jax_checkpoint
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.dist.group import BACKENDS, run_ranks
from repro_torch.dist.sharding import describe
from repro_torch.ft.checkpoint import CheckpointManager, latest_step, restore
from repro_torch.ft.manager import StragglerWatchdog, reshard
from repro_torch.models.model import build_model
from repro_torch.obs import Observability
from repro_torch.obs.metrics import global_registry
from repro_torch.optim import adamw
from repro_torch.optim.schedule import Schedule
from repro_torch.train.trainer import (TrainConfig, check_tensor_parallel,
                                       init_shards,
                                       make_train_step, state_shardings,
                                       train_placements)
from repro_torch.tree import tree_leaves


# the MoE aux metrics the step log shows, by their short names
_AUX_LOG = (("load_balance", "lb"), ("router_z", "z"),
            ("dropped_frac", "dropped"))


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda runs the kernels; cpu their plain versions")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8,
                    help="the global batch (split over --data ranks)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 gradients with error feedback on the "
                         "data-parallel wire (with --model and --fsdp "
                         "too)")
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel ranks")
    ap.add_argument("--fsdp", action="store_true",
                    help="with --data: hold each weight no model rule "
                         "splits as this rank's slice of its largest dim "
                         "(the reference's FSDP fallback)")
    ap.add_argument("--model", type=int, default=1,
                    help="tensor-parallel ranks (heads, ffn and vocab "
                         "split; an MoE arch's experts too)")
    ap.add_argument("--dist-backend", choices=BACKENDS, default=None,
                    help="the ranks' backend with --data or --model > 1: "
                         "nccl (one card per rank; default with --device "
                         "cuda) or gloo (every rank on --device; default "
                         "with --device cpu)")
    ap.add_argument("--dist-timeout", type=float, default=3600.0,
                    help="seconds the ranks of --data or --model > 1 may "
                         "take in all (and any collective may wait)")
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
    return ap


def main(argv=None):
    ap = _parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)

    if args.resume and not args.ckpt:
        ap.error("--resume needs --ckpt")
    if args.data < 1 or args.model < 1:
        ap.error("--data and --model must be >= 1")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device and "
                           "torch.cuda.is_available() is False; pass "
                           "--device cpu to run the plain versions")
    n = args.data * args.model
    check_tensor_parallel(get_smoke(args.arch) if args.smoke
                          else get_config(args.arch), args.model)
    if n == 1:
        return _train(args, None, None)
    backend = args.dist_backend or ("nccl" if args.device == "cuda"
                                    else "gloo")
    if backend == "nccl":
        have = torch.cuda.device_count() if args.device == "cuda" else 0
        if have < n:
            ap.error(f"--dist-backend nccl puts one rank on each card: "
                     f"--data {args.data} x --model {args.model} needs {n} "
                     f"CUDA devices with --device cuda, this run has "
                     f"{have}; pass --dist-backend gloo to run the ranks on "
                     f"one shared --device")
    return run_ranks(_train_rank, n, backend=backend,
                     device=None if backend == "nccl" else args.device,
                     timeout_s=args.dist_timeout, args=(argv,),
                     model=args.model)[0]


def _train_rank(mesh, argv):
    """One rank of ``--data`` or ``--model > 1``."""
    return _train(_parser().parse_args(argv), mesh.data, mesh.model)


def _train(args, data, mg):
    """Train on one device (``data`` and ``mg`` None) or as one rank of
    the ``(data, model)`` mesh; only rank 0 prints and writes the trace
    and the metrics, and the ranks of data index 0 write the checkpoint
    (its model group gathers, its rank 0 writes). Returns the final
    loss."""
    lead = (data is None or data.index == 0) and (mg is None
                                                  or mg.index == 0)
    say = print if lead else (lambda *a, **k: None)
    rank = data or mg
    device = args.device if rank is None else str(rank.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device)
    tcfg = TrainConfig(
        optimizer=adamw.AdamWConfig(lr=args.lr),
        schedule=Schedule(warmup_steps=max(10, args.steps // 20),
                          total_steps=args.steps),
        microbatches=args.microbatches, compress_grads=args.compress_grads)
    fsdp = args.fsdp and data is not None
    step = make_train_step(model, tcfg, data=data, model_group=mg,
                           fsdp=fsdp)
    gen = torch.Generator().manual_seed(args.seed)
    params = model.init(gen) if mg is None and not fsdp else \
        init_shards(model, gen, mg, data, fsdp)
    opt = adamw.init(tcfg.optimizer, params)
    n_par = sum(x.numel() for x in tree_leaves(params))
    say(f"# arch={cfg.name} params={n_par / 1e6:.1f}M"
        + ("" if mg is None and not fsdp else " (rank 0's slices)")
        + f" device={device} window={cfg.salo.window} "
        f"sinks={cfg.salo.n_global}"
        + ("" if data is None else f" data={data.size} ({data.backend})")
        + ("" if mg is None else f" model={mg.size} ({mg.backend})")
        + (" fsdp" if fsdp else "")
        + (" compress_grads" if args.compress_grads else ""))
    shards = None
    if mg is not None or fsdp:
        n = 1 if mg is None else mg.size
        placements = train_placements(model, mg, data, fsdp)
        say(f"# placements over "
            + (f"{data.size} data x {n} model ranks (fsdp): " if fsdp else
               f"{n} model ranks: ") + describe(params, placements))
        shards = state_shardings(placements, opt)
    dg = data if fsdp else None       # the group a checkpoint gathers over

    start = 0
    if args.resume:
        like = {"params": params, "opt": opt}
        step0 = latest_step(args.ckpt)
        if step0 is not None:
            if is_jax_checkpoint(args.ckpt, step0):
                restored, _ = checkpoint_from_jax(args.ckpt, like, step0)
                if shards is not None:
                    restored = reshard(restored, shards, mg, data_group=dg)
            else:
                restored = restore(args.ckpt, like, step0, shards, mg, dg)
            params, opt = restored["params"], restored["opt"]
            start = step0
            say(f"# resumed from step {start}")
    # the ranks of data index 0 hold the whole state between them; under
    # fsdp every rank holds a part of it, and every rank gathers
    mgr = CheckpointManager(args.ckpt, keep=3) if args.ckpt and (
        data is None or data.index == 0 or fsdp) else None

    ds = SyntheticLM(cfg, DataConfig(args.seq, args.batch, seed=args.seed,
                                     branch=args.data_branch,
                                     n_docs=args.data_docs))
    wd = StragglerWatchdog()
    obs = Observability(tracing=bool(args.trace_out) and lead)
    reg = obs.registry
    loss, ef = float("nan"), None
    try:
        for i in range(start, args.steps):
            t0 = time.perf_counter()
            with obs.tracer.span("train.step", track="train", step=i):
                params, opt, metrics, ef = step(params, opt, ds.batch(i), ef)
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
                say(f"step {i:5d} loss {loss:8.4f} "
                    f"gnorm {float(metrics['grad_norm']):7.3f}{aux} "
                    f"{dt * 1e3:7.1f} ms {toks / 1e3:7.1f} ktok/s"
                    + (" [straggler]" if straggler else ""), flush=True)
            if mgr and (i + 1) % args.ckpt_every == 0:
                mgr.save({"params": params, "opt": opt}, i + 1, shards, mg,
                         dg)
                obs.tracer.instant("ft.snapshot", track="ft", step=i + 1)
        if mgr:
            mgr.save({"params": params, "opt": opt}, args.steps, shards,
                     mg, dg)
    finally:
        if mgr:   # a checkpoint in flight lands even when a step raised
            mgr.wait()
    if args.trace_out and lead:
        obs.write_trace(args.trace_out)
        print(f"# trace: {args.trace_out} ({len(obs.tracer)} events)",
              file=sys.stderr)
    if args.metrics_out and lead:
        reg.merge(global_registry().snapshot())
        obs.write_metrics(args.metrics_out)
        print(f"# metrics: {args.metrics_out}", file=sys.stderr)
    st = reg.percentiles("train_step_s")
    say(f"# done: final loss {loss:.4f}, straggler events {wd.events}, "
        f"step p50 {st['p50'] * 1e3:.1f} ms", flush=True)
    return loss


if __name__ == "__main__":
    main()
