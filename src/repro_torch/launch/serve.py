"""Serving driver of the port: the continuous-batching engine (default)
or the lockstep baseline.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --batch 8 --prompt-len 1024 --new-tokens 64 --chunk 128 --page 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --smoke --device cpu --batch 4 --prompt-len 32 --new-tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --smoke --device cpu --kv-dtype int8 --page-sparsity-threshold -3 \\
      --page-stat-decay 0.3
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --smoke --device cpu --engine lockstep
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch recurrentgemma-9b --smoke --device cpu --engine lockstep
  PYTHONPATH=src python -m repro_torch.launch.serve --arch arctic-480b \\
      --smoke --device cpu [--engine lockstep]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \\
      --smoke --device cpu --engine lockstep

Random weights from ``--seed``. ``--engine continuous`` (greedy) submits a
RAGGED batch (prompt lengths spread around ``--prompt-len``) to the
paged-slab engine and reports launch counters beside throughput;
``--kv-dtype int8`` stores the slab quantized per (layer, page), and
``--page-sparsity-threshold``/``--page-stat-decay`` turn on page skipping.
``--engine lockstep`` prefills a rectangular batch token by token and
decodes it in lockstep (greedy, or sampled with ``--temperature``); the
recurrent archs (``recurrentgemma-9b``, ``mamba2-370m``) serve only
there, and ``--engine continuous`` raises ``NotImplementedError`` for
them, as the reference's engine does; so do the VLM (``qwen2-vl-2b``:
text-only decode, M-RoPE positions advancing together) and the
encoder-decoder (``whisper-base``: its cross caches stay zero, as the
reference's engine leaves them). The MoE archs (``arctic-480b``,
``kimi-k2-1t-a32b``) serve on both engines. Runs
on the card unless ``--device cpu`` is given; with no card, ``--device
cuda`` (the default) raises.

``--snapshot-dir DIR`` runs the continuous engine under the fault-tolerant
:class:`~repro_torch.ft.manager.ServeSupervisor`: full engine snapshots
(slabs, page tables, request lifecycle) every ``--snapshot-every`` steps
through the atomic keep-k writer, a fresh engine restored from the latest
snapshot on every recoverable fault, at most ``--max-restarts`` times.
Token output is exactly-once across kill and resume. ``--inject-crash-at``
takes a comma list of step attempts to crash (needs ``--snapshot-dir``):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --smoke --device cpu --snapshot-dir /tmp/snap --inject-crash-at 3,7

``--trace-out trace.json`` writes the continuous engine's step-phase spans
and every request's lifecycle events (and the supervisor's fault,
snapshot and restore events) as Chrome trace-event JSON at exit;
``--metrics-out`` dumps the metrics registry; ``--summary-every N`` prints
a one-line stderr summary every N engine steps.

``--seq-shards N`` (continuous engine) serves sequence-parallel over N
local ranks started by :func:`repro_torch.dist.group.run_ranks`, one
engine per rank holding its shard of every request's KV; rank 0 prints
the result lines. ``--dist-backend`` picks the ranks' backend: ``nccl``
(the default with ``--device cuda``) puts rank r on ``cuda:r`` and needs N
cards; ``gloo`` (the default with ``--device cpu``) puts every rank on the
one device ``--device`` names, so N ranks can share one card. With fewer
cards than shards, NCCL is an error that names ``--dist-backend gloo``; the
backend is never switched silently. Greedy tokens equal ``--seq-shards 1``'s:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --smoke --device cpu --seq-shards 2 --dist-backend gloo
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.dist.group import run_ranks
from repro_torch.ft import FaultInjector, FaultPlan, ServeSupervisor
from repro_torch.models.layers import salo_pattern
from repro_torch.models.model import build_model
from repro_torch.obs import Observability, summary_line
from repro_torch.serve.engine import (ContinuousConfig, ContinuousEngine,
                                     ServeConfig, ServeEngine,
                                     require_attention_program)
from repro_torch.serve.paged_cache import layout_for_pattern


def _ragged_lengths(base: int, batch: int, rng) -> list:
    """Prompt lengths spread around ``base`` (min 2)."""
    return [max(2, int(n)) for n in
            rng.integers(max(2, base // 2), base + 1, batch)]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--engine", choices=("lockstep", "continuous"),
                    default="continuous")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--page", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=0,
                    help="engine rows (0 = --batch)")
    ap.add_argument("--kv-dtype", choices=("compute", "int8"),
                    default="compute",
                    help="paged-slab storage dtype (continuous engine): "
                         "'int8' stores K/V quantized per (layer, page) "
                         "with f32 scales, dequantized in-kernel")
    ap.add_argument("--page-sparsity-threshold", type=float, default=None,
                    help="continuous engine: skip reading pages whose "
                         "historical max attention score (log-space, "
                         "relative to the row max) fell below this; sink "
                         "and write pages are always read. Unset = dense "
                         "reads; -inf = track stats but keep everything")
    ap.add_argument("--page-stat-decay", type=float, default=0.0,
                    help="per-step decay of the per-page score history; "
                         "must be > 0 for --page-sparsity-threshold to "
                         "ever skip a page")
    ap.add_argument("--snapshot-dir", default=None,
                    help="continuous engine: run under the ServeSupervisor "
                         "with engine snapshots in this directory "
                         "(fault-tolerant serving)")
    ap.add_argument("--snapshot-every", type=int, default=4,
                    help="engine steps between snapshots")
    ap.add_argument("--max-restarts", type=int, default=4,
                    help="restart budget before RestartsExhausted")
    ap.add_argument("--inject-crash-at", default=None,
                    help="comma list of step attempts at which to inject "
                         "a StepCrash (needs --snapshot-dir)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound the admission queue; unset = unbounded")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline in seconds")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace-event JSON here at exit")
    ap.add_argument("--metrics-out", default=None,
                    help="write the full metrics-registry JSON here at exit")
    ap.add_argument("--summary-every", type=int, default=0,
                    help="print a one-line metrics summary to stderr every "
                         "N engine steps (0 = off)")
    ap.add_argument("--seq-shards", type=int, default=1,
                    help="continuous engine: serve sequence-parallel over "
                         "this many local ranks")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    default=None,
                    help="the ranks' backend with --seq-shards > 1: nccl "
                         "(one card per rank; default with --device cuda) "
                         "or gloo (every rank on --device; default with "
                         "--device cpu)")
    ap.add_argument("--dist-timeout", type=float, default=3600.0,
                    help="seconds the ranks of --seq-shards > 1 may take "
                         "in all (and any collective may wait)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    ap = _parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device and "
                           "torch.cuda.is_available() is False; pass "
                           "--device cpu to run the plain versions")

    if args.engine != "continuous" and (args.trace_out or args.metrics_out
                                        or args.summary_every
                                        or args.snapshot_dir):
        ap.error("--trace-out/--metrics-out/--summary-every/--snapshot-dir "
                 "need --engine continuous (the instrumented engine)")
    if args.inject_crash_at and not args.snapshot_dir:
        ap.error("--inject-crash-at needs --snapshot-dir")
    if args.engine == "continuous" and args.temperature != 0.0:
        ap.error("--engine continuous is greedy-only "
                 "(temperature sampling needs per-request RNG streams)")
    if args.seq_shards < 1:
        ap.error("--seq-shards must be >= 1")
    if args.seq_shards == 1:
        return _serve(args, None)
    if args.engine != "continuous":
        ap.error("--seq-shards > 1 needs --engine continuous")
    backend = args.dist_backend or ("nccl" if args.device == "cuda"
                                    else "gloo")
    if backend == "nccl":
        have = torch.cuda.device_count() if args.device == "cuda" else 0
        if have < args.seq_shards:
            ap.error(f"--dist-backend nccl puts one rank on each card: "
                     f"--seq-shards {args.seq_shards} needs "
                     f"{args.seq_shards} CUDA devices with --device cuda, "
                     f"this run has {have}; pass --dist-backend gloo to run "
                     f"the ranks on one shared --device")
    return run_ranks(_serve_rank, args.seq_shards, backend=backend,
                     device=None if backend == "nccl" else args.device,
                     timeout_s=args.dist_timeout, args=(argv,))[0]


def _serve_rank(group, argv):
    """One rank of ``--seq-shards > 1``."""
    return _serve(_parser().parse_args(argv), group)


def _serve(args, group):
    """Serve on one device (``group`` None) or as one rank of a sequence
    group; only rank 0 prints and writes the trace and metrics."""
    lead = group is None or group.index == 0
    device = args.device if group is None else str(group.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device)
    params = model.init(torch.Generator().manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    if args.engine == "lockstep":
        return _lockstep(args, cfg, model, params, rng)
    require_attention_program(model)
    max_batch = args.max_batch or args.batch
    lay = layout_for_pattern(salo_pattern(cfg, causal=True), args.page,
                             shards=args.seq_shards)
    ccfg = ContinuousConfig(
        n_pages=1 + max_batch * lay.pages_per_shard, page=args.page,
        chunk=args.chunk, max_batch=max_batch, seq_shards=args.seq_shards,
        kv_dtype=args.kv_dtype,
        page_sparsity_threshold=args.page_sparsity_threshold,
        page_stat_decay=args.page_stat_decay, max_queue=args.max_queue)
    lens = _ragged_lengths(args.prompt_len, args.batch, rng)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in lens]
    # ONE obs bundle shared by the engine, the batcher and the supervisor,
    # and across supervisor restarts, so the exported trace holds the
    # whole timeline including kills and restores.
    obs = Observability(tracing=bool(args.trace_out))

    def summarize():
        if lead and args.summary_every and \
                obs.registry.total("serve_engine_steps") \
                % args.summary_every == 0:
            print(f"# {summary_line(obs.registry)}", file=sys.stderr,
                  flush=True)

    def make_engine():
        eng = ContinuousEngine(model, ccfg, device=device, obs=obs,
                               group=group)
        for p in prompts:
            eng.submit(p, args.new_tokens, deadline_s=args.deadline_s)
        return eng

    t0 = time.perf_counter()
    if args.snapshot_dir:
        injector = None
        if args.inject_crash_at:
            injector = FaultInjector(FaultPlan(crash_steps=frozenset(
                int(s) for s in args.inject_crash_at.split(","))))
        sup = ServeSupervisor(
            make_engine, params, args.snapshot_dir,
            checkpoint_every=args.snapshot_every,
            max_restarts=args.max_restarts, injector=injector, obs=obs,
            on_step=lambda eng, hist: summarize(), group=group)
        eng, history = sup.run()
        if lead:
            print(f"# supervisor: {history}")
        if lead and eng.batcher.failures():
            print(f"# failed: {eng.batcher.failures()}")
    else:
        eng = make_engine()
        while eng.step(params):
            summarize()
    results = eng.batcher.results()
    dt = time.perf_counter() - t0
    if not lead:
        return results
    if args.trace_out:
        obs.write_trace(args.trace_out)
        print(f"# trace: {args.trace_out} ({len(obs.tracer)} events)",
              file=sys.stderr)
    if args.metrics_out:
        obs.write_metrics(args.metrics_out)
        print(f"# metrics: {args.metrics_out}", file=sys.stderr)
    total_new = sum(len(r) for r in results.values())
    print(f"# arch={cfg.name} engine=continuous device={args.device} "
          f"batch={args.batch} prompts={lens} new={args.new_tokens} "
          f"chunk={args.chunk} page={args.page} "
          f"seq_shards={args.seq_shards}"
          f"{'' if group is None else f' backend={group.backend}'} "
          f"kv_dtype={args.kv_dtype} page_thr={args.page_sparsity_threshold}")
    print(f"# {dt:.2f}s total, {total_new / dt:.1f} tok/s "
          f"(includes kernel build); counters={eng.counters}")
    for rid in sorted(results)[:2]:
        print(f"sample[{rid}]: {results[rid][:16].tolist()}")
    return results


def _lockstep(args, cfg, model, params, rng):
    """The lockstep baseline: a rectangular batch, prefilled token by
    token, decoded in lockstep. Returns the (B, new) tokens."""
    max_len = args.prompt_len + args.new_tokens
    eng = ServeEngine(model, ServeConfig(max_len=max_len,
                                         temperature=args.temperature,
                                         seed=args.seed))
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    t0 = time.perf_counter()
    toks = eng.generate(params, prompts, args.new_tokens).cpu().numpy()
    dt = time.perf_counter() - t0
    total_new = args.batch * args.new_tokens
    print(f"# arch={cfg.name} engine=lockstep device={args.device} "
          f"batch={args.batch} prompt={args.prompt_len} "
          f"new={args.new_tokens} temperature={args.temperature}")
    print(f"# {dt:.2f}s total, {total_new / dt:.1f} tok/s "
          f"(includes kernel build)")
    for b in range(min(args.batch, 2)):
        print(f"sample[{b}]: {toks[b][:16].tolist()}")
    return toks


if __name__ == "__main__":
    main()
