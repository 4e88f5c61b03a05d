#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout; it puts ``<checkout>/src`` on
``sys.path`` itself, imports only the port (``repro_torch``) and never
JAX. Phases, in order; any failed check raises, so the exit code is
nonzero:

1. **build** — compile every CUDA kernel in ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` each, all at once) and print the build time.
2. **kernels** — hold each decode kernel against its plain PyTorch
   version on the card, on rows that attend at least one slot. K4 (paged
   slab): (a) the serve phase's shapes in bf16 with ragged ``t`` past the
   ring wrap and shuffled physical pages, (b) the same in f32, (c) page 8,
   rep 1, hd 128, dilation 2, f16, one all-PAD row, (d) the serve shapes
   with an int8 slab (bf16 compute) and page statistics, (e) the serve
   shapes in f32 with ``return_state`` and page statistics, one all-PAD
   row (which must give the (0, NEG_INF, 0) identity), (f) one request
   (B = 1) at the serve shapes, t = 3000 (the single-user long-cache
   decode), (g) gemma-7b's decode (16 heads of hd 256, no GQA) at the
   serve shapes in bf16. ``page_m`` must be equal where either side is NEG_INF. K5
   (contiguous caches, read through the transposed view of the lockstep
   (B, S, Hkv, hd) cache): (a) the lockstep phase's cache in bf16, slot =
   position, (b) the same in f32, (c) the ring layout (window 512 + 4
   sinks, dilation 2, PAD ring slots). Tolerances: f32 1e-5, bf16/f16
   2e-2 (abs and rel; the kernels round p to the 16-bit type before the
   PV product, the plain versions keep it in f32). Every case's outputs
   must be bitwise equal over repeated calls (the split-KV merge does not
   depend on which block finishes last). Prints the split the planner
   chose (``n_split``, ``split_len``) and each kernel's, its plain
   version's and ``scaled_dot_product_attention``'s times (a yardstick
   only; for K4 on the pre-gathered view, gather not timed) beside the
   bound.
3. **serve-check** — a 2-layer, hd-64 f32 model served on the card
   (kernel) and on the CPU (plain version): greedy tokens must be equal,
   (1) on the fp slab, (2) on the int8 slab with page skipping (window 64,
   threshold -3, decay 0.3), where the page counters must be equal too and
   0 < pages read < pages total; (3) gemma-7b (hd 256, geglu, soft-capped
   logits, tied embeddings), phi4-mini (hd 128, GQA 3) and granite (hd
   128, GQA 4) at narrowed widths, 2 layers, on the fp slab.
4. **lockstep** — smollm-135m at full width and depth, bf16, on the
   lockstep ``ServeEngine``: batch 8, a 1088-token prompt prefilled token
   by token, 32 new tokens. Checks finite logits every step, 30 K5
   launches per decode step, no plain call; prints the step times and
   tokens/s.
5. **serve-int8** — the serve phase's requests and weights on
   ``ContinuousEngine`` with ``kv_dtype="int8"``, threshold -3, decay 0.3.
   Checks as the serve phase, and the slab's resident bytes; prints the
   decode step median, tokens/s, prefill time, the page counters and how
   many tokens agree with the serve phase's (not gated: random weights).
6. **serve** — smollm-135m at full width (30 layers, d 576, 9/3 heads,
   vocab 49152), bf16, random weights from ``--seed``, on
   ``ContinuousEngine``: 8 requests with prompts over 600-2000 tokens and
   64 new tokens each. Checks every request's tokens, the prefill launch
   count, that the kernel launched once per layer per decode step and
   that the plain version never ran. Three decode-only steps, and then
   one prefill chunk of an extra request, run under ``torch.profiler``:
   device time by kernel name and the idle share.
7. **serve-ft** — kill and resume: the serve phase's weights and requests
   under ``ft.ServeSupervisor`` (a fresh engine every boot, a snapshot
   every 16 engine steps under ``build/``, removed at the end), with two
   injected crashes: one while requests still prefill (before the first
   snapshot, so a restart from scratch), one in decode (a restore).
   Checks the greedy tokens and every engine counter equal to the serve
   phase's, 2 restarts with at most 16 steps lost, every allocator back
   to n_pages - 1 free, the slabs and slot map on the card after each
   restore; prints the snapshot bytes, the median state_dict + save and
   restore times and the steps lost.
8. **serve-ft-int8** — the same on the serve-int8 phase's engine (int8
   slab, page skipping): the scales and the page-stats history go
   through the snapshots; tokens and counters (pages read) equal to the
   serve-int8 phase's.
9. **serve gemma-7b** — the serve phase's traffic on gemma-7b at full
   width and depth (28 layers, d 3072, 16 heads of hd 256, vocab 256000),
   bf16, random weights: the same checks (28 K4 launches a decode step),
   one decode-only step profiled.
10. **train-kernels** — hold the training kernels K1 (forward; with
   16-bit inputs on the tensor cores, in 16-row x 64-key warp sub-tiles),
   K2 (dQ) and K3 (dK/dV) against their plain versions on the plan tables
   and working-space tensors the op hands them: (a) the train phase's shapes
   (smollm-135m's pattern, 8 x 9 flat heads, n 4096, hd 64, block 256,
   bf16), (b) the same in f32, (c) ViL 2-D multi-band with a global token,
   block_q 128 != block_k 64, hd 128, f16, padded rows, (d) a causal
   dilated window with sinks (reordered; a transposed row splits), block
   32, f32, (e) case (a) in f16, (f) gemma-7b's attention (its pattern, 2
   x 16 heads, n 4096, hd 256, block 256, bf16), (g) case (f) in f32,
   (h) longformer-4k's (bidirectional window 512, one global token with
   global rows, 8 x 12 heads, hd 64, bf16), (i), (j) the paper's ViL
   stages 1 and 2 (56 x 56 and 28 x 28 grids, 15 x 15 window, one global
   token, 3 and 6 heads of hd 64, block 128, bf16). Tolerances: out 8e-3 in 16 bits and
   1e-5 in f32, m and l 1e-5 (``salo_attention.OUT_TOL``, ``STATS_TOL``);
   padded rows must give (0, NEG_INF, 0); dk/dv 1e-3 (bf16) and 1e-4
   (f16) in the 16-bit cases, where K2/K3 split every f32 operand into
   16-bit hi + lo on the tensor cores; 1e-4 in f32; dq 2e-2 in 16 bits
   (returned in the 16-bit type), and equal to the plain f32 dq rounded
   to that type on all but 2 % of its elements (``salo_backward.DKV_TOL``,
   ``DQ_OFF_SHARE``). The 16-bit cases run K2/K3 again with dout at 2^-20
   of its scale (a train step's) and compare relative to it. Checks that
   two K3 runs give bitwise-equal dK/dV. Prints for (a), (b), (f), (g),
   (h) each kernel's, and for (i), (j) K1's, the plain version's and the
   bound's time (16-bit K2/K3: each
   product once at the 16-bit tensor rate, 6 and 8 x hd flops per
   attended pair; f32: all but q.k^T at the f32 rate), the flops the
   kernel runs and their rate (K1: 4 x hd per pair of the sub-tiles it
   executes, 16 x 64 warp sub-tiles in 16 bits and 64 x 64 block
   sub-tiles in f32; K2/K3: the split's 10 and 16 x hd per attended
   pair; at hd 256 the 16-bit kernels' column split adds the products
   each of its two blocks recomputes), and
   ``scaled_dot_product_attention`` with the dense mask (forward, and its
   backward beside K2 and K3) as a yardstick.
11. **dynamic** — runtime plans: ``hybrid_attention(plan="dynamic")``
   fwd + bwd with a seeded cotangent at smollm-135m's attention (its
   pattern, 8 x 9 query heads on 3 KV heads, n 4096, hd 64, block 256,
   bf16) with keep 4 (61 of the static plan's 96 steps) and full keep
   (7), and at longformer-4k's (bidirectional window 512, one global token
   with global rows, 8 x 12 heads) with keep 4 (62 of 74). Each call must
   launch K1 once and K2 once on the step tables selected on the card, K3
   never, and no plain version. At full keep the device tables must equal
   the static plan's, out and dQ the static path's (bitwise printed), and
   the scatter dK/dV twin K3's on the packed tables within
   ``salo_backward.DKV_TOL``; at keep 4, K1 and K2 on the device tables
   must match their plain versions on the same tables (the train-kernels
   tolerances). Two calls of the scatter dK/dV must be bitwise equal.
   Prints, for smollm at keep 4, the selection's time, K1's and K2's
   (beside their plain versions, bounds and SDPA with the mask the
   selection implies), the scatter twin's against K3's, the op's fwd +
   bwd dynamic against static, the host's time to issue each of those
   calls, and the executed-tile ratio; one fwd + bwd runs under
   ``torch.cuda.set_sync_debug_mode("error")``: no host read on the
   call path.
12. **dynamic-check** — narrowed f32 cases (causal sinks, longformer with
   global rows, dilated sinks with hd 128), keep below ``max_steps``, on
   the card and on the CPU from the same tensors: equal tables; out and
   the three gradients within 1e-4. Then how many rows of smollm's bf16
   keep-4 tables differ between the card and the CPU (near-ties may flip;
   not gated).
13. **train-check** — a 2-layer, hd-64 f32 model trained 3 steps on the
   card (kernels) and on the CPU (plain versions) from the same
   parameters and batches: losses and grad norms agree within 1e-4; then
   the same for gemma-7b (hd 256) and longformer-4k (hd 64, bidirectional,
   global rows) at narrowed widths.
14. **train** — smollm-135m at full width and depth, bf16, remat full,
   random weights from ``--seed``, ``SyntheticLM`` at seq 4096, batch 8,
   20 steps, lr 3e-3, warmup 10. Checks finite losses, that the mean of
   the last 5 is below the first, K1 launches = 2 x 30 x steps, K2 = 30 x
   steps, K3 = 2 x 30 x steps (its row walk and its owner-tile sum), and
   that no plain version ran; prints the median step
   time, tokens/s and peak memory, then profiles one more step. After step
   10, {"params", "opt"} go to ``build/`` through an async
   ``ft.CheckpointManager`` (the device-to-host copy synchronous, the
   write in the background), a clone stays on the card; the steps that
   overlap the write are printed and left out of the median.
15. **train-ft** — the checkpoint restored into a freshly initialised
   state: every parameter, m and v bit-equal to the clone on the card, the
   step an int; steps 10 and 11 replayed from it give the train phase's
   losses and grad norms bit for bit. Prints the checkpoint bytes, the
   synchronous snapshot ms, the background write s and the restore ms.
16. **train-dots** — the train phase's first 5 steps (same seed,
    weights, batches and 20-step schedule) under ``remat="dots"``: losses
    equal to the train phase's within 1e-4 (bitwise printed), K1 = 2 x 30
    x steps (the attention forward replays under dots too), K2 = 30 x
    steps, K3 = 2 x 30 x steps. Prints ``train_bytes``' reckoning of what
    dots saves first, then the step time and peak memory beside the train
    phase's, and profiles one more step. Each train phase collects Python's
   cyclic garbage before it resets the peak-memory counter and prints
   what is allocated when it starts.
17. **train gemma-7b** — every published width of gemma-7b kept, the
    depth cut to the deepest whose reckoned step peak (``train_bytes``,
    printed first) fits 92 % of the card, seq 4096, batch 1, 10 steps,
    lr 1e-3, warmup 3; the same checks and lines as the train phase.
18. **train longformer-4k** — at full width and depth (12 layers, d
    768), seq 4096, batch 8, 20 steps, as the train phase: the
    bidirectional band and the global-rows epilogue on the card.

The last three lines of standard output are the ``kernels`` JSON line,
the card's name and power limit from ``nvidia-smi``, and the result line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the checkout, it exits nonzero and prints no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, data sheet
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
TOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-2}
REPEATS = 10                     # calls a decode case must repeat bitwise
# Decode-only steps [PROFILE_FROM, PROFILE_TO) run under torch.profiler.
# The profiler's hooks slow the host afterwards, so the serve timings are
# taken before PROFILE_FROM and the later steps only finish the run.
PROFILE_FROM, PROFILE_TO = 40, 43
TRAIN_STEPS, TRAIN_BATCH = 20, 8
GEMMA_STEPS, GEMMA_BATCH = 10, 1   # gemma-7b train: depth cut to fit the card
FT_TRAIN_AT = 10                   # train-ft: the step checkpointed


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


class Timer:
    """Mean device time of one call, with L2 flushed before each call (the
    serving decode reads a different layer's slab each launch, so it finds
    L2 cold). The timed calls queue up behind a sleep kernel, so the card
    runs them back to back and the events do not count the host's time to
    issue a call. Slow-to-issue calls (the plain versions, which launch
    many small kernels each) take fewer iterations and a longer sleep; a
    run whose calls outlast the sleep is repeated behind a longer one, and
    calls that read from the card themselves (so never queue) are timed on
    the host clock."""

    SLEEP_CYCLES = 200_000_000      # ~0.1 s: longer than issuing all calls

    def __init__(self, torch, iters: int = 20):
        self.torch = torch
        self.iters = iters
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 0, sleep_cycles: int = 0) -> float:
        torch = self.torch
        iters = iters or self.iters
        sleep = sleep_cycles or self.SLEEP_CYCLES
        for _ in range(3):
            fn()
        # calls slower to issue than the sleep lasts are timed again behind
        # a sleep four times as long
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda._sleep(sleep)
            slept = torch.cuda.Event()
            slept.record()
            pairs = []
            for _ in range(iters):
                self.flush.zero_()
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                fn()
                e.record()
                pairs.append((s, e))
            issued = not slept.query()
            torch.cuda.synchronize()
            if issued:
                return sum(s.elapsed_time(e) for s, e in pairs) / iters
            sleep *= 4
        # a call that waits on the card itself (a host read inside) cannot
        # queue behind a sleep: its time is the host's, synchronized
        log("[timer] the calls wait on the card (they never queue behind "
            "the sleep): timed on the host clock, synchronized")
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3


# --------------------------------------------------------------------- #
def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"[build] {len(secs)} kernel source(s) in "
        f"{time.perf_counter() - t0:.1f} s: {secs}")
    for name in secs:
        fn = ""
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                log(f"[build] {name}: {fn}: {line.strip()}")


def int8_slab(torch, gen, n_pages, page, Hkv, hd):
    """An int8 slab with per-page scales, written through the engine's
    quant_slab_write (two rounds per slot: scale growth and rescale)."""
    from repro_torch.serve.paged_cache import quant_slab_write

    k8 = torch.zeros((n_pages, page, Hkv, hd), dtype=torch.int8,
                     device="cuda")
    v8 = torch.zeros_like(k8)
    ks = torch.zeros(n_pages, device="cuda")
    vs = torch.zeros_like(ks)
    phys = torch.arange(1, n_pages, device="cuda",
                        dtype=torch.int32).repeat_interleave(page)
    off = torch.arange(page, device="cuda",
                       dtype=torch.int32).repeat(n_pages - 1)
    for gain in (0.5, 1.0):
        rows = torch.randn((2, phys.numel(), Hkv, hd), generator=gen,
                           device="cuda") * gain
        quant_slab_write(k8, v8, ks, vs, phys, off, rows[0], rows[1])
    return k8, v8, ks, vs


def decode_case(torch, gen, *, dtype, B, H, Hkv, hd, page, window, g, dil,
                ts, pad_rows=(), int8=False, **_):
    """Random slab/query/page tables/positions on the card for one
    kernel case; positions as the engine keeps them (every position <= t
    written in its ring slot). Returns (pattern, operands, scales) —
    scales (k_scale, v_scale) for an int8 slab, else (None, None)."""
    import numpy as np

    from repro_torch.core.patterns import causal_sliding_window
    from repro_torch.core.scheduler import PAD_SENTINEL, ring_view_positions
    from repro_torch.serve.paged_cache import layout_for_pattern

    pat = causal_sliding_window(window, n_sinks=g, dilation=dil)
    lay = layout_for_pattern(pat, page)
    npp = lay.pages_per_req
    n_pages = 1 + B * npp
    shape = (n_pages, page, Hkv, hd)
    if int8:
        k, v, ks, vs = int8_slab(torch, gen, n_pages, page, Hkv, hd)
    else:
        k = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        v = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        ks = vs = None
    q = torch.randn((B, H, 1, hd), generator=gen, device="cuda").to(dtype)
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    pt = perm[: B * npp].reshape(B, npp).to(torch.int32).contiguous()
    pos = np.stack([ring_view_positions(t + 1, lay.n_sink, lay.ring_cap, g)
                    for t in ts]).astype(np.int32)
    for r in pad_rows:
        pos[r] = PAD_SENTINEL
    pos_t = torch.from_numpy(pos).cuda()
    t = torch.tensor(ts, dtype=torch.int32, device="cuda")
    return pat, (q, k, v, pt, pos_t, t), (ks, vs)


def check_repeats(torch, fn, first, what):
    """REPEATS more calls of ``fn`` give outputs bitwise equal to
    ``first`` (a tuple of tensors)."""
    for _ in range(REPEATS):
        res = fn()
        res = res if isinstance(res, tuple) else (res,)
        check(all(torch.equal(a, b) for a, b in zip(res, first)),
              f"{what}: a repeated call is not bitwise equal")


def live_mask(torch, pat, pos, t):
    from repro_torch.core.scheduler import (STEP_GLOBAL, STEP_WINDOW,
                                            causal_step_mask)
    return causal_step_mask(pat, t[:, None], pos, STEP_WINDOW | STEP_GLOBAL)


def k4_cases(torch):
    """K4's kernel cases by name: decode_case keyword arguments."""
    serve = dict(B=8, H=9, Hkv=3, hd=64, page=16, window=1024, g=4, dil=1,
                 ts=[5, 300, 700, 1027, 1028, 1500, 2047, 3000])
    return [("a", dict(serve, dtype=torch.bfloat16)),
            ("b", dict(serve, dtype=torch.float32)),
            ("c", dict(B=4, H=2, Hkv=2, hd=128, page=8, window=64, g=4,
                       dil=2, ts=[10, 200, 77, 40], pad_rows=(3,),
                       dtype=torch.float16)),
            # the int8 serve phase's kernel: int8 slab, bf16 compute,
            # page statistics
            ("d", dict(serve, dtype=torch.bfloat16, int8=True,
                       stats=True)),
            # the sequence-parallel partial: f32 (out, m, l) and page
            # statistics, one all-PAD row
            ("e", dict(serve, dtype=torch.float32, state=True, stats=True,
                       pad_rows=(0,))),
            # one request with a long cache: few (request, head) pairs,
            # so the split carries the grid
            ("f", dict(serve, B=1, ts=[3000], dtype=torch.bfloat16)),
            # gemma-7b's decode: 16 heads of hd 256, no GQA
            ("g", dict(serve, H=16, Hkv=16, hd=256, dtype=torch.bfloat16))]


def phase_kernels(torch, timer, seed):
    """K4 against its plain version in every variant; returns the records
    of the cases by name."""
    import torch.nn.functional as F

    from repro_torch.kernels.salo_decode import (salo_paged_decode,
                                                 salo_paged_decode_plain,
                                                 split_plan)
    from repro_torch.serve.paged_cache import gather_view

    cases = k4_cases(torch)
    records = {}
    for i, (name, kw) in enumerate(cases):
        gen = torch.Generator(device="cuda").manual_seed(seed + i)
        pat, ops, (ks, vs) = decode_case(torch, gen, **kw)
        q, k, v, pt, pos, t = ops
        var = dict(pattern=pat, k_scale=ks, v_scale=vs,
                   return_state=kw.get("state", False),
                   return_page_stats=kw.get("stats", False))
        res = salo_paged_decode(*ops, **var)
        ref = salo_paged_decode_plain(*ops, **var)
        torch.cuda.synchronize()
        res = res if isinstance(res, tuple) else (res,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        check_repeats(torch, lambda: salo_paged_decode(*ops, **var), res,
                      f"K4 case {name}")
        mask = live_mask(torch, pat, pos, t)                   # (B, S)
        live_rows = mask.any(dim=1)
        check(bool(live_rows.any()), f"case {name}: no live row")
        check(len(kw.get("pad_rows", ())) == int((~live_rows).sum()),
              f"case {name}: live rows {live_rows.tolist()}")
        dname = str(kw["dtype"]).replace("torch.", "")
        tol = TOL[dname]
        n_row_out = 3 if var["return_state"] else 1
        names = ["out", "m", "l"][:n_row_out]
        errs = {}
        for what, a, b in zip(names, res, ref):
            o, r = a[live_rows].float(), b[live_rows].float()
            check(bool(torch.isfinite(o).all()),
                  f"case {name}: non-finite kernel {what}")
            errs[what] = float((o - r).abs().max())
            check(bool(torch.allclose(o, r, atol=tol, rtol=tol)),
                  f"case {name}: kernel {what} vs plain max abs err "
                  f"{errs[what]} > {tol}")
            if kw.get("pad_rows") and var["return_state"]:
                check(torch.equal(a[~live_rows], b[~live_rows]),
                      f"case {name}: an all-PAD row must give the "
                      f"(0, NEG_INF, 0) identity, {what}")
        if kw.get("pad_rows") and not var["return_state"]:
            check(bool((res[0][~live_rows] == 0).all()),
                  f"case {name}: an all-PAD row must give 0")
        if var["return_page_stats"]:
            pm, rpm = res[-1], ref[-1]
            dead = (pm <= -1e29) | (rpm <= -1e29)
            check(torch.equal(pm[dead], rpm[dead]),
                  f"case {name}: page_m differs where a side is NEG_INF")
            errs["page_m"] = float((pm[~dead] - rpm[~dead]).abs().max())
            check(bool(torch.allclose(pm[~dead], rpm[~dead], atol=tol,
                                      rtol=tol)),
                  f"case {name}: page_m max abs err {errs['page_m']}")
            check(bool(dead.any()) and bool((~dead).any()),
                  f"case {name}: page_m has no dead or no live page")

        # yardstick: SDPA on the pre-gathered (dequantized) view with a
        # precomputed mask
        kr, vr = gather_view(k, v, pt, *((ks, vs, q.dtype) if ks is not None
                                         else ()))
        kr = kr.transpose(1, 2).contiguous()
        vr = vr.transpose(1, 2).contiguous()
        amask = mask[:, None, None, :]

        def lib():
            return F.scaled_dot_product_attention(q, kr, vr, attn_mask=amask,
                                                  enable_gqa=True)

        kernel_ms = timer(lambda: salo_paged_decode(*ops, **var))
        plain_ms = timer(lambda: salo_paged_decode_plain(*ops, **var))
        library_ms = timer(lib)
        # bound: the bytes the function must move for THIS data (the
        # kernel reads only live slots' K/V rows, and the scales of the
        # pages that hold them) vs its operations
        B, H, _, hd = q.shape
        Hkv, page = k.shape[2], k.shape[1]
        n_split, split_len = split_plan(q.device, B, H, Hkv, pos.shape[1],
                                        page)
        live = int(mask.sum())                      # live (b, slot) pairs
        live_pages = int(mask.reshape(B, -1, page).any(-1).sum())
        item = q.element_size()
        out_item = 4 if var["return_state"] else item
        nbytes = (2 * live * Hkv * hd * k.element_size()   # K and V rows
                  + q.numel() * item + q.numel() * out_item
                  + (pt.numel() + pos.numel() + t.numel()) * 4)
        if ks is not None:
            nbytes += 2 * live_pages * 4                   # their scales
        if var["return_state"]:
            nbytes += 2 * B * H * 4                        # m, l
        if var["return_page_stats"]:
            nbytes += pt.numel() * 4                       # page_m
        ops_ = 4 * live * H * hd                    # QK^T and PV
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops_ / PEAK_OPS[dname] * 1e3
        rec = dict(kernel_ms=kernel_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   max_abs_err=max(errs.values()), errs=errs, bytes=nbytes,
                   live_slots=live, n_split=n_split, split_len=split_len)
        log(f"[kernels] K4 case {name} {dname} "
            f"{'int8 slab ' if ks is not None else ''}"
            f"state={var['return_state']} "
            f"stats={var['return_page_stats']} B={B} H={H} Hkv={Hkv} "
            f"hd={hd} page={page} npp={pt.shape[1]}: "
            + " ".join(f"{a}={b}" for a, b in rec.items()))
        records[name] = rec
    return records


LOCKSTEP_B, LOCKSTEP_PROMPT, LOCKSTEP_NEW = 8, 1088, 32


def k5_cases(torch):
    """K5's kernel cases by name: (a) the lockstep phase's cache (bf16,
    full cache, slot = position), (b) the same in f32, (c) the ring layout
    (window + sinks slots, PAD for unwritten ring slots) with dilation 2."""
    S = LOCKSTEP_PROMPT + LOCKSTEP_NEW
    full = dict(window=1024, g=4, dil=1, S=S, t=S - 1, ring=False)
    return [("a", dict(full, dtype=torch.bfloat16)),
            ("b", dict(full, dtype=torch.float32)),
            ("c", dict(window=512, g=4, dil=2, S=512 + 4, t=3000,
                       ring=True, dtype=torch.bfloat16))]


def k5_case(torch, gen, c):
    """Random operands of one K5 case on the card, the caches read through
    the transposed view of a (B, S, Hkv, hd) cache. Returns (pattern, q,
    k, v, positions or None, t)."""
    import numpy as np

    from repro_torch.core.patterns import causal_sliding_window
    from repro_torch.core.scheduler import PAD_SENTINEL

    B, H, Hkv, hd = LOCKSTEP_B, 9, 3, 64
    pat = causal_sliding_window(c["window"], n_sinks=c["g"],
                                dilation=c["dil"])
    S, t, dt = c["S"], c["t"], c["dtype"]
    cache = torch.randn((2, B, S, Hkv, hd), generator=gen,
                        device="cuda").to(dt)
    k, v = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    q = torch.randn((B, H, 1, hd), generator=gen, device="cuda").to(dt)
    positions = None
    if c["ring"]:
        w, g = c["window"], c["g"]
        j = np.arange(S)
        pos = np.where(j < g, j, t - np.mod(t - j, w))
        pos = np.where((j >= g) & (pos < g), PAD_SENTINEL, pos)
        positions = torch.from_numpy(pos.astype(np.int32)).cuda()
    return pat, q, k, v, positions, t


def phase_k5(torch, timer, seed):
    """K5 against its plain version in the cases of ``k5_cases``. Returns
    the records by case."""
    import torch.nn.functional as F

    from repro_torch.kernels.salo_decode import (salo_decode,
                                                 salo_decode_plain,
                                                 split_plan)

    records = {}
    for i, (name, c) in enumerate(k5_cases(torch)):
        gen = torch.Generator(device="cuda").manual_seed(seed + 50 + i)
        pat, q, k, v, positions, t = k5_case(torch, gen, c)
        B, H, _, hd = q.shape
        Hkv, S_, dt = k.shape[1], c["S"], c["dtype"]
        out = salo_decode(q, k, v, positions, t, pattern=pat)
        ref = salo_decode_plain(q, k, v, positions, t, pattern=pat)
        torch.cuda.synchronize()
        check_repeats(torch, lambda: salo_decode(q, k, v, positions, t,
                                                 pattern=pat), (out,),
                      f"K5 case {name}")
        n_split, split_len = split_plan(q.device, B, H, Hkv, S_)
        dname = str(dt).replace("torch.", "")
        tol = TOL[dname]
        check(bool(torch.isfinite(out).all()), f"K5 case {name}: non-finite")
        err = float((out.float() - ref.float()).abs().max())
        check(bool(torch.allclose(out.float(), ref.float(), atol=tol,
                                  rtol=tol)),
              f"K5 case {name}: kernel vs plain max abs err {err} > {tol}")
        pos_k = (torch.arange(S_, dtype=torch.int32, device="cuda")
                 if positions is None else positions)
        mask = live_mask(torch, pat, pos_k[None].expand(B, S_),
                         torch.full((B,), t, dtype=torch.int32,
                                    device="cuda"))
        amask = mask[:, None, None, :]

        def lib():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=amask,
                                                  enable_gqa=True)

        kernel_ms = timer(lambda: salo_decode(q, k, v, positions, t,
                                              pattern=pat))
        # few iterations: a plain call on the strided cache copies it and
        # takes long to issue, and the queue must stay behind the sleep
        plain_ms = timer(lambda: salo_decode_plain(q, k, v, positions, t,
                                                   pattern=pat),
                         iters=2, sleep_cycles=4_000_000_000)
        library_ms = timer(lib)
        live = int(mask.sum())
        item = q.element_size()
        nbytes = (2 * live * Hkv * hd * item + 2 * q.numel() * item
                  + (0 if positions is None else positions.numel() * 4))
        ops_ = 4 * live * H * hd
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops_ / PEAK_OPS[dname] * 1e3
        rec = dict(kernel_ms=kernel_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   max_abs_err=err, bytes=nbytes, live_slots=live,
                   n_split=n_split, split_len=split_len)
        log(f"[kernels] K5 case {name} {dname} {pat} B={B} H={H} Hkv={Hkv} "
            f"hd={hd} S={S_} t={t} ring={c['ring']}: "
            + " ".join(f"{a}={b}" for a, b in rec.items()))
        records[name] = rec
    return records


def _serve_check_cfg(window):
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import SALOConfig

    return dataclasses.replace(get_smoke("smollm-135m"), d_model=192,
                               n_heads=3, n_kv_heads=1, d_ff=256,
                               salo=SALOConfig(window=window, n_global=2))


def _narrow(arch, **fields):
    """The f32 smoke config of ``arch`` (2 layers, vocab 256, a 16-slot
    window, 32-wide plan blocks) with ``fields`` replaced."""
    import dataclasses

    from repro_torch.configs import get_smoke

    return dataclasses.replace(get_smoke(arch), **fields)


# Narrowed configs of the dense archs for the cuda == cpu checks: widths cut
# so the checks are quick, head dims the kernels take, each arch's own
# features kept (gemma: geglu, logit softcap, tied embeddings, hd 256;
# phi4-mini: GQA 3 at hd 128; granite: GQA 4 at hd 128; longformer:
# bidirectional window, a global token with global rows, gelu, hd 64).
def _check_cfgs():
    return {
        "gemma-7b": _narrow("gemma-7b", d_model=256, n_heads=2,
                            n_kv_heads=2, head_dim=256, d_ff=512),
        "phi4-mini-3.8b": _narrow("phi4-mini-3.8b", d_model=384, n_heads=3,
                                  n_kv_heads=1, d_ff=512),
        "granite-3-8b": _narrow("granite-3-8b", d_model=512, n_heads=4,
                                n_kv_heads=1, d_ff=512),
        "longformer-4k": _narrow("longformer-4k", d_model=128, n_heads=2,
                                 n_kv_heads=2, d_ff=256),
    }


def serve_check(torch, seed):
    """Kernel path (cuda) and plain path (cpu) give the same greedy tokens
    on a small f32 model with hd 64: (1) the fp slab, window 16; (2) the
    int8 slab with page skipping on the workload of the reference's
    ``test_page_skip_engages_at_parity`` (window 64, prompts 24/17/9/30,
    24 new tokens, threshold -3, decay 0.3), where the page counters must
    be equal too and pages really skipped (0 < read < total); then (3)
    gemma-7b (hd 256), phi4-mini and granite (hd 128, GQA 3 and 4) at
    narrowed widths (``_check_cfgs``) on the fp slab."""
    import numpy as np

    from repro_torch.models.layers import salo_pattern
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ContinuousConfig, ContinuousEngine
    from repro_torch.serve.paged_cache import layout_for_pattern

    runs = [("fp", _serve_check_cfg(16), (5, 9, 13, 26), 8, {}),
            ("int8 page-sparse", _serve_check_cfg(64), (24, 17, 9, 30), 24,
             dict(kv_dtype="int8", page_sparsity_threshold=-3.0,
                  page_stat_decay=0.3))]
    # the causal dense archs at narrowed widths, fp slab
    runs += [(f"{arch} hd {cfg.hd} H {cfg.n_heads}/{cfg.n_kv_heads}", cfg,
              (5, 9, 13, 26), 8, {})
             for arch, cfg in _check_cfgs().items() if arch in SERVE_CHECK]
    for what, cfg, lens, n_new, extra in runs:
        lay = layout_for_pattern(salo_pattern(cfg), 8)
        ccfg = ContinuousConfig(n_pages=1 + 4 * lay.pages_per_req, page=8,
                                chunk=8, max_batch=4, **extra)
        cpu_model = build_model(cfg, "cpu")
        params = cpu_model.init(torch.Generator().manual_seed(seed))
        for layer in params["seg0_attn_mlp"]:   # tokens that use attention
            layer["attn"]["wo"] *= 6.0
            layer["mlp"]["w_out"] *= 6.0
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in lens]
        outs, counters = {}, {}
        for dev in ("cuda", "cpu"):
            model = build_model(cfg, dev)
            p = params if dev == "cpu" else _to(params, dev)
            eng = ContinuousEngine(model, ccfg, device=dev)
            rids = [eng.submit(x, n_new) for x in prompts]
            res = eng.run(p)
            outs[dev] = [res[r].tolist() for r in rids]
            counters[dev] = dict(eng.counters)
        check(outs["cuda"] == outs["cpu"],
              f"serve-check {what}: cuda {outs['cuda']} != cpu "
              f"{outs['cpu']}")
        check(counters["cuda"] == counters["cpu"],
              f"serve-check {what}: counters cuda {counters['cuda']} != "
              f"cpu {counters['cpu']}")
        c = counters["cuda"]
        if extra:
            check(0 < c["decode_pages_read"] < c["decode_pages_total"],
                  f"serve-check {what}: no page skipped: {c}")
        log(f"[serve-check] {what}: cuda == cpu greedy tokens and counters "
            f"(decode pages read {c['decode_pages_read']} of "
            f"{c['decode_pages_total']}): {outs['cuda']}")


def _to(tree, dev):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(dev), tree)


SERVE_PAGE, SERVE_CHUNK, SERVE_R, SERVE_NEW = 16, 128, 8, 64
SERVE_CHECK = ("gemma-7b", "phi4-mini-3.8b", "granite-3-8b")
TRAIN_CHECK = ("gemma-7b", "longformer-4k")


def _serve_weights(torch, seed, arch="smollm-135m"):
    """``arch`` at full width and depth on the card, bf16 weights from
    ``seed``. Returns (cfg, model, params)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = get_config(arch)
    model = build_model(cfg, "cuda")
    return cfg, model, model.init(
        torch.Generator(device="cuda").manual_seed(seed))


def _serve_lens(seed):
    """The serve phases' prompt lengths (600-2000) and the generator that
    then draws their tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = [int(x) for x in np.linspace(600, 2000, SERVE_R).round()
            + rng.integers(0, 40, SERVE_R)]
    return [min(n, 2000) for n in lens], rng


def _serve_engine(torch, seed, what, arch="smollm-135m", weights=None,
                  **extra):
    """``arch`` (smollm-135m by default) at full width and depth, bf16,
    random weights from ``seed`` (or ``weights``, ``_serve_weights``'s),
    on the continuous engine with the serve phases' 8 requests submitted
    (prompts over 600-2000 tokens): n_pages from ``layout_for_pattern``, 8
    rows. ``extra``: ContinuousConfig fields. Returns (cfg, engine,
    params, prompt lengths, rng)."""
    from repro_torch.models.layers import salo_pattern
    from repro_torch.obs import Observability
    from repro_torch.serve.engine import ContinuousConfig, ContinuousEngine
    from repro_torch.serve.paged_cache import layout_for_pattern
    from repro_torch.tree import tree_leaves

    cfg, model, params = weights or _serve_weights(torch, seed, arch)
    R = SERVE_R
    lay = layout_for_pattern(salo_pattern(cfg), SERVE_PAGE)
    check(lay.pages_per_req == 65, f"pages_per_req {lay.pages_per_req}")
    ccfg = ContinuousConfig(n_pages=1 + R * lay.pages_per_req,
                            page=SERVE_PAGE, chunk=SERVE_CHUNK, max_batch=R,
                            **extra)
    eng = ContinuousEngine(model, ccfg, device="cuda", obs=Observability())
    n_param = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log(f"[{what}] {arch} bf16 {extra}: weights {n_param / 1e6:.1f} MB,"
        f" slab {eng.slab_resident_bytes()} bytes resident "
        f"({eng.slab_resident_bytes() / 1e6:.1f} MB), "
        f"n_pages={ccfg.n_pages}")
    lens, rng = _serve_lens(seed)
    for n in lens:
        eng.submit(rng.integers(0, cfg.vocab_size, (n,)), SERVE_NEW)

    decode_fn = eng._decode_fn

    def checked_decode(*a, **k):              # finite logits every step
        logits, page_m = decode_fn(*a, **k)
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        return logits, page_m

    eng._decode_fn = checked_decode
    return cfg, eng, params, lens, rng


def _check_serve_run(cfg, eng, lens, launches, plain, what):
    """Every request finished with its tokens, the prefill launch count,
    one K4 launch per layer per decode step, no plain call."""
    res = eng.batcher.results()
    c = dict(eng.counters)
    log(f"[{what}] prompts={lens} new={SERVE_NEW} counters={c}")
    check(len(res) == SERVE_R, f"{len(res)} of {SERVE_R} requests finished")
    for rid, toks in res.items():
        check(len(toks) == SERVE_NEW, f"request {rid}: {len(toks)} tokens")
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              f"request {rid}: token outside the vocabulary")
    want = sum(math.ceil(n / SERVE_CHUNK) for n in lens)
    check(c["prefill_launches"] == want,
          f"prefill launches {c['prefill_launches']} != {want}")
    check(launches == c["decode_launches"] * cfg.n_layers,
          f"K4 launches {launches} != {c['decode_launches']} x "
          f"{cfg.n_layers}")
    check(launches > 0, "K4 never launched")
    check(plain == 0, f"the plain version ran {plain} times")
    return res, c


def phase_serve(torch, seed, arch="smollm-135m", what="serve",
                profile=(PROFILE_FROM, PROFILE_TO), profile_prefill=True):
    """``arch`` at full width on the continuous engine; the decode-only
    steps [profile[0], profile[1]) run under the profiler, and then (when
    ``profile_prefill``) one prefill chunk. Returns the K4 launch count of
    the run, the requests' tokens and the engine counters."""
    from repro_torch.kernels.salo_decode import (salo_paged_decode,
                                                 salo_paged_decode_plain)

    cfg, eng, params, lens, rng = _serve_engine(torch, seed, what, arch)
    prof_from, prof_to = profile
    R = SERVE_R
    salo_paged_decode.launches = 0
    salo_paged_decode_plain.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill_done = None
    decode_steps = []           # (seconds, cohort) before the profiler
    n_dec = 0                   # decode-only steps so far
    prof, prof_wall, timed = None, 0.0, None
    while True:
        pre, dec = eng.batcher.assemble()
        decode_only = not pre and bool(dec)
        profiled = decode_only and prof_from <= n_dec < prof_to
        if profiled and prof is None:
            timed = (time.perf_counter() - t0, _emitted(eng))
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        ts = time.perf_counter()
        more = eng.step(params)
        torch.cuda.synchronize()
        dt = time.perf_counter() - ts
        n_dec += decode_only
        if profiled:
            prof_wall += dt
            if n_dec == prof_to:
                prof.stop()
        elif decode_only and prof is None:
            decode_steps.append((dt, len(dec)))
        if prefill_done is None and not any(
                r is not None and r.state in ("waiting", "prefill")
                for r in eng.batcher.rows) and not eng.batcher.queue \
                and eng.counters["prefill_launches"]:
            prefill_done = time.perf_counter() - t0
        if not more:
            break
    check(timed is not None, "the run ended before the profiled steps")
    launches = salo_paged_decode.launches
    plain = salo_paged_decode_plain.calls
    res, counters = _check_serve_run(cfg, eng, lens, launches, plain, what)
    check(len(decode_steps) > 0, "no decode-only step")
    med = sorted(d for d, _ in decode_steps)[len(decode_steps) // 2]
    dec_tps = sum(n for _, n in decode_steps) / sum(d for d, _ in decode_steps)
    log(f"[{what}] prefill {prefill_done:.3f} s (all {R} prompts, "
        f"{sum(lens)} tokens); decode step median {med * 1e3:.3f} ms over "
        f"{len(decode_steps)} decode-only steps ({dec_tps:.1f} tok/s in "
        f"them); {timed[1]} tokens generated in the first {timed[0]:.3f} s "
        f"({timed[1] / timed[0]:.1f} tok/s); K4 launches {launches}")
    check(prof is not None, "no decode-only step was profiled")
    report_profile(prof, prof_wall, prof_to - prof_from, "decode steps")
    if not profile_prefill:
        return launches, res, counters

    # After the counts are read: one more request, whose first engine step
    # (one 128-token prefill chunk through all layers) runs under the
    # profiler.
    eng.submit(rng.integers(0, cfg.vocab_size, (2000,)), 1)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    ts = time.perf_counter()
    eng.step(params)
    torch.cuda.synchronize()
    dt = time.perf_counter() - ts
    prof.stop()
    report_profile(prof, dt, 1, "prefill chunk")
    return launches, res, counters


def phase_serve_int8(torch, seed):
    """The serve phase's requests and weights on the int8 slab with page
    skipping (threshold -3, decay 0.3). Checks the run like the serve
    phase and the slab's resident bytes; reports the step time and the
    page counters (random weights need not skip pages at full width, so
    that is not gated). Returns the K4 launch count, the tokens and the
    engine counters."""
    from repro_torch.kernels.salo_decode import (salo_paged_decode,
                                                 salo_paged_decode_plain)
    from repro_torch.serve.paged_cache import slab_bytes

    cfg, eng, params, lens, _ = _serve_engine(
        torch, seed, "serve-int8", kv_dtype="int8",
        page_sparsity_threshold=-3.0, page_stat_decay=0.3)
    n_layers = sum(n for _, n in eng.model.program)
    want_bytes = slab_bytes(n_layers, eng.ccfg.n_pages, SERVE_PAGE,
                            cfg.n_kv_heads, cfg.hd, 1, with_scales=True)
    fp_bytes = slab_bytes(n_layers, eng.ccfg.n_pages, SERVE_PAGE,
                          cfg.n_kv_heads, cfg.hd, 2)
    check(eng.slab_resident_bytes() == want_bytes,
          f"int8 slab {eng.slab_resident_bytes()} bytes != {want_bytes}")
    salo_paged_decode.launches = 0
    salo_paged_decode_plain.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill_done, decode_steps = None, []
    while True:
        pre, dec = eng.batcher.assemble()
        ts = time.perf_counter()
        more = eng.step(params)
        torch.cuda.synchronize()
        if not pre and dec:
            decode_steps.append((time.perf_counter() - ts, len(dec)))
        if prefill_done is None and not any(
                r is not None and r.state in ("waiting", "prefill")
                for r in eng.batcher.rows) and not eng.batcher.queue \
                and eng.counters["prefill_launches"]:
            prefill_done = time.perf_counter() - t0
        if not more:
            break
    wall = time.perf_counter() - t0
    launches = salo_paged_decode.launches
    plain = salo_paged_decode_plain.calls
    res, c = _check_serve_run(cfg, eng, lens, launches, plain, "serve-int8")
    check(len(decode_steps) > 0, "no decode-only step")
    med = sorted(d for d, _ in decode_steps)[len(decode_steps) // 2]
    log(f"[serve-int8] slab {eng.slab_resident_bytes()} bytes resident "
        f"(bf16 slab {fp_bytes}, ratio {fp_bytes / eng.slab_resident_bytes():.3f});"
        f" prefill {prefill_done:.3f} s; decode step median {med * 1e3:.3f} "
        f"ms over {len(decode_steps)} decode-only steps; "
        f"{SERVE_R * SERVE_NEW / wall:.1f} generated tokens/s over the "
        f"phase's {wall:.3f} s; decode pages read "
        f"{c['decode_pages_read']} of {c['decode_pages_total']}, prefill "
        f"{c['prefill_pages_read']} of {c['prefill_pages_total']}; K4 "
        f"launches {launches}")
    return launches, res, c


FT_EVERY = 16                     # serve-ft: engine steps between snapshots


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def phase_serve_ft(torch, seed, what, ref_res, ref_c, **extra):
    """The serve phase's weights and requests (``extra``: the int8 phase's
    engine fields) under ``ServeSupervisor``: a fresh engine every boot,
    a snapshot every ``FT_EVERY`` steps into ``build/``, and a
    ``FaultInjector`` crashing two attempts, one while requests still
    prefill (engine step half of the longest prompt's chunks) and one in
    decode (from the uninterrupted run's step count, ``ref_c``). Checks
    the greedy tokens and every engine counter against the uninterrupted
    phase's (``ref_res``, ``ref_c``), 2 restarts with at most
    ``FT_EVERY`` steps lost, every allocator back to n_pages - 1 free, the
    slabs and slot map on the card after each restore, K4 launched and no
    plain call. Prints the snapshot bytes, the median state_dict + save
    and restore times, and the steps lost. Returns the K4 launch count."""
    import shutil

    from repro_torch.ft import FaultInjector, FaultPlan, ServeSupervisor
    from repro_torch.kernels.salo_decode import (salo_paged_decode,
                                                 salo_paged_decode_plain)

    weights = _serve_weights(torch, seed)
    n_steps = ref_c["engine_steps"]
    marks = {"t": 0.0, "boots": 0}
    snap_ms, restore_ms = [], []

    def make_engine():
        eng = _serve_engine(torch, seed, what, weights=weights, **extra)[1]
        marks["boots"] += 1
        state_dict, load = eng.state_dict, eng.load_state

        def timed_state_dict():
            marks["t"] = time.perf_counter()
            return state_dict()

        def checked_load(tree):     # after state_dict (the like) and read
            load(tree)
            torch.cuda.synchronize()
            restore_ms.append((time.perf_counter() - marks["t"]) * 1e3)
            check(all(a.is_cuda for s_ in eng.slabs.values()
                      for a in s_.tensors()) and eng.slot_pos.is_cuda,
                  f"[{what}] a restored tensor left the card")

        eng.state_dict, eng.load_state = timed_state_dict, checked_load
        return eng

    # crash attempts: engine step p (prefill: no snapshot yet, so a
    # restart from scratch), then engine step d in decode, FT_EVERY
    # stepping not landing on a snapshot (attempt p + 1 + d)
    n_prefill = max(math.ceil(n / SERVE_CHUNK) for n in _serve_lens(seed)[0])
    p = n_prefill // 2
    d = FT_EVERY * ((n_prefill + n_steps) // (2 * FT_EVERY)) + 9
    check(0 < p < n_prefill < d < n_steps - 1,
          f"[{what}] no crash plan: prefill {n_prefill}, steps {n_steps}")
    ckdir = ROOT / "build" / f"ft_{what}"
    shutil.rmtree(ckdir, ignore_errors=True)
    sup = ServeSupervisor(
        make_engine, weights[2], str(ckdir), checkpoint_every=FT_EVERY,
        keep=2, injector=FaultInjector(FaultPlan(
            crash_steps=frozenset({p, p + 1 + d}))))
    save = sup.manager.save

    def timed_save(tree, step):
        save(tree, step)
        snap_ms.append((time.perf_counter() - marks["t"]) * 1e3)
        marks["bytes"] = _dir_bytes(ckdir / f"step_{step:08d}")

    sup.manager.save = timed_save
    try:
        salo_paged_decode.launches = 0
        salo_paged_decode_plain.calls = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng, hist = sup.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = salo_paged_decode.launches
        plain = salo_paged_decode_plain.calls
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    res = eng.batcher.results()
    c = dict(eng.counters)
    check(sorted(res) == sorted(ref_res), f"[{what}] requests {sorted(res)}")
    for rid, toks in ref_res.items():
        check(len(res[rid]) == len(toks) and bool((res[rid] == toks).all()),
              f"[{what}] request {rid}: tokens differ from the "
              f"uninterrupted run")
    check(c == ref_c, f"[{what}] counters {c} != uninterrupted {ref_c}")
    check(hist["restarts"] == 2 and hist["max_step_loss"] <= FT_EVERY,
          f"[{what}] history {hist}")
    check(len(restore_ms) >= 1, f"[{what}] no restore ran")
    check(all(a.n_free == eng.ccfg.n_pages - 1
              for a in eng.batcher.allocs), f"[{what}] pages leaked")
    n_layers = sum(n for _, n in eng.model.program)
    check(launches >= ref_c["decode_launches"] * n_layers and plain == 0,
          f"[{what}] K4 launches {launches}, plain {plain}")
    med = sorted(snap_ms)[len(snap_ms) // 2]
    rmed = sorted(restore_ms)[len(restore_ms) // 2]
    log(f"[{what}] crashes at attempts {p} (prefill, engine step {p}) and "
        f"{p + 1 + d} (decode, engine step {d}); {marks['boots']} boots, "
        f"{len(restore_ms)} restore(s), steps lost {hist['steps_lost']} (max "
        f"{hist['max_step_loss']}), {hist['steps_run']} steps run for "
        f"{n_steps}; tokens and counters equal to the uninterrupted run's")
    log(f"[{what}] snapshot {marks['bytes']} bytes on disk; state_dict + "
        f"save median {med:.3f} ms over {len(snap_ms)} snapshots "
        f"({[round(x, 3) for x in snap_ms]}); restore median {rmed:.3f} ms "
        f"over {len(restore_ms)} ({[round(x, 3) for x in restore_ms]}); "
        f"phase {wall:.3f} s; K4 launches {launches}")
    return launches


def phase_lockstep(torch, seed):
    """smollm-135m at full width and depth, bf16, on the lockstep
    ServeEngine: batch 8, a 1088-token prompt (past the 1024 window, so the
    window and the sinks both bite) prefilled token by token, 32 new
    tokens. Checks finite logits every step, 30 K5 launches per decode
    step and no plain call. Returns the K5 launch count."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.salo_decode import salo_decode, salo_decode_plain
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = get_config("smollm-135m")
    B, P, n_new = LOCKSTEP_B, LOCKSTEP_PROMPT, LOCKSTEP_NEW
    check(P > cfg.salo.window, f"prompt {P} within the window")
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    eng = ServeEngine(model, ServeConfig(max_len=P + n_new))
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                   (B, P))
    decode_step = model.decode_step
    times = []

    def timed_step(*a, **k):                  # finite logits every step
        ts = time.perf_counter()
        logits, cache = decode_step(*a, **k)
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        times.append(time.perf_counter() - ts)
        return logits, cache

    model.decode_step = timed_step
    salo_decode.launches = 0
    salo_decode_plain.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = eng.generate(params, prompts, n_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = salo_decode.launches, salo_decode_plain.calls
    steps = len(times)
    check(steps == P + n_new, f"{steps} decode steps, want {P + n_new}")
    check(launches == steps * cfg.n_layers,
          f"K5 launches {launches} != {steps} x {cfg.n_layers}")
    check(plain == 0, f"the plain version ran {plain} times")
    check(tuple(toks.shape) == (B, n_new), f"tokens {tuple(toks.shape)}")
    med = sorted(times)[steps // 2]
    gen_med = sorted(times[P:])[n_new // 2]
    gen_s = sum(times[P:])
    log(f"[lockstep] smollm-135m bf16 B={B} prompt={P} new={n_new}: "
        f"{steps} decode steps in {wall:.3f} s; step median {med * 1e3:.3f} "
        f"ms (prefill and generation), generation step median "
        f"{gen_med * 1e3:.3f} ms, {B * n_new / gen_s:.1f} generated "
        f"tokens/s in the generation steps, {B * (P + n_new) / wall:.1f} "
        f"tokens/s through the whole run; K5 launches {launches}; first "
        f"tokens {toks[:2, :8].tolist()}")
    return launches


# ----------------------------- training ------------------------------ #
# Kernel cases of the training kernels (K1 forward, K2 dQ, K3 dK/dV), each
# on the working-space tensors and plan tables the op hands them:
# (a) the train phase's attention: smollm-135m's pattern, B*H = 8 x 9 flat
#     heads, n 4096, hd 64, block 256, bf16; (b) the same in f32; (c) ViL
#     2-D multi-band with a global token, block_q != block_k, hd 128, f16,
#     padded rows; (d) causal dilated window with sinks (reordered; the
#     global tile's transposed row splits in pack_rows), block 32, f32;
#     (e) case (a) in f16, where small ds meet f16's subnormal range;
# (f) gemma-7b's attention: its pattern, batch 2 x 16 heads, n 4096, hd 256,
#     block 256, bf16 (the column split over blocks); (g) the same in f32
#     (the staged hd chunks on the CUDA cores); (h) longformer-4k's:
#     bidirectional window 512, one global token with global rows, batch
#     8 x 12 heads, hd 64, bf16; (i), (j) the paper's ViL stages 1 and 2
#     (grids 56 x 56 and 28 x 28, window 15 x 15, one global token, 3 and 6
#     heads of hd 64), bf16.
TRAIN_CASES = {
    "a": dict(pat=("csw", 1024, 4, 1), n=4096, bh=72, hd=64, bq=256, bk=256,
              dtype="bfloat16"),
    "b": dict(pat=("csw", 1024, 4, 1), n=4096, bh=72, hd=64, bq=256, bk=256,
              dtype="float32"),
    "c": dict(pat=("vil", (32, 32), (7, 7), 1), n=1025, bh=4, hd=128,
              bq=128, bk=64, dtype="float16"),
    "d": dict(pat=("csw", 64, 4, 2), n=2048, bh=4, hd=64, bq=32, bk=32,
              dtype="float32"),
    "e": dict(pat=("csw", 1024, 4, 1), n=4096, bh=72, hd=64, bq=256, bk=256,
              dtype="float16"),
    "f": dict(pat=("csw", 1024, 4, 1), n=4096, bh=32, hd=256, bq=256,
              bk=256, dtype="bfloat16"),
    "g": dict(pat=("csw", 1024, 4, 1), n=4096, bh=32, hd=256, bq=256,
              bk=256, dtype="float32"),
    "h": dict(pat=("lf", 512, 1), n=4096, bh=96, hd=64, bq=256, bk=256,
              dtype="bfloat16"),
    "i": dict(pat=("vil", (56, 56), (15, 15), 1), n=3137, bh=3, hd=64,
              bq=128, bk=128, dtype="bfloat16"),
    "j": dict(pat=("vil", (28, 28), (15, 15), 1), n=785, bh=6, hd=64,
              bq=128, bk=128, dtype="bfloat16"),
}
K1, K2, K3 = ("salo_table_attention", "salo_table_backward_dq",
              "salo_table_backward_dkv")
# the cases whose kernels are timed (the ViL stages: K1 only)
TIMED = {"a": (K1, K2, K3), "b": (K1, K2, K3), "f": (K1, K2, K3),
         "g": (K1, K2, K3), "h": (K1, K2, K3), "i": (K1,), "j": (K1,)}
# Tolerances (abs and rel). The forward's out and row stats within
# salo_attention.OUT_TOL and STATS_TOL (f32 1e-5; 16-bit out 8e-3, two bf16
# ulps at |out| near 0.5, as the kernel rounds p relative to a 64-key
# sub-tile's running max; m, l 1e-5 in every case). Kernel and plain
# version use the same f32 arithmetic in another order: f32 gradients 1e-4
# (three products deep). 16-bit dq 2e-2: it is returned in the 16-bit type;
# beyond that it must equal the plain f32 dq rounded to its type on all but
# salo_backward.DQ_OFF_SHARE of its elements. dk/dv (f32 outputs) within
# salo_backward.DKV_TOL (16-bit: 1e-3 bf16, 1e-4 f16): the backward kernels
# split every f32 operand into 16-bit hi + lo on the tensor cores, which
# keeps them within ~1e-5 of f32 arithmetic, where one 16-bit rounding of
# dout, p and ds would miss both (tests/test_torch_backward_numerics.py).
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-2}
# a train step's dout relative to unit scale (the gradient of a mean over
# ~3e4 tokens): below f16's normal range
SMALL_DOUT = 2.0 ** -20


def _case_pattern(spec):
    from repro_torch.core import patterns as P
    if spec[0] == "csw":
        _, w, g, dil = spec
        return P.causal_sliding_window(w, n_sinks=g, dilation=dil)
    if spec[0] == "lf":
        _, w, g = spec
        return P.longformer(w, n_global=g)
    _, grid, win, g = spec
    return P.vil(grid, win, n_global=g)


def _attended_pairs(torch, sched, pos_q, pos_k, kvb, flags) -> int:
    """Pairs the step tables' masks admit: the work these inputs need."""
    total = 0
    for s in range(kvb.shape[1]):
        pk = pos_k.index_select(0, kvb[:, s])
        fl = flags[:, s]
        total += int(sched.step_mask(pos_q[:, :, None], pk[:, None, :],
                                     fl[:, None, None]).sum())
    return total


def _executed_pairs(sched, pos_q, pos_k, kvb, flags, rows: int) -> int:
    """Pairs of the (rows x 64-key) sub-tiles of the step tables in which
    any pair survives: what K1 executes for one head (a 32-key tile is one
    sub-tile of 32 keys)."""
    nq, bq = pos_q.shape
    bk = pos_k.shape[1]
    ks = min(64, bk)
    total = 0
    for s in range(kvb.shape[1]):
        pk = pos_k.index_select(0, kvb[:, s])
        live = sched.step_mask(pos_q[:, :, None], pk[:, None, :],
                               flags[:, s, None, None])
        live = live.reshape(nq, bq // rows, rows, bk // ks, ks)
        total += int(live.any(dim=4).any(dim=2).sum()) * rows * ks
    return total


def _k12_io(BH, n_pad, D, item, tables, pairs, dtype):
    """(bytes moved, [(operations, peak for their type)]) of K1 and K2 on
    step tables whose masks admit ``pairs`` pairs: each input read once,
    each output written once. Both forward products take 16-bit operands
    (p is rounded to V's type): 4 x hd flops per pair. dQ with 16-bit
    inputs: each product once at the 16-bit tensor rate, 6 x hd per pair
    (q.k^T, dout.v^T, ds.k); with f32 inputs all but q.k^T at the f32
    rate."""
    qkv = 3 * BH * n_pad * D * item
    stats = 3 * BH * n_pad * 4
    pk16, pk32 = PEAK_OPS[dtype], PEAK_OPS["float32"]
    dq_ops = ([(2 * D * pairs, pk16), (4 * D * pairs, pk32)]
              if dtype == "float32" else [(6 * D * pairs, pk16)])
    return {
        K1: (qkv + BH * n_pad * D * item + 2 * BH * n_pad * 4 + tables,
             [(4 * D * pairs, pk16)]),
        K2: (qkv + BH * n_pad * D * 4 + stats + BH * n_pad * D * item
             + tables, dq_ops)}


def _bound(nbytes, parts):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(o / peak for o, peak in parts) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_train_kernels(torch, timer, seed):
    """K1, K2, K3 against their plain versions; returns the timed cases'
    records {case: {kernel: record}}."""
    import torch.nn.functional as F

    from repro_torch.core.blockwise import plan_tables
    from repro_torch.core.scheduler import schedule
    from repro_torch.kernels import salo_attention as KA
    from repro_torch.kernels import salo_backward as KB

    out_records = {}
    for ci, (name, c) in enumerate(TRAIN_CASES.items()):
        dtype = getattr(torch, c["dtype"])
        pat = _case_pattern(c["pat"])
        sched = schedule(pat, c["n"])
        plan = sched.plan(c["bq"], c["bk"])
        pk_plan = plan.transposed_packed()
        t = plan_tables(plan, torch.device("cuda", 0))
        BH, D, n_pad = c["bh"], c["hd"], plan.n_pad
        gen = torch.Generator(device="cuda").manual_seed(seed + 100 + ci)
        q, k, v = (torch.randn((BH, n_pad, D), generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
        dout = torch.randn((BH, n_pad, D), generator=gen, device="cuda")
        pos_q = t.pos.reshape(plan.nq, plan.block_q)
        pos_k = t.pos.reshape(plan.nkb, plan.block_k)
        scale = D ** -0.5
        fwd_args = (q, k, v, pos_q, pos_k, t.kv_blocks, t.flags)
        kw = dict(sched=sched, scale=scale)
        out, m, l = KA.salo_table_attention(*fwd_args, **kw)
        ro, rm, rl = KA.salo_table_attention_plain(*fwd_args, **kw)
        delta = (dout * ro.float()).sum(-1)
        bwd_in = (dout, delta, rm, rl, q, k, v, pos_q, pos_k)
        dq = KB.salo_table_backward_dq(*bwd_in, t.kv_blocks, t.flags, **kw)
        rdq = KB.salo_table_backward_dq_plain(*bwd_in, t.kv_blocks, t.flags,
                                              **kw)
        dkv_t = (t.row_tile, t.q_blocks, t.pk_flags)
        dk, dv = KB.salo_table_backward_dkv(*bwd_in, *dkv_t, **kw)
        dk2, dv2 = KB.salo_table_backward_dkv(*bwd_in, *dkv_t, **kw)
        rdk, rdv = KB.salo_table_backward_dkv_plain(*bwd_in, *dkv_t, **kw)
        torch.cuda.synchronize()

        tol, gtol = KA.OUT_TOL[dtype], GRAD_TOL[c["dtype"]]
        ktol, stol = KB.DKV_TOL[dtype], KA.STATS_TOL
        errs = {}
        for what, a, b, tl in (("out", out, ro, tol), ("m", m, rm, stol),
                               ("l", l, rl, stol), ("dq", dq, rdq, gtol),
                               ("dk", dk, rdk, ktol), ("dv", dv, rdv, ktol)):
            a, b = a.float(), b.float()
            check(bool(torch.isfinite(a).all()), f"case {name}: non-finite "
                  f"kernel {what}")
            errs[what] = float((a - b).abs().max())
            check(bool(torch.allclose(a, b, atol=tl, rtol=tl)),
                  f"case {name}: kernel {what} vs plain max abs err "
                  f"{errs[what]} > {tl}")
        check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
              f"case {name}: dK/dV differ between two runs on one input")
        if dtype != torch.float32:
            errs["dq_off_share"] = KB.dq_off_share(dq, rdq)
            check(errs["dq_off_share"] <= KB.DQ_OFF_SHARE,
                  f"case {name}: kernel dq differs from the plain f32 dq "
                  f"rounded to {dtype} on {errs['dq_off_share']} of its "
                  f"elements > {KB.DQ_OFF_SHARE}")
            # dout at a train step's scale, compared relative to it
            sin = (dout * SMALL_DOUT, delta * SMALL_DOUT, *bwd_in[2:])
            sdq = KB.salo_table_backward_dq(*sin, t.kv_blocks, t.flags, **kw)
            srdq = KB.salo_table_backward_dq_plain(*sin, t.kv_blocks,
                                                   t.flags, **kw)
            sdk, sdv = KB.salo_table_backward_dkv(*sin, *dkv_t, **kw)
            srdk, srdv = KB.salo_table_backward_dkv_plain(*sin, *dkv_t, **kw)
            for what, a, b in (("dk", sdk, srdk), ("dv", sdv, srdv)):
                a, b = a / SMALL_DOUT, b / SMALL_DOUT
                errs[f"small_{what}"] = float((a - b).abs().max())
                check(bool(torch.allclose(a, b, atol=ktol, rtol=ktol)),
                      f"case {name}: dout x {SMALL_DOUT}: kernel {what} vs "
                      f"plain max abs err {errs[f'small_{what}']} (relative "
                      f"to the scale) > {ktol}")
            errs["small_dq_off_share"] = KB.dq_off_share(sdq, srdq)
            check(errs["small_dq_off_share"] <= KB.DQ_OFF_SHARE,
                  f"case {name}: dout x {SMALL_DOUT}: dq off share "
                  f"{errs['small_dq_off_share']} > {KB.DQ_OFF_SHARE}")
        pad = t.pos >= sched.n                      # padding rows
        if bool(pad.any()):
            check(bool((m[:, pad] == -1e30).all() and (l[:, pad] == 0).all()
                       and (out[:, pad] == 0).all()),
                  f"case {name}: padded rows must give (0, NEG_INF, 0)")
        n_split = pk_plan.n_rows - len(set(pk_plan.row_tile.tolist()))
        pairs = BH * _attended_pairs(torch, sched, pos_q, pos_k, t.kv_blocks,
                                     t.flags)
        log(f"[train-kernels] case {name} {c['dtype']} {pat} n={c['n']} "
            f"n_pad={n_pad} B*H={BH} hd={D} bq={c['bq']} bk={c['bk']}: "
            f"steps={plan.max_steps} tiles={int(plan.num_steps.sum())} "
            f"packed rows={pk_plan.n_rows} (split {n_split}) "
            f"pairs={pairs} max abs err {errs}; dK/dV bitwise equal over "
            f"two runs")
        if c["pat"][0] == "csw" and c["pat"][3] > 1:
            check(n_split > 0, f"case {name}: no transposed row split")
        if name not in TIMED:
            continue

        item = q.element_size()
        qkv = 3 * BH * n_pad * D * item
        stats = 3 * BH * n_pad * 4
        tables = 4 * (t.pos.numel() + t.kv_blocks.numel() + t.flags.numel())
        ttables = 4 * (t.pos.numel() + sum(x.numel() for x in dkv_t))
        # (bytes moved, [(operations, peak for their type), ...]); K1 and
        # K2 as _k12_io. dK/dV with 16-bit inputs: each product once at the
        # 16-bit tensor rate, 8 x hd flops per pair (q.k^T, dout.v^T,
        # p^T.dout, ds^T.q); with f32 inputs every product but q.k^T at
        # the f32 peak.
        pk16, pk32 = PEAK_OPS[c["dtype"]], PEAK_OPS["float32"]
        if c["dtype"] == "float32":
            dkv_ops = [(2 * D * pairs, pk16), (6 * D * pairs, pk32)]
        else:
            dkv_ops = [(8 * D * pairs, pk16)]
        io = {**_k12_io(BH, n_pad, D, item, tables, pairs, c["dtype"]),
              K3: (qkv + BH * n_pad * D * 4 + stats + 2 * BH * n_pad * D * 4
                   + ttables, dkv_ops)}
        # what the kernels run: K1 4 x hd flops per pair of every sub-tile
        # it executes (16-bit: 16-row x 64-key warp sub-tiles, f32: 64 x 64
        # block sub-tiles); K2/K3 with 16-bit inputs the hi/lo split's
        # tensor-core flops (10 and 16 x hd per pair), with f32 each product.
        # At hd 256 the 16-bit kernels split the accumulated columns over
        # nz = 2 blocks, each of which runs the products before them (K1's
        # scores, 2 x hd; K2/K3's scores and dp, 6 x hd) over the full hd.
        split = c["dtype"] != "float32"
        nz = max(1, D // 128) if split else 1
        exec_pairs = BH * _executed_pairs(sched, pos_q, pos_k, t.kv_blocks,
                                          t.flags, 16 if split else 64)
        run_ops = {K1: (2 * nz + 2) * D * exec_pairs,
                   K2: (6 * nz + 4 if split else 6) * D * pairs,
                   K3: (6 * nz + 10 if split else 8) * D * pairs}
        calls = {
            "salo_table_attention": (
                lambda: KA.salo_table_attention(*fwd_args, **kw),
                lambda: KA.salo_table_attention_plain(*fwd_args, **kw)),
            "salo_table_backward_dq": (
                lambda: KB.salo_table_backward_dq(*bwd_in, t.kv_blocks,
                                                  t.flags, **kw),
                lambda: KB.salo_table_backward_dq_plain(
                    *bwd_in, t.kv_blocks, t.flags, **kw)),
            "salo_table_backward_dkv": (
                lambda: KB.salo_table_backward_dkv(*bwd_in, *dkv_t, **kw),
                lambda: KB.salo_table_backward_dkv_plain(*bwd_in, *dkv_t,
                                                         **kw)),
        }
        # yardstick: SDPA with the dense boolean mask (working order is the
        # original order here: no dilation), and that call's backward for
        # K2 and K3 together; padding rows (n_pad > n) attend to themselves
        mask = torch.eye(n_pad, dtype=torch.bool, device="cuda")
        mask[:c["n"], :c["n"]] = torch.from_numpy(pat.mask(c["n"])).cuda()
        qs, kss, vs = (x[None].detach().requires_grad_() for x in (q, k, v))

        def lib_fwd():
            return F.scaled_dot_product_attention(qs, kss, vs,
                                                  attn_mask=mask)

        lib_out = lib_fwd()
        g_lib = dout[None].to(dtype)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (qs, kss, vs), g_lib,
                                       retain_graph=True)

        lib_ms = {"salo_table_attention": timer(lib_fwd)}
        if K2 in TIMED[name]:
            lib_ms["backward"] = timer(lib_bwd)
        del lib_out
        recs = {}
        for kname, (kfn, pfn) in calls.items():
            if kname not in TIMED[name]:
                continue
            nbytes, parts = io[kname]
            bound_ms, bound_by = _bound(nbytes, parts)
            ops = sum(o for o, _ in parts)
            err = (errs["out"] if kname == "salo_table_attention" else
                   errs["dq"] if kname == "salo_table_backward_dq" else
                   max(errs["dk"], errs["dv"]))
            kernel_ms = timer(kfn)
            recs[kname] = dict(
                kernel_ms=kernel_ms,
                # few iterations: a plain call queues hundreds of launches,
                # and the queue must not fill up behind the sleep kernel
                plain_ms=timer(pfn, iters=2, sleep_cycles=4_000_000_000),
                library_ms=lib_ms[K1 if kname == K1 else "backward"],
                bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=err, bytes=nbytes, ops=ops,
                run_ops=run_ops[kname],
                run_tflops=run_ops[kname] / kernel_ms / 1e9,
                run_ops_bound_ms=run_ops[kname] / pk16 * 1e3)
            log(f"[train-kernels] case {name} {kname}: "
                + " ".join(f"{a}={b}" for a, b in recs[kname].items()))
        out_records[name] = recs
    return out_records


# --------------------------------------------------------------------- #
# Runtime plans: the dynamic path (hybrid_attention(plan="dynamic")), on
# device-built step tables. smollm-135m's and longformer-4k's attention at
# full width (8 x 9 query heads on 3 KV heads; 8 x 12 heads), n 4096, hd
# 64, block 256, bf16; keep 4 of smollm's 7 steps (61 of 96 executed),
# full keep, and keep 4 of longformer's 5 (62 of 74).
DYN_CASES = {
    "smollm-135m": dict(pat=("csw", 1024, 4, 1), B=8, H=9, Hkv=3, n=4096,
                        hd=64, blk=256, keeps=(4, 7)),
    "longformer-4k": dict(pat=("lf", 512, 1), B=8, H=12, Hkv=12, n=4096,
                          hd=64, blk=256, keeps=(4,)),
}
# the dynamic-check cases: narrowed f32, run on the card and on the CPU
DYN_CHECK = {
    "causal_sinks": dict(pat=("csw", 100, 4, 1), B=2, H=4, Hkv=2, n=512,
                         hd=64, blk=64),
    "longformer": dict(pat=("lf", 48, 2), B=2, H=3, Hkv=3, n=333, hd=64,
                       blk=32),
    "dilated_sinks": dict(pat=("csw", 24, 3, 2), B=2, H=2, Hkv=1, n=200,
                          hd=128, blk=32),
}


def _issue_ms(torch, fn, n: int = 5) -> float:
    """The host's time to issue one call of ``fn`` (mean of ``n``, after a
    warm-up), without waiting for the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return dt


def _dyn_inputs(torch, c, dtype, gen, device="cuda"):
    shp_q = (c["B"], c["H"], c["n"], c["hd"])
    shp_kv = (c["B"], c["Hkv"], c["n"], c["hd"])
    return [torch.randn(s, generator=gen, device=device).to(dtype)
            for s in (shp_q, shp_kv, shp_kv, shp_q)]


def _flat(torch, q, k):
    """hybrid_attention's flat (B*H, n, D) q and GQA-expanded k."""
    B, H, n, D = q.shape
    rep = H // k.shape[1]
    kf = k[:, :, None].expand(B, k.shape[1], rep, n, D).reshape(B * H, n, D)
    return q.reshape(B * H, n, D), kf


def _dyn_grad(torch, pat, c, q, k, v, cot, plan="dynamic", keep=None):
    """One fwd + bwd of hybrid_attention; returns (out, dq, dk, dv)."""
    from repro_torch.core.attention import hybrid_attention

    xs = [x.detach().requires_grad_() for x in (q, k, v)]
    kw = dict(dynamic_keep=keep) if plan == "dynamic" else {}
    out = hybrid_attention(*xs, pat, block_q=c["blk"], block_k=c["blk"],
                           plan=plan, **kw)
    return (out.detach(), *torch.autograd.grad(out, xs, cot))


def phase_dynamic(torch, timer, seed):
    """The dynamic path on the card: each fwd + bwd must launch K1 once
    and K2 once, K3 never, no plain version; at full keep the device
    tables equal the static plan's and out / dQ the static path's; at
    small keep K1 and K2 on the device tables match their plain versions
    on the same tables; the scatter dK/dV repeats bitwise. Returns the
    path's launch counts and K1/K2 records of smollm-135m at keep 4."""
    import torch.nn.functional as F

    from repro_torch.core import dynamic as DY
    from repro_torch.core.blockwise import (plan_tables,
                                            table_dkv_scatter_scan,
                                            working_stream)
    from repro_torch.kernels import salo_attention as KA
    from repro_torch.kernels import salo_backward as KB

    dtype = torch.bfloat16
    total = {"K1": 0, "K2": 0, "K3": 0}
    records = {}
    for ci, (arch, c) in enumerate(DYN_CASES.items()):
        pat = _case_pattern(c["pat"])
        gen = torch.Generator(device="cuda").manual_seed(seed + 300 + ci)
        q, k, v, cot = _dyn_inputs(torch, c, dtype, gen)
        qf, kf = _flat(torch, q, k)
        BH, D, blk = c["B"] * c["H"], c["hd"], c["blk"]
        for keep in c["keeps"]:
            # the main path: counts set to 0 just before, read just after
            _counters(reset=True)
            res = _dyn_grad(torch, pat, c, q, k, v, cot, keep=keep)
            torch.cuda.synchronize()
            launches, plain = _counters()
            check(launches == {"K1": 1, "K2": 1, "K3": 0} and plain == 0,
                  f"[dynamic] {arch} keep {keep}: launches {launches}, "
                  f"plain {plain}; want K1 1, K2 1, K3 0, plain 0")
            for key in total:
                total[key] += launches[key]
            check(all(bool(torch.isfinite(x.float()).all()) for x in res),
                  f"[dynamic] {arch} keep {keep}: non-finite out or grads")

            cfg = DY.DynamicConfig(keep=keep)
            plan, kvt, flg, _ = DY.dynamic_tables(qf, kf, pat, cfg,
                                                  block_q=blk, block_k=blk)
            sched = plan.sched
            t = plan_tables(plan, q.device)
            pos_q = t.pos.reshape(plan.nq, blk)
            pos_k = t.pos.reshape(plan.nkb, blk)
            total_steps, kept = DY._kept_steps(plan.flags, keep)
            check(int((flg != 0).sum()) == kept,
                  f"[dynamic] {arch} keep {keep}: {int((flg != 0).sum())} "
                  f"steps kept, want {kept}")
            scale = D ** -0.5
            kw = dict(sched=sched, scale=scale)
            vf = v[:, :, None].expand(c["B"], c["Hkv"], c["H"] // c["Hkv"],
                                      c["n"], D).reshape(BH, c["n"], D)
            qw, kw_, vw = (working_stream(x, sched, plan).contiguous()
                           for x in (qf, kf, vf))
            dout = working_stream(cot.reshape(BH, c["n"], D), sched,
                                  plan).float().contiguous()
            fwd = (qw, kw_, vw, pos_q, pos_k, kvt, flg)
            out_w, m, l = KA.salo_table_attention(*fwd, **kw)
            delta = (dout * out_w.float()).sum(-1)
            bwd = (dout, delta, m, l, qw, kw_, vw, pos_q, pos_k)
            sc1 = table_dkv_scatter_scan(*bwd, kvt, flg, sched, scale)
            sc2 = table_dkv_scatter_scan(*bwd, kvt, flg, sched, scale)
            check(torch.equal(sc1[0], sc2[0]) and torch.equal(sc1[1], sc2[1]),
                  f"[dynamic] {arch} keep {keep}: the scatter dK/dV differs "
                  f"between two calls")
            errs = {}
            if keep >= plan.max_steps:
                check(torch.equal(kvt, t.kv_blocks)
                      and torch.equal(flg, t.flags),
                      f"[dynamic] {arch} full keep: the device tables differ "
                      f"from the static plan's")
                st = _dyn_grad(torch, pat, c, q, k, v, cot, plan="static")
                bitwise = {w: torch.equal(a, b) for w, a, b in
                           zip(("out", "dq", "dk", "dv"), res, st)}
                for w, a, b, tl in (("out", res[0], st[0], KA.OUT_TOL[dtype]),
                                    ("dq", res[1], st[1], GRAD_TOL["bfloat16"])):
                    errs[w] = float((a.float() - b.float()).abs().max())
                    check(bool(torch.allclose(a.float(), b.float(), atol=tl,
                                              rtol=tl)),
                          f"[dynamic] {arch} full keep: {w} vs the static "
                          f"path max abs err {errs[w]} > {tl}")
                dkv_t = (t.row_tile, t.q_blocks, t.pk_flags)
                dk3, dv3 = KB.salo_table_backward_dkv(*bwd, *dkv_t, **kw)
                ktol = KB.DKV_TOL[dtype]
                for w, a, b in (("dk", sc1[0], dk3), ("dv", sc1[1], dv3)):
                    errs[w] = float((a - b).abs().max())
                    check(bool(torch.allclose(a, b, atol=ktol, rtol=ktol)),
                          f"[dynamic] {arch} full keep: scatter {w} vs K3 "
                          f"max abs err {errs[w]} > {ktol}")
                log(f"[dynamic] {arch} full keep {keep}: device tables equal "
                    f"the static plan's; vs the static path: bitwise "
                    f"{bitwise}, max abs err {errs} (scatter dK/dV vs K3 "
                    f"on the packed tables)")
            else:
                ro, rm, rl = KA.salo_table_attention_plain(*fwd, **kw)
                dq = KB.salo_table_backward_dq(*bwd, kvt, flg, **kw)
                rdq = KB.salo_table_backward_dq_plain(*bwd, kvt, flg, **kw)
                for w, a, b, tl in (("out", out_w, ro, KA.OUT_TOL[dtype]),
                                    ("m", m, rm, KA.STATS_TOL),
                                    ("l", l, rl, KA.STATS_TOL),
                                    ("dq", dq, rdq, GRAD_TOL["bfloat16"])):
                    errs[w] = float((a.float() - b.float()).abs().max())
                    check(bool(torch.allclose(a.float(), b.float(), atol=tl,
                                              rtol=tl)),
                          f"[dynamic] {arch} keep {keep}: kernel {w} vs plain "
                          f"on the device tables max abs err {errs[w]} > {tl}")
                errs["dq_off_share"] = KB.dq_off_share(dq, rdq)
                check(errs["dq_off_share"] <= KB.DQ_OFF_SHARE,
                      f"[dynamic] {arch} keep {keep}: dq off share "
                      f"{errs['dq_off_share']} > {KB.DQ_OFF_SHARE}")
                rows_moved = int((kvt != t.kv_blocks[:, :keep]).any(1).sum())
                log(f"[dynamic] {arch} keep {keep}: K1, K2 on the device "
                    f"tables vs their plain versions max abs err {errs}; "
                    f"{rows_moved} of {plan.nq} rows differ from the static "
                    f"table's first {keep} steps")
            log(f"[dynamic] {arch} keep {keep}: tables {tuple(kvt.shape)} "
                f"(static {tuple(t.kv_blocks.shape)}), executed steps "
                f"{kept} of {total_steps} (ratio {kept / total_steps}); "
                f"launches {launches}; scatter dK/dV bitwise equal over two "
                f"calls")
            if arch != "smollm-135m" or keep >= plan.max_steps:
                continue

            # times on the card: selection, K1 and K2 on the device
            # tables, the scatter twin against K3, the op fwd + bwd
            # dynamic against static
            window = DY._resolve_window(cfg, blk, blk)
            dkv_t = (t.row_tile, t.q_blocks, t.pk_flags)
            tms_fns = {
                "select_ms": lambda: DY._selected(qw, kw_, plan, cfg, window,
                                                  keep, scale),
                "scatter_dkv_ms": lambda: table_dkv_scatter_scan(
                    *bwd, kvt, flg, sched, scale),
                "k3_static_ms": lambda: KB.salo_table_backward_dkv(
                    *bwd, *dkv_t, **kw),
                "dynamic_fwd_bwd_ms": lambda: _dyn_grad(
                    torch, pat, c, q, k, v, cot, keep=keep),
                "static_fwd_bwd_ms": lambda: _dyn_grad(
                    torch, pat, c, q, k, v, cot, plan="static"),
            }
            tms = {name: timer(fn, iters=20 if name in ("select_ms",
                                                         "k3_static_ms")
                               else 5)
                   for name, fn in tms_fns.items()}
            # the host's time to issue a call (no wait on the card): the
            # selection is ~30 small launches
            issue = {name: _issue_ms(torch, fn) for name, fn in (
                ("select", tms_fns["select_ms"]),
                ("scatter_dkv", tms_fns["scatter_dkv_ms"]),
                ("dynamic_fwd_bwd", tms_fns["dynamic_fwd_bwd_ms"]),
                ("static_fwd_bwd", tms_fns["static_fwd_bwd_ms"]))}
            # no host read on the call path: ATen's synchronizing ops raise
            # under the sync debug mode (which does not see every sync)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                tms_fns["dynamic_fwd_bwd_ms"]()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            log(f"[dynamic] {arch} keep {keep}: fwd + bwd ran under "
                f"torch.cuda.set_sync_debug_mode('error') with no "
                f"synchronizing op; host issue ms a call {issue}")
            item = q.element_size()
            tables = 4 * (t.pos.numel() + kvt.numel() + flg.numel())
            pairs = BH * _attended_pairs(torch, sched, pos_q, pos_k, kvt,
                                         flg)
            io = _k12_io(BH, plan.n_pad, D, item, tables, pairs, "bfloat16")
            # yardstick: SDPA with the dense mask the selection implies
            sel = torch.zeros((plan.nq, plan.nkb + 1), dtype=torch.bool,
                              device="cuda")
            sel.scatter_(1, torch.where(flg != 0, kvt, plan.nkb).long(),
                         True)
            sel = sel[:, :plan.nkb]
            mask = torch.from_numpy(pat.mask(c["n"])).cuda() & \
                sel.repeat_interleave(blk, 0).repeat_interleave(blk, 1)
            qs, kss, vs = (x[None].detach().requires_grad_()
                           for x in (qw, kw_, vw))
            lib_out = F.scaled_dot_product_attention(qs, kss, vs,
                                                     attn_mask=mask)
            lib = {K1: timer(lambda: F.scaled_dot_product_attention(
                       qs, kss, vs, attn_mask=mask)),
                   K2: timer(lambda: torch.autograd.grad(
                       lib_out, (qs, kss, vs), dout[None].to(dtype),
                       retain_graph=True))}
            del lib_out
            calls = {
                K1: (lambda: KA.salo_table_attention(*fwd, **kw),
                     lambda: KA.salo_table_attention_plain(*fwd, **kw),
                     errs["out"]),
                K2: (lambda: KB.salo_table_backward_dq(*bwd, kvt, flg, **kw),
                     lambda: KB.salo_table_backward_dq_plain(*bwd, kvt, flg,
                                                             **kw),
                     errs["dq"])}
            for kname, (kfn, pfn, err) in calls.items():
                bound_ms, bound_by = _bound(*io[kname])
                records[kname] = dict(
                    kernel_ms=timer(kfn),
                    plain_ms=timer(pfn, iters=2, sleep_cycles=4_000_000_000),
                    library_ms=lib[kname], bound_ms=bound_ms,
                    bound_by=bound_by, max_abs_err=err, pairs=pairs)
                log(f"[dynamic] {arch} keep {keep} {kname}: "
                    + " ".join(f"{a}={b}" for a, b in records[kname].items()))
            log(f"[dynamic] {arch} keep {keep} times (ms): "
                + " ".join(f"{a}={b}" for a, b in tms.items())
                + f"; scatter / K3 {tms['scatter_dkv_ms'] / tms['k3_static_ms']}"
                + f"; dynamic / static fwd+bwd "
                f"{tms['dynamic_fwd_bwd_ms'] / tms['static_fwd_bwd_ms']}; "
                f"executed-tile ratio {kept / total_steps}")
    log(f"[dynamic] launches on the dynamic path {total}")
    return total, records


def dynamic_check(torch, seed):
    """Narrowed f32 cases on the card and on the CPU from the same tensors:
    the device-built tables equal, out and the three gradients within
    1e-4. Then smollm-135m's bf16 case at full width: how many table rows
    differ between the card and the CPU (near-ties may flip; not gated)."""
    from repro_torch.core import dynamic as DY
    from repro_torch.core.scheduler import schedule

    for ci, (name, c) in enumerate(DYN_CHECK.items()):
        pat = _case_pattern(c["pat"])
        gen = torch.Generator().manual_seed(seed + 400 + ci)
        xs = _dyn_inputs(torch, c, torch.float32, gen, device="cpu")
        qf, kf = _flat(torch, xs[0], xs[1])
        sched_plan = schedule(pat, c["n"]).plan(c["blk"], c["blk"])
        need = int(DY.plan_always_keep(sched_plan, c["blk"]).sum(-1).max())
        # below max_steps (a real selection), at or above the always-kept
        keep = max(need, min(need + 1, sched_plan.max_steps - 1))
        check(keep < sched_plan.max_steps, f"[dynamic-check] {name}: keep "
              f"{keep} leaves nothing to select of {sched_plan.max_steps}")
        cfg = DY.DynamicConfig(keep=keep)
        tabs, res = {}, {}
        for dev in ("cuda", "cpu"):
            _, kvt, flg, _ = DY.dynamic_tables(qf.to(dev), kf.to(dev), pat,
                                               cfg, block_q=c["blk"],
                                               block_k=c["blk"])
            tabs[dev] = (kvt.cpu(), flg.cpu())
            res[dev] = [x.cpu() for x in _dyn_grad(
                torch, pat, c, *(x.to(dev) for x in xs), keep=keep)]
        check(all(torch.equal(a, b) for a, b in zip(tabs["cuda"],
                                                      tabs["cpu"])),
              f"[dynamic-check] {name}: tables differ between cuda and cpu")
        errs = [float((a - b).abs().max()) for a, b in zip(res["cuda"],
                                                            res["cpu"])]
        check(all(torch.allclose(a, b, atol=1e-4, rtol=1e-4)
                  for a, b in zip(res["cuda"], res["cpu"])),
              f"[dynamic-check] {name}: cuda vs cpu (out, dq, dk, dv) max "
              f"abs err {errs} > 1e-4")
        log(f"[dynamic-check] {name} f32 keep {keep} of "
            f"{sched_plan.max_steps}: tables equal on cuda and cpu; (out, "
            f"dq, dk, dv) max abs err {errs}")
    c = DYN_CASES["smollm-135m"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 300)
    q, k, _, _ = _dyn_inputs(torch, c, torch.bfloat16, gen)
    qf, kf = _flat(torch, q, k)
    keep = c["keeps"][0]
    cfg = DY.DynamicConfig(keep=keep)
    got = [DY.dynamic_tables(x, y, _case_pattern(c["pat"]), cfg,
                             block_q=c["blk"], block_k=c["blk"])[1:3]
           for x, y in ((qf, kf), (qf.cpu(), kf.cpu()))]
    rows = int(((got[0][0].cpu() != got[1][0]) |
                (got[0][1].cpu() != got[1][1])).any(1).sum())
    log(f"[dynamic-check] smollm-135m bf16 keep {keep} at full width: "
        f"{rows} of {got[1][0].shape[0]} table rows differ between cuda and "
        f"cpu (not gated)")


def _train_cfg(smoke: bool):
    import dataclasses

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.configs.base import SALOConfig

    if smoke:
        return dataclasses.replace(
            get_smoke("smollm-135m"), d_model=192, n_heads=3, n_kv_heads=1,
            d_ff=256, salo=SALOConfig(window=16, n_global=2, block_q=32,
                                      block_k=32))
    return get_config("smollm-135m")


def _trainer(cfg, dev, params, *, seq, batch, steps, lr, warmup, seed):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import Schedule
    from repro_torch.train.trainer import TrainConfig, make_train_step

    model = build_model(cfg, dev)
    tcfg = TrainConfig(optimizer=adamw.AdamWConfig(lr=lr),
                       schedule=Schedule(warmup_steps=warmup,
                                         total_steps=steps))
    ds = SyntheticLM(cfg, DataConfig(seq, batch, seed=seed))
    return make_train_step(model, tcfg), adamw.init(tcfg.optimizer, params), ds


def _counters(reset: bool = False):
    """The training kernels' launch counts and their plain versions' call
    counts (all set to 0 first when ``reset``)."""
    from repro_torch.kernels import salo_attention as KA
    from repro_torch.kernels import salo_backward as KB

    fns = {"K1": KA.salo_table_attention, "K2": KB.salo_table_backward_dq,
           "K3": KB.salo_table_backward_dkv}
    plains = (KA.salo_table_attention_plain, KB.salo_table_backward_dq_plain,
              KB.salo_table_backward_dkv_plain)
    if reset:
        for f in fns.values():
            f.launches = 0
        for f in plains:
            f.calls = 0
    return ({k: f.launches for k, f in fns.items()},
            sum(f.calls for f in plains))


def train_check(torch, seed, cfg=None, what="smollm-135m hd 64"):
    """The same small f32 model (2 layers; by default smollm's at hd 64)
    trained 3 steps on the card (kernels) and on the CPU (plain versions)
    from the same parameters and batches: losses and grad norms agree
    within 1e-4 (f32, summation order only)."""
    from repro_torch.models.model import build_model

    cfg = cfg if cfg is not None else _train_cfg(smoke=True)
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(seed))
    hist = {}
    for dev in ("cuda", "cpu"):
        p = params if dev == "cpu" else _to(params, dev)
        step, opt, ds = _trainer(cfg, dev, p, seq=128, batch=2, steps=3,
                                 lr=3e-3, warmup=1, seed=seed)
        _counters(reset=True)
        hist[dev] = []
        for i in range(3):
            p, opt, met = step(p, opt, ds.batch(i))
            hist[dev].append((float(met["loss"]), float(met["grad_norm"])))
        launches, plain = _counters()
        if dev == "cuda":
            check(plain == 0 and min(launches.values()) > 0,
                  f"train-check cuda: launches {launches}, plain {plain}")
        else:
            check(plain > 0 and max(launches.values()) == 0,
                  f"train-check cpu: launches {launches}, plain {plain}")
    for (lc, gc), (lp, gp) in zip(hist["cuda"], hist["cpu"]):
        check(math.isclose(lc, lp, rel_tol=1e-4, abs_tol=1e-4)
              and math.isclose(gc, gp, rel_tol=1e-4, abs_tol=1e-4),
              f"train-check {what}: cuda {hist['cuda']} != cpu "
              f"{hist['cpu']}")
    log(f"[train-check] {what}: cuda == cpu within 1e-4, (loss, grad norm) "
        f"per step: cuda {hist['cuda']} cpu {hist['cpu']}")


def train_bytes(cfg, seq: int, batch: int) -> dict:
    """The device bytes a train step of ``cfg`` needs at its peak, reckoned
    from the shapes (bf16 parameters; see ``optim/adamw.py`` and
    ``train/trainer.py``). Resident are the parameters (2 B each) and
    AdamW's f32 moments (4 + 4). The update holds, besides, the step's f32
    gradients and their clipped copy (4 + 4), and adds the new f32
    parameters and moments leaf by leaf (4 + 4 + 4), then the new bf16
    parameters (2): 32 B a parameter at its end. A leaf's own f32
    temporaries (~5 x 4 B each) come on top while it is updated; the
    embedding, the largest, is the first leaf, so they meet only the 18 B
    a parameter held when the update starts. The loss holds the f32 logits, their soft-capped and
    log-softmax copies and their gradient (4 x 4 B a logit), beside what
    the forward saved for the backward: under remat "full" each layer's
    input (d values a token a layer), under "dots" the projections'
    outputs too (q, k, v, o, the MLP's up (and gate) and down products;
    ``models/transformer.py``), all in bf16."""
    d, hd, H, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    gated = cfg.act in ("swiglu", "geglu")
    mlp = (3 if gated else 2) * d * cfg.d_ff
    layer = d * hd * (2 * H + 2 * Hkv) + mlp + 2 * d
    embed = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    params = embed + cfg.n_layers * layer + d
    update = max(32 * params, 18 * params + 20 * embed)
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"train_bytes reckons remat full and dots, got "
                         f"{cfg.remat!r}")
    proj = hd * (H + 2 * Hkv) + d + (2 if gated else 1) * cfg.d_ff + d
    per_token = d + (proj if cfg.remat == "dots" else 0)
    saved = 2 * per_token * seq * batch * cfg.n_layers
    loss = 16 * seq * batch * cfg.vocab_size + 10 * params + saved
    return dict(params=params, per_layer=layer, embedding=embed,
                resident=10 * params, update_peak=update, loss_peak=loss,
                saved=saved, saved_per_token_layer=per_token,
                peak=max(update, loss))


def gemma_train_depth(torch, seq: int, batch: int) -> int:
    """The deepest gemma-7b (every published width kept) whose reckoned
    train-step peak (``train_bytes``) fits in 92 % of the card's memory."""
    import dataclasses

    from repro_torch.configs import get_config

    full = get_config("gemma-7b")
    budget = 0.92 * torch.cuda.get_device_properties(0).total_memory
    depth = 0
    for n in range(1, full.n_layers + 1):
        if train_bytes(dataclasses.replace(full, n_layers=n), seq,
                       batch)["peak"] > budget:
            break
        depth = n
    check(depth > 0, "no layer of gemma-7b fits the card")
    b = train_bytes(dataclasses.replace(full, n_layers=depth), seq, batch)
    log(f"[train gemma-7b] reckoned bytes at seq {seq} batch {batch}: "
        f"embedding {b['embedding'] / 1e6:.1f}M params (tied), "
        f"{b['per_layer'] / 1e6:.1f}M a layer; {depth} of {full.n_layers} "
        f"layers fit {budget / 1e9:.2f} GB (92 % of "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f}): "
        f"{b['params'] / 1e6:.1f}M params, resident {b['resident'] / 1e9:.2f}"
        f" GB, update peak {b['update_peak'] / 1e9:.2f} GB, loss peak "
        f"{b['loss_peak'] / 1e9:.2f} GB (f32 logits {seq * batch * full.vocab_size * 4 / 1e9:.2f} GB)")
    return depth


DOTS_STEPS = 5                   # train-dots: the train phase's first steps


def dots_reckoning(seq: int, batch: int) -> None:
    """train-dots, printed before it runs: what remat "dots" saves beyond
    "full" for smollm-135m (``train_bytes``)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config("smollm-135m")
    full = train_bytes(cfg, seq, batch)
    dots = train_bytes(dataclasses.replace(cfg, remat="dots"), seq, batch)
    log(f"[train-dots] reckoned at seq {seq} batch {batch}: remat dots "
        f"saves {dots['saved_per_token_layer']} bf16 values a token a layer "
        f"(full: {full['saved_per_token_layer']}, the layer input), "
        f"{dots['saved'] / 1e9:.3f} GB over {seq * batch} tokens x "
        f"{cfg.n_layers} layers against {full['saved'] / 1e9:.3f} GB: "
        f"+{(dots['saved'] - full['saved']) / 2**30:.3f} GiB on remat "
        f"full's peak; reckoned loss peak {dots['loss_peak'] / 1e9:.3f} GB "
        f"(full {full['loss_peak'] / 1e9:.3f})")


def phase_train(torch, seed, arch="smollm-135m", n_layers=None,
                steps=TRAIN_STEPS, batch=TRAIN_BATCH, lr=3e-3, warmup=10,
                ft_save_at=None, remat="full", ref=None):
    """``arch`` at full width (and depth unless ``n_layers`` cuts it),
    bf16, remat ``remat``, trained on the card at seq 4096. With
    ``ft_save_at``, {"params", "opt"} after that many steps go to
    ``build/`` through an async ``CheckpointManager``, with a clone kept
    on the card; the steps that overlap the background write are printed
    and left out of the median. With ``ref`` (the stats an earlier run of
    the same seed returned), only ``len(ref["losses"])`` steps of the
    ``steps``-step schedule run, their losses must equal ``ref``'s within
    1e-4 instead of falling. Returns the launch counts of the run,
    what ``phase_train_ft`` needs (None without ``ft_save_at``) and the
    run's stats (losses, median step ms, peak bytes)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch)
    check(cfg.remat == "full", f"config {cfg}")
    cfg = dataclasses.replace(cfg, remat=remat)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    tag = "train" if arch == "smollm-135m" else f"train {arch}"
    if remat != "full":
        tag = f"train-{remat}"
    run = steps if ref is None else len(ref["losses"])
    seq = 4096
    params = build_model(cfg, "cuda").init(
        torch.Generator(device="cuda").manual_seed(seed))
    step, opt, ds = _trainer(cfg, "cuda", params, seq=seq, batch=batch,
                             steps=steps, lr=lr, warmup=warmup, seed=seed)
    n_param = sum(t.numel() for t in tree_leaves(params))
    log(f"[{tag}] {arch} bf16 remat={remat}: {n_param / 1e6:.1f}M params, "
        f"{cfg.n_layers} layers, seq {seq} batch {batch} steps {run} of a "
        f"{steps}-step schedule, lr {lr} warmup {warmup}")
    # cyclic garbage of earlier phases must not count in this one's peak
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log(f"[{tag}] allocated before the first step "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB (parameters, "
        f"optimizer state and whatever earlier phases still hold)")
    _counters(reset=True)
    losses, norms, times, overlapped, ft = [], [], [], [], None
    for i in range(run):
        if ft is not None and ft["mgr"].writing():
            overlapped.append(i)
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, ds.batch(i))
        loss = float(met["loss"])                   # syncs the card
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        norms.append(float(met["grad_norm"]))
        log(f"[{tag}] step {i:3d} loss {loss:.4f} grad norm "
            f"{norms[-1]:.4f} {times[-1] * 1e3:.1f} ms"
            + (" (overlaps the checkpoint write)" if overlapped
               and overlapped[-1] == i else ""))
        if i + 1 == ft_save_at:
            ft = _ft_save(torch, params, opt, i + 1)
    launches, plain = _counters()
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    if ref is None:
        check(sum(losses[-5:]) / 5 < losses[0],
              f"the loss did not fall: {losses}")
    else:
        want_l = ref["losses"][:run]
        check(all(math.isclose(a, b, rel_tol=1e-4, abs_tol=1e-4)
                  for a, b in zip(losses, want_l)),
              f"[{tag}] losses {losses} != remat full's {want_l} (1e-4)")
        log(f"[{tag}] losses equal remat full's first {run} within 1e-4 "
            f"(bitwise: {losses == want_l}): {losses} vs {want_l}")
    # remat full and dots replay the attention forward in the backward
    replay = 1 + (cfg.remat != "none")
    # K3 is two kernels per call: the row walk and the owner-tile sum
    want = {"K1": replay * cfg.n_layers * run, "K2": cfg.n_layers * run,
            "K3": 2 * cfg.n_layers * run}
    check(launches == want, f"launches {launches} != {want}")
    check(plain == 0, f"the plain versions ran {plain} times")
    timed = [t for i, t in enumerate(times) if i and i not in overlapped]
    med = sorted(timed)[len(timed) // 2]
    if overlapped:
        log(f"[{tag}] steps {overlapped} overlapped the background "
            f"checkpoint write: left out of the median "
            f"({[round(times[i] * 1e3, 3) for i in overlapped]} ms)")
    log(f"[{tag}] step median {med * 1e3:.3f} ms over steps 1..{run - 1} "
        f"({batch * seq / med:.1f} tokens/s); first step "
        f"{times[0] * 1e3:.3f} ms; peak memory {peak / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated); launches {launches} "
        f"({ {k: v // run for k, v in launches.items()} } a step)")
    stats = dict(losses=losses, median_ms=med * 1e3, peak=peak)
    if ref is not None:
        log(f"[{tag}] step median {med * 1e3:.3f} ms against remat full's "
            f"{ref['median_ms']:.3f}; peak {peak / 2**30:.3f} GiB against "
            f"{ref['peak'] / 2**30:.3f} GiB (remat full's includes "
            f"train-ft's clone)")

    # After the counts are read: one more step under the profiler.
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    batch_np = ds.batch(run)
    torch.cuda.synchronize()
    prof.start()
    ts = time.perf_counter()
    params, opt, met = step(params, opt, batch_np)
    float(met["loss"])
    dt = time.perf_counter() - ts
    prof.stop()
    by_name = report_profile(prof, dt, 1, "train step")
    # the training kernels' device time per step; K3 is its row walk and
    # its owner-tile sum
    parts = {"K1": ("table_attention_mma_kernel", "table_attention_kernel"),
             "K2": ("dq_mma_kernel", "dq_kernel"),
             "K3": ("dkv_mma_kernel", "dkv_kernel", "owner_sum_kernel")}
    per = {key: sum(t for name, (_, t) in by_name.items()
                    if any(f"::{k}<" in name or f"::{k}(" in name
                           for k in keys)) / 1e3
           for key, keys in parts.items()}
    log(f"[profile] train kernels per step: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in per.items())
        + f"; K2 + K3 {per['K2'] + per['K3']:.3f} ms")
    if ft is not None:
        ft.update(cfg=cfg, step_fn=step, ds=ds,
                  ref={i: (losses[i], norms[i]) for i in range(ft_save_at,
                                                              steps)})
    return launches, ft, stats


def _ft_save(torch, params, opt, at: int) -> dict:
    """train-ft, first half: {"params", "opt"} at step ``at`` through an
    async CheckpointManager under ``build/`` (the device-to-host copy on
    this thread, the write in the background), and a clone on the card."""
    import shutil

    from repro_torch.ft import CheckpointManager
    from repro_torch.tree import tree_flatten_with_path, tree_unflatten

    ckdir = ROOT / "build" / "ft_train"
    shutil.rmtree(ckdir, ignore_errors=True)
    mgr = CheckpointManager(str(ckdir), keep=1, async_write=True)
    state = {"params": params, "opt": opt}
    flat, treedef = tree_flatten_with_path(state)
    clone = tree_unflatten(treedef, [x.clone() if torch.is_tensor(x) else x
                                     for _, x in flat])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(state, at)
    snap_ms = (time.perf_counter() - t0) * 1e3
    nbytes = sum(x.numel() * x.element_size() for _, x in flat
                 if torch.is_tensor(x))
    log(f"[train-ft] checkpoint of step {at} handed to the background "
        f"writer: synchronous snapshot (device to host) {snap_ms:.3f} ms; "
        f"the clone kept on the card adds {nbytes} bytes to the phase's "
        f"peak memory")
    return dict(mgr=mgr, dir=ckdir, at=at, clone=clone, snapshot_ms=snap_ms)


def phase_train_ft(torch, seed, ft) -> dict:
    """train-ft, second half: the checkpoint restored into a freshly
    initialised state must equal the clone bit for bit (every parameter,
    m, v, and the step as an int, each on the card in its dtype); steps
    ``at`` and ``at + 1`` replayed from it must give the train phase's
    losses and grad norms bit for bit. Removes the checkpoint. Returns the
    replay's launch counts."""
    import shutil

    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_flatten_with_path

    mgr, at, cfg = ft["mgr"], ft["at"], ft["cfg"]
    try:
        mgr.wait()
        nbytes = _dir_bytes(ft["dir"])
        params0 = build_model(cfg, "cuda").init(
            torch.Generator(device="cuda").manual_seed(seed + 1))
        like = {"params": params0,
                "opt": adamw.init(adamw.AdamWConfig(), params0)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, step_at = mgr.restore_latest(like)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
    finally:
        shutil.rmtree(ft["dir"], ignore_errors=True)
    check(step_at == at, f"[train-ft] restored step {step_at}, want {at}")
    got, want = (tree_flatten_with_path(t)[0] for t in (state, ft["clone"]))
    check([p for p, _ in got] == [p for p, _ in want],
          "[train-ft] restored tree differs in structure")
    for (path, a), (_, b) in zip(got, want):
        if torch.is_tensor(b):
            check(a.is_cuda and a.dtype == b.dtype and torch.equal(a, b),
                  f"[train-ft] {'::'.join(path)} not bit-equal on the card")
        else:
            check(type(a) is int and a == b == at,
                  f"[train-ft] {'::'.join(path)}: {a!r} != {b!r}")
    params, opt = state["params"], state["opt"]
    del like, params0
    _counters(reset=True)
    replay = {}
    for i in (at, at + 1):
        params, opt, met = ft["step_fn"](params, opt, ft["ds"].batch(i))
        replay[i] = (float(met["loss"]), float(met["grad_norm"]))
    launches, plain = _counters()
    check(plain == 0 and min(launches.values()) > 0,
          f"[train-ft] launches {launches}, plain {plain}")
    for i, got_i in replay.items():
        check(got_i == ft["ref"][i],
              f"[train-ft] step {i} replayed (loss, grad norm) {got_i} != "
              f"the train phase's {ft['ref'][i]}")
    log(f"[train-ft] checkpoint {nbytes} bytes on disk; synchronous "
        f"snapshot {ft['snapshot_ms']:.3f} ms, background write "
        f"{mgr.write_s:.3f} s, restore {restore_ms:.3f} ms; restored state "
        f"bit-equal to the clone (step {step_at}); steps {at}, {at + 1} "
        f"replayed bit-equal: {replay}; launches {launches}")
    return launches


def report_profile(prof, wall_s: float, n_steps: int, what: str) -> dict:
    """Device time by kernel name over the profiled engine steps, and the
    device's idle share (1 - kernel time / host wall time of the steps;
    the profiler's own host overhead inflates the wall time, so this share
    is an upper bound). Returns {name: (launches, device us)}."""
    from torch.autograd import DeviceType

    by_name: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + us)
    busy_ms = sum(t for _, t in by_name.values()) / 1e3
    if not by_name:
        log("[profile] the profiler recorded no device events")
        return by_name
    log(f"[profile] {n_steps} {what}: host wall {wall_s * 1e3:.3f} ms, "
        f"device kernel time {busy_ms:.3f} ms, idle share "
        f"{1 - busy_ms / (wall_s * 1e3):.3f}, "
        f"{sum(n for n, _ in by_name.values()) / n_steps:.0f} kernels/step")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (n, t) in top:
        log(f"[profile]   {t / 1e3 / n_steps:8.3f} ms/step "
            f"{n / n_steps:6.1f} launches/step  {name[:90]}")
    return by_name


def _emitted(eng) -> int:
    """Tokens generated so far by every request of the engine."""
    reqs = list(eng.batcher.finished.values()) + [
        r for r in eng.batcher.rows if r is not None]
    return sum(len(r.out) for r in reqs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import os

    # gemma-7b's train step allocates and frees f32 temporaries of its
    # 786M-parameter embedding: without growable segments the cached
    # blocks fragment (23.6 GiB reserved but unusable at an OOM, on the
    # H100)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    phase_build()
    timer = Timer(torch)
    k4 = phase_kernels(torch, timer, args.seed)
    k5 = phase_k5(torch, timer, args.seed)
    serve_check(torch, args.seed)
    # the lockstep and int8 serve phases run before the profiled serve
    # phase: the profiler's hooks slow the host afterwards
    launches_k5 = phase_lockstep(torch, args.seed)
    launches_int8, int8_tokens, int8_c = phase_serve_int8(torch, args.seed)
    launches, bf16_tokens, bf16_c = phase_serve(torch, args.seed)
    agree = sum(int((int8_tokens[r] == bf16_tokens[r]).sum())
                for r in bf16_tokens)
    first = sum(int(int8_tokens[r][0] == bf16_tokens[r][0])
                for r in bf16_tokens)
    log(f"[serve-int8] tokens equal to the bf16 slab's run: {agree} of "
        f"{SERVE_R * SERVE_NEW} (first tokens {first} of {SERVE_R}; random "
        f"weights, not gated)")
    # gemma-7b at full width and depth on the continuous engine, one
    # profiled decode step
    # kill and resume: the serve phases' runs under the supervisor, two
    # injected crashes each
    launches_ft = phase_serve_ft(torch, args.seed, "serve-ft", bf16_tokens,
                                 bf16_c)
    launches_ft8 = phase_serve_ft(
        torch, args.seed, "serve-ft-int8", int8_tokens, int8_c,
        kv_dtype="int8", page_sparsity_threshold=-3.0, page_stat_decay=0.3)
    launches_gemma, _, _ = phase_serve(torch, args.seed, "gemma-7b",
                                       "serve gemma-7b", (40, 41), False)
    torch.cuda.empty_cache()
    trec = phase_train_kernels(torch, timer, args.seed)
    tl = {}
    tl["dynamic"], drec = phase_dynamic(torch, timer, args.seed)
    dynamic_check(torch, args.seed)
    torch.cuda.empty_cache()
    train_check(torch, args.seed)
    for arch, cfg in _check_cfgs().items():
        if arch in TRAIN_CHECK:
            train_check(torch, args.seed, cfg, f"{arch} hd {cfg.hd}")
    tl["smollm-135m"], ft, full = phase_train(torch, args.seed,
                                              ft_save_at=FT_TRAIN_AT)
    tl["train-ft"] = phase_train_ft(torch, args.seed, ft)
    del ft
    torch.cuda.empty_cache()
    dots_reckoning(4096, TRAIN_BATCH)
    tl["train-dots"], _, _ = phase_train(
        torch, args.seed, remat="dots",
        ref={**full, "losses": full["losses"][:DOTS_STEPS]})
    torch.cuda.empty_cache()
    tl["gemma-7b"], _, _ = phase_train(
        torch, args.seed, "gemma-7b",
        n_layers=gemma_train_depth(torch, 4096, GEMMA_BATCH),
        steps=GEMMA_STEPS, batch=GEMMA_BATCH, lr=1e-3, warmup=3)
    torch.cuda.empty_cache()
    tl["longformer-4k"], _, _ = phase_train(torch, args.seed,
                                            "longformer-4k")

    def row(rec):
        return {"max_abs_err": rec["max_abs_err"], "ms": rec["kernel_ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"],
                **{k: rec[k] for k in ("n_split", "split_len") if k in rec}}

    # K4's main numbers are case (a), the bf16 serve phase's kernel; case
    # (d) is the int8 serve phase's (int8 slab + page statistics), (e) the
    # f32 state variant and (f) one request with a long cache
    kernels = [{
        "name": "salo_paged_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/salo_paged_decode.cu",
        "replaces": "src/repro/kernels/salo_decode.py:238",
        "launches": launches + launches_int8 + launches_gemma
        + launches_ft + launches_ft8,
        "launches_by_path": {"serve": launches, "serve_int8": launches_int8,
                             "serve_ft": launches_ft,
                             "serve_ft_int8": launches_ft8,
                             "serve_gemma_7b": launches_gemma},
        "launches_per_call": 1, **row(k4["a"]),
        "variants": {"int8_page_stats_bf16": row(k4["d"]),
                     "state_page_stats_f32": row(k4["e"]),
                     "single_request_bf16": row(k4["f"]),
                     "gemma_7b_hd256_bf16": row(k4["g"])}}, {
        "name": "salo_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/salo_decode.cu",
        "replaces": "src/repro/kernels/salo_decode.py:173",
        "launches": launches_k5, "launches_per_call": 1, **row(k5["a"]),
        "variants": {"f32": row(k5["b"]), "ring_dilated_bf16": row(k5["c"])}}]
    # launches_per_call: K3's wrapper runs two kernels (the row walk and
    # the owner-tile sum), and its count and its time cover both. The main
    # numbers are case (a), smollm-135m's train attention; the variants are
    # the other timed cases (ViL stages: K1 only)
    variants = {"f": "gemma_7b_hd256_bf16", "g": "gemma_7b_hd256_f32",
                "h": "longformer_4k_bf16", "b": "smollm_f32",
                "i": "vil_stage1_bf16", "j": "vil_stage2_bf16"}
    for name, key, src, replaces, per_call in (
            (K1, "K1", "salo_table_attention.cu",
             "src/repro/kernels/salo_attention.py:119", 1),
            (K2, "K2", "salo_table_backward.cu",
             "src/repro/kernels/salo_backward.py:144", 1),
            (K3, "K3", "salo_table_backward.cu",
             "src/repro/kernels/salo_backward.py:223", 2)):
        by_path = {path.replace("-", "_").replace(".", "_"): c[key]
                   for path, c in tl.items()}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "launches_per_call": per_call,
            **row(trec["a"][name]),
            "variants": {
                **{v: row(trec[c][name]) for c, v in variants.items()
                   if name in trec[c]},
                **({"dynamic_smollm_keep4_bf16": row(drec[name])}
                   if name in drec else {})}})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(json.dumps({"kernels": kernels}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
