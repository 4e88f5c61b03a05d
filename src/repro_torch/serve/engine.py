"""Serving engines: the lockstep baseline and the continuous-batching
engine, on one device or sequence-parallel over a group of ranks.

The port of :mod:`repro.serve.engine`.

``ServeEngine`` (lockstep): prefill a rectangular batch token by token
through ``Model.decode_step``, then decode every sequence at the same
position. Its contiguous caches are read by the decode kernel
:func:`repro_torch.kernels.salo_decode.salo_decode` — one launch per
attention layer per step on the card. It serves every ported family; the
recurrent ones (mamba2, recurrentgemma) only here, as in the reference.

``ContinuousEngine``: requests of different lengths enter the scheduler
(:mod:`repro_torch.serve.batcher`), share ONE pooled paged ring-cache slab
per model segment (:mod:`repro_torch.serve.paged_cache`, fp or int8),
prefill in plan-driven chunks (``ChunkPlan`` — ``ceil(P / chunk)`` fused
passes), and decode ragged: one step serves every in-flight request at its
own position through the per-request ``t`` vector and page tables of
:func:`repro_torch.kernels.salo_decode.salo_paged_decode` — one kernel
launch per layer per step on the card. With ``page_sparsity_threshold``
the kernel also returns per-page max scores, whose decayed history
decides which pages the next step reads.

The reference's jitted steps become eager calls; caches and slabs are
updated in place. The engines run on the model's device ("cuda" unless the
caller asks for "cpu", where every kernel wrapper takes its plain
version).

``ContinuousEngine.state_dict``/``load_state`` snapshot and restore the
whole serving state (the fault-tolerant supervisor,
:class:`repro_torch.ft.manager.ServeSupervisor`, drives them).

Sequence-parallel serving (``seq_shards = S > 1``) runs one engine per rank
of a :class:`~repro_torch.dist.group.SeqGroup` of size S (the reference
runs one program over a "seq" mesh under ``shard_map``). Every rank runs
the same host control on replicated state (the batcher with one page pool
per shard, the page tables, the page-stats history, the counters), and
holds only its own shard's slabs and slot positions: a request's logical
pages are striped over the shards (:class:`~repro_torch.serve.paged_cache
.PagedLayout`). Each engine step runs, per layer, one chunk pass or one
decode launch per rank over the slots that rank owns, with the f32
partials merged across the group
(:func:`~repro_torch.dist.sharded_plan.masked_psum_merge`) and rounded
once; only a slot's owner writes its KV (:func:`sharded_write_target`).
The ranks never diverge: the merged attention is the same bytes on every
rank, so the logits and the greedy tokens are too, and the batcher's clock
is read on rank 0 once a step and agreed by the group
(:meth:`~repro_torch.dist.group.SeqGroup.agree`). Greedy tokens equal the
single-device engine's.
"""
from __future__ import annotations

import dataclasses
import json
import time
from collections.abc import MutableMapping
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.renorm import NEG_INF
from repro_torch.core.scheduler import (BIG, PAD_SENTINEL, build_chunk_plan,
                                        ring_view_positions)
from repro_torch.ft.faults import ResourceExhausted
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from repro_torch.obs import Observability
from repro_torch.serve.batcher import Batcher
from repro_torch.serve.paged_cache import (PagedSlab, empty_positions,
                                           layout_for_pattern,
                                           reset_page_scales, slab_init)


class CountersView(MutableMapping):
    """The engine counters as a live view over registry counters
    (``serve_<key>``): ``counters["x"] += 1``, ``dict(counters)`` and
    ``counters.update(snapshot)`` all work on the metrics registry."""

    KEYS = ("prefill_launches", "decode_launches", "prefill_tokens",
            "decode_tokens", "decode_pages_read", "decode_pages_total",
            "prefill_pages_read", "prefill_pages_total", "engine_steps")

    def __init__(self, registry):
        self._reg = registry

    def __getitem__(self, key: str) -> int:
        if key not in self.KEYS:
            raise KeyError(key)
        return int(self._reg.value("serve_" + key))

    def __setitem__(self, key: str, value) -> None:
        if key not in self.KEYS:
            raise KeyError(key)
        self._reg.set_counter("serve_" + key, int(value))

    def __delitem__(self, key: str) -> None:
        raise TypeError("engine counters are a fixed set")

    def __iter__(self):
        return iter(self.KEYS)

    def __len__(self) -> int:
        return len(self.KEYS)

    def __repr__(self) -> str:
        return repr(dict(self))


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int
    temperature: float = 0.0   # 0 = greedy
    seed: int = 0


class ServeEngine:
    """The lockstep engine: every sequence of a rectangular batch at the
    same position, a Python loop over ``Model.decode_step`` on the
    model's device.

    Greedy decoding takes ``argmax`` (ties to the first index).
    ``temperature > 0`` samples from ``softmax(logits / temperature)``
    with a ``torch.Generator`` seeded from ``ServeConfig.seed``; it cannot
    reproduce the reference's ``jax.random`` stream, so sampled tokens
    differ from the reference's for the same seed."""

    def __init__(self, model: Model, scfg: ServeConfig):
        if model.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ServeEngine on a cuda model needs a CUDA device and "
                "torch.cuda.is_available() is False; build the model with "
                "device='cpu' to run the plain versions on the CPU")
        self.model = model
        self.scfg = scfg

    def prefill(self, params, prompts):
        """prompts: (B, P) token ids. Returns (cache, last_logits (B, V))
        after P decode steps, one token at a time — exactly the decode
        path."""
        prompts = (prompts if torch.is_tensor(prompts)
                   else torch.from_numpy(np.asarray(prompts)))
        prompts = prompts.to(device=self.model.device, dtype=torch.long)
        B, P = prompts.shape
        cache = self.model.init_cache(B, self.scfg.max_len)
        logits = None
        for t in range(P):
            logits, cache = self.model.decode_step(
                params, cache, {"tokens": prompts[:, t:t + 1]}, t)
        return cache, logits[:, -1, :]

    def generate(self, params, prompts, n_new: int) -> torch.Tensor:
        """Greedy or temperature generation. Returns (B, n_new) token ids
        on the model's device."""
        P = prompts.shape[1]
        cache, logits = self.prefill(params, prompts)
        gen = None
        if self.scfg.temperature != 0.0:
            gen = torch.Generator(device=self.model.device)
            gen.manual_seed(self.scfg.seed)
        toks = []
        for i in range(n_new):
            if gen is None:
                tok = torch.argmax(logits, dim=-1)
            else:
                probs = torch.softmax(logits.float() / self.scfg.temperature,
                                      dim=-1)
                tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
            toks.append(tok)
            new_logits, cache = self.model.decode_step(
                params, cache, {"tokens": tok[:, None]}, P + i)
            logits = new_logits[:, -1, :]
        return torch.stack(toks, dim=1)


@dataclasses.dataclass(frozen=True)
class ContinuousConfig:
    """Knobs of the continuous-batching engine.

    ``n_pages`` sizes the pooled slab (page 0 is reserved); ``chunk`` is
    the prefill chunk length (one fused pass each); ``max_batch`` the
    engine rows (max concurrent requests). ``max_queue`` bounds the
    admission queue (``submit`` raises ``QueueFull`` beyond it);
    ``preempt`` enables page-pressure preemption with re-prefill.

    ``kv_dtype``: ``"compute"`` stores the slab at the model's compute
    dtype; ``"int8"`` stores it quantized with per-(layer, page) scales
    (paper §6.4 deployment numerics).

    ``page_sparsity_threshold``: ``None`` disables the page statistics.
    A float enables Salca-style page skipping: each decode step every
    request's per-page max score (log-space, relative to its row max)
    updates a decayed historical max, and pages whose history falls below
    the threshold are routed to the null page for the next step — sink
    pages and the current write page are always kept. ``-inf`` keeps the
    statistics on but skips nothing. ``page_stat_decay`` is the per-step
    additive log-space decay (``hist = max(rel, hist - decay)``).

    ``seq_shards > 1``: sequence-parallel serving over a group of that many
    ranks (``ContinuousEngine(..., group=...)``); ``n_pages`` then sizes
    each shard's own pool (``1 + max_batch * layout.pages_per_shard``
    holds every row). There is no ``decode_impl``: the slab's device
    decides kernel or plain version."""
    n_pages: int
    page: int = 8
    chunk: int = 16
    max_batch: int = 4
    seq_shards: int = 1
    kv_dtype: str = "compute"
    page_sparsity_threshold: Optional[float] = None
    page_stat_decay: float = 0.0
    max_queue: Optional[int] = None
    preempt: bool = True


def require_attention_program(model: Model) -> None:
    """The continuous engine serves text-only programs of attention blocks
    (``transformer.ATTN_KINDS``: with a plain MLP, or the MoE FFN of
    arctic and kimi); the recurrent families (mamba2, recurrentgemma)
    serve through the lockstep :class:`ServeEngine`. Raises the
    reference's ``NotImplementedError``."""
    cfg = model.cfg
    if cfg.mrope_sections is not None or cfg.encoder_decoder:
        raise NotImplementedError("continuous serving: text-only LMs")
    for kind, _ in model.program:
        if kind not in T.ATTN_KINDS:
            raise NotImplementedError(
                f"continuous serving needs attention blocks, got {kind}")


class ContinuousEngine:
    """Continuous-batching serving over the paged ring-cache slab, on one
    device or as one rank of a sequence group. Greedy decoding only;
    attention-block architectures with a causal 1-D SALO pattern.

    ``group``: this rank's :class:`~repro_torch.dist.group.SeqGroup`,
    required with ``seq_shards > 1`` and of exactly that size (the
    reference's ``mesh``/``seq_axis``); the engine's device must be the
    group's."""

    def __init__(self, model: Model, ccfg: ContinuousConfig,
                 device="cuda",
                 clock: Optional[Callable[[], float]] = None,
                 obs: Optional[Observability] = None, group=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ContinuousEngine(device='cuda') needs a CUDA device and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain versions on the CPU")
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        S = ccfg.seq_shards
        if S < 1:
            raise ValueError(f"seq_shards must be >= 1, got {S}")
        if (S > 1 or group is not None) and (group is None
                                             or group.size != S):
            raise ValueError(
                f"seq_shards={S} needs a SeqGroup of that size, got "
                f"{None if group is None else f'one of size {group.size}'}")
        if group is not None and torch.device(group.device) != self.device:
            raise ValueError(f"the group's rank lives on {group.device}, "
                             f"the engine on {self.device}")
        if ccfg.kv_dtype not in ("compute", "int8"):
            raise ValueError(f"kv_dtype must be 'compute' or 'int8', got "
                             f"{ccfg.kv_dtype!r}")
        require_attention_program(model)
        cfg = model.cfg
        self.model = model
        self.ccfg = ccfg
        self.group = group
        self.n_shards = S
        self.shard = 0 if group is None else group.index
        self.quantized = ccfg.kv_dtype == "int8"
        self.track_stats = ccfg.page_sparsity_threshold is not None
        self.pattern = L.salo_pattern(cfg, causal=True)
        if self.pattern.is_2d or not self.pattern.causal:
            raise NotImplementedError("continuous serving: causal 1-D only")
        self.obs = obs if obs is not None else Observability()
        self.tracer = self.obs.tracer
        self.registry = self.obs.registry
        self.layout = layout_for_pattern(self.pattern, ccfg.page, shards=S)
        # Under a group the batcher reads the clock agreed at the start of
        # the step (or submit), so every rank takes the same decisions.
        self._clock = clock or time.monotonic
        self._now = None
        if group is not None:
            self._agree_clock()
        self.batcher = Batcher(self.layout, ccfg.n_pages, ccfg.max_batch,
                               max_queue=ccfg.max_queue,
                               clock=(self._clock if group is None
                                      else lambda: self._now),
                               obs=self.obs)
        self.batcher.on_finish = self._release_hook

        lay = self.layout
        self.chunk_pad = -(-max(ccfg.chunk, 1) // ccfg.page) * ccfg.page
        self.nq = self.chunk_pad // ccfg.page
        self.ctx_len = lay.n_sink + lay.ring_cap
        # step-table width: this shard's ctx tiles + the chunk (the full
        # view on one device), so every chunk has one shape
        self.table_w = (self.ctx_len // S + self.chunk_pad) // ccfg.page

        dtype = L.dt(cfg, "compute")
        self.slabs = {
            f"seg{i}_{kind}": slab_init(n, ccfg.n_pages, ccfg.page,
                                        cfg.n_kv_heads, cfg.hd, dtype,
                                        self.device,
                                        quantized=self.quantized)
            for i, (kind, n) in enumerate(model.program)}
        # Per-(request row, logical page) decayed historical max score
        # (log-space, relative to the row max). 0 = "hot": fresh pages
        # start kept; fully-masked or skipped pages only ever decay.
        self.page_hist = np.zeros((ccfg.max_batch, lay.pages_per_req),
                                  np.float64)
        self.slot_pos = empty_positions(ccfg.max_batch, lay, self.device)
        self.page_tables = np.zeros((ccfg.max_batch, lay.pages_per_req),
                                    np.int32)
        self.counters = CountersView(self.registry)
        for key in CountersView.KEYS:
            self.registry.counter("serve_" + key)
        # Per-launch estimated HBM traffic of the KV slab reads (pages read
        # x page bytes across all layers).
        itemsize = 1 if self.quantized else \
            torch.empty((), dtype=dtype).element_size()
        self._page_read_bytes = (2 * sum(n for _, n in model.program)
                                 * ccfg.page * cfg.n_kv_heads * cfg.hd
                                 * itemsize)
        self.registry.set("serve_slab_resident_bytes",
                          self.slab_resident_bytes())

    # --------------------------- device steps -------------------------- #
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _stripe(self, a, width: int):
        """This shard's stripe of the last axis of ``a``, whose
        ``n_shards * width`` entries stripe contiguously over the shards
        (all of it on one device)."""
        lo = self.shard * width
        return a[..., lo:lo + width]

    def _agree_clock(self) -> None:
        self._now = self.group.agree(self._clock())

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        """Final norm + logits head."""
        cfg = self.model.cfg
        x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        return L.logits_apply(params["embed"], params.get("lm_head"), x, cfg)

    def _chunk_fn(self, params, page_table, ctx_pos, pos_q, tokens,
                  kv_blocks, flags, phys_w, off_w) -> torch.Tensor:
        """One plan-driven prefill chunk for ONE request (all layers, slab
        written in place). Returns the final hidden states (1, Cp, d)."""
        cfg = self.model.cfg
        x = self.model._embed_inputs(params, {"tokens": tokens[None]})
        for i, (kind, _) in enumerate(self.model.program):
            key = f"seg{i}_{kind}"
            x = T.segment_chunk_prefill(
                params[key], self.slabs[key], x, page_table, ctx_pos[None],
                pos_q[None], kv_blocks, flags, phys_w, off_w, cfg, kind,
                self.pattern, group=self.group)
        return x

    def _decode_fn(self, params, page_tables, tokens, t_vec, active,
                   page_keep=None):
        """Every in-flight request advances one token at its own position.
        Inactive rows write to the null page; their logits are discarded.
        ``page_tables`` (R, pages_per_shard): this shard's stripe (all of
        them on one device); only the owner of the slot a token lands in
        writes its KV (:func:`sharded_write_target`).

        ``page_keep`` (R, pages_per_shard) bool (page-sparsity mode only):
        pages the stats history says to read this step, striped like the
        page tables. Dropped pages are routed to the null page AND their
        slots' read positions masked to PAD; the persisted ``slot_pos`` and
        page tables are untouched, so a page whose history comes back above
        threshold is simply read again.

        Returns (logits (R, V), page_m) — ``page_m`` (R, npp), the max
        per-(request, logical page) score over all layers (every shard's
        stripe, put together by one ``all_reduce`` MAX), when page stats
        are tracked, else ``None``."""
        lay = self.layout
        R = tokens.shape[0]
        keep, slot, phys_w, off_w = sharded_write_target(
            lay, page_tables, t_vec, active, self.shard)
        slot = slot.long()
        rows = torch.arange(R, device=self.device)
        self.slot_pos[rows, slot] = torch.where(
            keep, t_vec, self.slot_pos[rows, slot])
        pt_read, pos_read = page_tables, self.slot_pos
        if page_keep is not None:
            pt_read = torch.where(page_keep, page_tables, 0)
            pos_read = torch.where(
                page_keep.repeat_interleave(lay.page, dim=1), self.slot_pos,
                PAD_SENTINEL)
        x = self.model._embed_inputs(params, {"tokens": tokens[:, None]})
        page_m = None
        for i, (kind, _) in enumerate(self.model.program):
            key = f"seg{i}_{kind}"
            res = T.segment_decode_paged(
                params[key], self.slabs[key], x, pt_read, pos_read, t_vec,
                phys_w, off_w, self.model.cfg, kind, self.pattern,
                want_page_stats=self.track_stats, group=self.group)
            if self.track_stats:
                x, pm = res
                page_m = pm if page_m is None else torch.maximum(page_m, pm)
            else:
                x = res
        if page_m is not None and self.group is not None:
            full = torch.full((R, lay.pages_per_req), NEG_INF,
                              dtype=torch.float32, device=self.device)
            self._stripe(full, lay.pages_per_shard).copy_(page_m)
            page_m = self.group.pmax_(full)
        return self._head(params, x)[:, 0, :], page_m

    # --------------------------- host driving -------------------------- #
    def submit(self, prompt, max_new: int, priority: int = 0,
               deadline_s: Optional[float] = None) -> int:
        if self.group is not None:
            self._agree_clock()
        return self.batcher.submit(prompt, max_new, priority=priority,
                                   deadline_s=deadline_s)

    def _release_hook(self, row: int, pages: np.ndarray):
        """Batcher completion callback: retire the row's page stats and
        (int8 slabs) zero the recycled pages' scales in every slab of this
        shard's pool, so a reused page starts from a fresh quantization
        grid. ``pages``: the request's (pages_per_req,) table image."""
        self.page_hist[row] = 0.0
        if self.quantized:
            own = self._stripe(pages, self.layout.pages_per_shard)
            for s in self.slabs.values():
                reset_page_scales(s.k_scale, own)
                reset_page_scales(s.v_scale, own)

    def _admit(self):
        for req in self.batcher.admit():
            self.page_tables[req.row] = req.pages
            self.page_hist[req.row] = 0.0
            self.slot_pos[req.row] = PAD_SENTINEL

    def _advance_prefill(self, params, req):
        """Run the request's next chunk: ONE fused table-driven pass (on
        each rank, over the slots its shard owns).

        A fresh request prefills its prompt; a preemption-resumed request
        prefills ``prompt + out[:-1]`` (``req.prefill_tokens``) through this
        same path, then rejoins decode at its old position."""
        lay, page = self.layout, self.ccfg.page
        src = req.prefill_tokens
        P = req.prefill_len
        c0 = req.prefilled
        clen = min(self.ccfg.chunk, P - c0)
        c1 = c0 + clen
        plan = build_chunk_plan(self.pattern, c0, clen, n_sink=lay.n_sink,
                                ring_cap=lay.ring_cap, block=page,
                                chunk_pad=self.chunk_pad)
        ctx_pos = plan.view_positions[: self.ctx_len]
        Cp = self.chunk_pad
        pos_q = np.full(Cp, BIG, np.int32)
        pos_q[:clen] = np.arange(c0, c1, dtype=np.int32)
        tokens = np.zeros(Cp, np.int64)
        tokens[:clen] = src[c0:c1]
        # Slab write targets: ring-overwritten positions (chunk longer than
        # the ring) and padded rows route to the null page.
        pos = np.arange(c0, c0 + Cp, dtype=np.int64)
        keep = (np.arange(Cp) < clen) & (
            (pos < lay.n_global) | (pos + lay.ring_cap >= c1))
        slot = np.where(pos < lay.n_global, pos,
                        lay.n_sink + (pos - lay.n_global) % lay.ring_cap)
        # Stats-driven ctx-page skipping for the chunk's READ of the paged
        # context (the prefill twin of the decode page-keep mask): pages
        # whose history fell below the threshold are routed to the null
        # page and their positions to BIG; sink pages and pages the chunk
        # WRITES are always kept. Fresh requests have an all-zero (hot)
        # history, so plain prefill is untouched.
        npp = lay.pages_per_req
        pt_read, ctx_read = req.pages, ctx_pos
        pages_read = npp
        if self.track_stats:
            rkeep = self.page_hist[req.row] \
                >= self.ccfg.page_sparsity_threshold
            rkeep[: lay.sink_pages] = True
            rkeep[np.unique(slot[keep] // page)] = True
            pages_read = int(rkeep.sum())
            pt_read = np.where(rkeep, req.pages, 0).astype(np.int32)
            ctx_read = np.where(np.repeat(rkeep, page), ctx_pos,
                                BIG).astype(np.int32)
        pps, sps = lay.pages_per_shard, lay.slots_per_shard
        if self.n_shards == 1:
            kv, fl = plan.padded_tables(self.nq, self.table_w)
        else:
            kv, fl = (a[self.shard] for a in plan.sharded_tables(
                self.n_shards, self.nq, self.table_w))
        # this shard writes the chunk positions whose slots it owns
        own = keep & (lay.slot_owner(slot) == self.shard)
        local = lay.slot_local(slot)
        phys = np.where(own, req.pages[self.shard * pps + local // page],
                        0).astype(np.int32)
        off = np.where(own, local % page, 0).astype(np.int32)
        x = self._chunk_fn(params, self._dev(self._stripe(pt_read, pps)),
                           self._dev(self._stripe(ctx_read, sps)),
                           self._dev(pos_q), self._dev(tokens),
                           self._dev(kv), self._dev(fl), self._dev(phys),
                           self._dev(off))
        self.counters["prefill_launches"] += 1
        self.counters["prefill_tokens"] += clen
        self.counters["prefill_pages_read"] += pages_read
        self.counters["prefill_pages_total"] += npp
        self.registry.inc("serve_prefill_est_hbm_bytes",
                          pages_read * self._page_read_bytes)
        self.registry.inc("serve_prefill_tiles",
                          plan.stats()["executed_tiles"])
        req.prefilled = c1
        if c1 == P:
            # only the last prompt row's logits are ever used
            logits = self._head(params, x[:, clen - 1])[0]
            first = int(np.argmax(logits.float().cpu().numpy()))
            rvp = ring_view_positions(P, lay.n_sink, lay.ring_cap,
                                      lay.n_global)
            self.slot_pos[req.row] = self._dev(self._stripe(rvp, sps))
            self.batcher.to_decode(req, first)

    def _page_keep_mask(self, t_vec, active) -> np.ndarray:
        """(R, npp) bool: pages each request reads this step. History at or
        above the threshold keeps a page; sink pages and the page being
        written are always kept (never starve the global prefix or the
        live write point); inactive rows keep all (their reads are already
        null-routed)."""
        lay = self.layout
        R = self.ccfg.max_batch
        keep = self.page_hist >= self.ccfg.page_sparsity_threshold
        keep[:, :lay.sink_pages] = True
        p = np.asarray(t_vec, np.int64)
        slot = np.where(p < lay.n_global, p,
                        lay.n_sink + (p - lay.n_global) % lay.ring_cap)
        keep[np.arange(R), slot // lay.page] = True
        keep[~np.asarray(active, bool)] = True
        return keep

    def _update_page_stats(self, page_m: np.ndarray, active) -> None:
        """Fold one step's per-page max scores into the decayed history.
        ``rel`` is log-relative to the request's row max, so the history
        is invariant to the softmax shift; fully-masked or skipped pages
        carry NEG_INF and therefore only decay."""
        pm = np.asarray(page_m, np.float64)
        rowmax = pm.max(axis=1, keepdims=True)
        rel = pm - np.where(rowmax <= -1e29, 0.0, rowmax)
        upd = np.maximum(rel, self.page_hist - self.ccfg.page_stat_decay)
        act = np.asarray(active, bool)[:, None]
        self.page_hist = np.where(act, upd, self.page_hist)

    def _advance_decode(self, params, reqs):
        R = self.ccfg.max_batch
        lay = self.layout
        tokens = np.zeros(R, np.int64)
        t_vec = np.zeros(R, np.int32)
        active = np.zeros(R, bool)
        for req in reqs:
            tokens[req.row] = req.out[-1]
            t_vec[req.row] = req.t_next
            active[req.row] = True
        keep = (self._page_keep_mask(t_vec, active) if self.track_stats
                else None)
        pps = lay.pages_per_shard
        with self.tracer.span("ragged_decode", cohort=len(reqs)):
            logits, page_m = self._decode_fn(
                params, self._dev(self._stripe(self.page_tables, pps)),
                self._dev(tokens), self._dev(t_vec), self._dev(active),
                None if keep is None else self._dev(self._stripe(keep, pps)))
            logits = logits.float().cpu().numpy()   # span covers the sync
        if self.track_stats:
            with self.tracer.span("page_stats_fold"):
                self._update_page_stats(page_m.cpu().numpy(), active)
            pages_read = int(keep[active].sum())
        else:
            pages_read = len(reqs) * lay.pages_per_req
        self.counters["decode_launches"] += 1
        self.counters["decode_tokens"] += len(reqs)
        self.counters["decode_pages_read"] += pages_read
        self.counters["decode_pages_total"] += len(reqs) * lay.pages_per_req
        self.registry.inc("serve_decode_est_hbm_bytes",
                          pages_read * self._page_read_bytes)
        with self.tracer.span("sample", cohort=len(reqs)):
            for req in reqs:
                self.batcher.record_token(req,
                                          int(np.argmax(logits[req.row])))

    def slab_resident_bytes(self) -> int:
        """Actual bytes of this rank's pooled KV slabs (all segments, K+V,
        plus the per-(layer, page) scales of int8 slabs)."""
        return sum(a.numel() * a.element_size()
                   for s in self.slabs.values() for a in s.tensors())

    def step(self, params) -> bool:
        """One engine iteration: expire overdue requests, admit (preempting
        lower-priority decoders on page pressure), advance every prefilling
        request by one chunk, run one ragged decode step for the decoding
        cohort. Returns True while work remains.

        If nothing is in flight and the queue head still cannot get pages,
        raises the recoverable :class:`~repro_torch.ft.faults
        .ResourceExhausted`."""
        trc = self.tracer
        if self.group is not None:
            self._agree_clock()
        with trc.span("engine.step", step=self.counters["engine_steps"]):
            with trc.span("assemble"):
                self.batcher.expire()
                self._admit()
                if self.batcher.queue and self.ccfg.preempt \
                        and self.batcher.maybe_preempt():
                    self._admit()
                pre, dec = self.batcher.assemble()
            if not pre and not dec:
                if self.batcher.queue:
                    raise ResourceExhausted(
                        "admission stalled with nothing in flight: head of "
                        f"queue needs {self.batcher._shard_needs(self.batcher.queue[0])} "
                        f"pages per shard, free "
                        f"{[a.n_free for a in self.batcher.allocs]}")
                return False
            for req in pre:
                with trc.span("chunk_prefill", rid=req.rid,
                              prefilled=req.prefilled):
                    self._advance_prefill(params, req)
            if dec:
                self._advance_decode(params, dec)
            self.counters["engine_steps"] += 1
        return not self.batcher.idle

    def run(self, params) -> Dict[int, np.ndarray]:
        """Drive all submitted requests to completion; returns
        {rid: generated tokens}."""
        while self.step(params):
            pass
        return self.batcher.results()

    # --------------------------- snapshotting --------------------------- #
    def state_dict(self) -> dict:
        """Full serving state as a checkpointable tree, as the reference
        builds it: the KV slabs (payload + int8 scales) and the slot map
        (under a group this rank's own, so each rank snapshots its own
        tree), the host page tables and page-stats history, and ONE
        variable-length uint8 leaf of JSON bytes carrying the control plane
        (the metrics registry, engine counters included, and the batcher's
        request lifecycle, ``Batcher.state_dict``). Encoding the control
        plane as bytes keeps the tree STRUCTURE fixed while its length
        tracks queue depth.

        The device tensors are CLONES: the engine updates its slabs and
        slot map in place, where the reference's arrays were immutable,
        so a snapshot holding the live tensors would change with the next
        step. Take it at a step boundary, where device and host state are
        mutually consistent."""
        ctl = {"counters": dict(self.counters),
               "batcher": self.batcher.state_dict(),
               "metrics": self.registry.state_dict()}
        blob = np.frombuffer(json.dumps(ctl).encode("utf-8"),
                             np.uint8).copy()
        return {"slabs": {key: PagedSlab(*(None if a is None else a.clone()
                                           for a in s))
                          for key, s in self.slabs.items()},
                "slot_pos": self.slot_pos.clone(),
                "page_tables": self.page_tables.copy(),
                "page_hist": self.page_hist.copy(),
                "control": blob}

    def load_state(self, tree: dict) -> None:
        """Wholesale state replacement from a :meth:`state_dict` image of
        the same model and config (a tree from ``ft.restore``, or a
        reference snapshot through ``convert.engine_state_from_jax``).
        The slab tensors and the slot map are copied INTO the engine's
        own tensors on ``self.device``, so the engine stays on its device
        whatever device the image's tensors are on. After this the engine
        continues exactly where the snapshot was taken: greedy outputs
        match an uninterrupted run token for token (exactly-once
        emission). An image without ``"metrics"`` (the format before the
        registry) restores the counters alone."""
        slabs = tree["slabs"]
        if set(slabs) != set(self.slabs):
            raise ValueError(f"snapshot slabs {sorted(slabs)} != the "
                             f"engine's {sorted(self.slabs)}")
        for key, own in self.slabs.items():
            if slabs[key].quantized != own.quantized:
                raise ValueError(f"snapshot slab {key}: quantized "
                                 f"{slabs[key].quantized}, engine "
                                 f"{own.quantized}")
            for dst, src in zip(own.tensors(), slabs[key].tensors()):
                _copy_into(dst, src, f"slab {key}")
        _copy_into(self.slot_pos, tree["slot_pos"], "slot_pos")
        self.page_tables = np.asarray(tree["page_tables"], np.int32).copy()
        self.page_hist = np.asarray(tree["page_hist"], np.float64).copy()
        ctl = json.loads(bytes(np.asarray(tree["control"],
                                          np.uint8)).decode("utf-8"))
        self.counters.update(ctl["counters"])
        if "metrics" in ctl:   # full-registry image; absent in pre-obs
            self.registry.load_state(ctl["metrics"])   # snapshots, whose
        self.batcher.load_state(ctl["batcher"])        # counters loaded above


def _copy_into(dst: torch.Tensor, src, what: str) -> None:
    """Copy a snapshot tensor into the engine's own tensor, which must
    have its shape and dtype (a mismatch is another model or config)."""
    src = torch.as_tensor(src)
    if src.shape != dst.shape or src.dtype != dst.dtype:
        raise ValueError(f"snapshot {what}: {tuple(src.shape)} {src.dtype},"
                         f" engine {tuple(dst.shape)} {dst.dtype}")
    dst.copy_(src)


def sharded_write_target(lay, page_tables: torch.Tensor, t_vec: torch.Tensor,
                         active: torch.Tensor, idx: int):
    """Per-shard decode write target: each new token's KV lands on shard
    ``idx`` ONLY if that shard owns the token's logical slot; every other
    shard (and every inactive row) routes the write to the null page 0.
    ``page_tables``: (R, pages_per_shard) int32, this shard's stripe;
    ``t_vec``: (R,) int32 positions; ``active``: (R,) bool. Returns
    ``(keep, local_slot, phys, off)``, the last three int32. With one shard
    this is :meth:`PagedLayout.write_target` with ``keep=active``."""
    slot = lay.slot(t_vec)
    keep = active & (lay.slot_owner(slot) == idx)
    local_slot = lay.slot_local(slot)
    phys = torch.gather(page_tables, 1,
                        (local_slot // lay.page)[:, None].long())[:, 0]
    phys = torch.where(keep, phys, 0).to(torch.int32)
    off = torch.where(keep, local_slot % lay.page, 0).to(torch.int32)
    return keep, local_slot.to(torch.int32), phys, off
