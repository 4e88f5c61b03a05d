"""The continuous-batching serving engine on one device.

The port of :class:`repro.serve.engine.ContinuousEngine`. Requests of
different lengths enter the scheduler (:mod:`repro_torch.serve.batcher`),
share ONE pooled paged ring-cache slab per model segment
(:mod:`repro_torch.serve.paged_cache`), prefill in plan-driven chunks
(``ChunkPlan`` — ``ceil(P / chunk)`` fused passes), and decode ragged: one
step serves every in-flight request at its own position through the
per-request ``t`` vector and page tables of
:func:`repro_torch.kernels.salo_decode.salo_paged_decode` — one kernel
launch per layer per step on the card.

The reference's jitted steps become eager calls; the slab is updated in
place. The engine runs on ``device`` ("cuda" unless the caller asks for
"cpu", where every kernel wrapper takes its plain version). Greedy only:
logits come to the host once per step and ``np.argmax`` picks the token
(ties go to the first index), as in the reference.

Not ported yet, each raising ``NotImplementedError``: sequence-parallel
serving (``seq_shards > 1``), the int8 slab (``kv_dtype="int8"``),
page sparsity (``page_sparsity_threshold``) and engine snapshots
(``state_dict``/``load_state``).
"""
from __future__ import annotations

import dataclasses
import time
from collections.abc import MutableMapping
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.scheduler import (BIG, PAD_SENTINEL, build_chunk_plan,
                                        ring_view_positions)
from repro_torch.ft.faults import ResourceExhausted
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from repro_torch.obs import Observability
from repro_torch.serve.batcher import Batcher
from repro_torch.serve.paged_cache import (empty_positions,
                                           layout_for_pattern, slab_init)


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
class ContinuousConfig:
    """Knobs of the continuous-batching engine.

    ``n_pages`` sizes the pooled slab (page 0 is reserved); ``chunk`` is
    the prefill chunk length (one fused pass each); ``max_batch`` the
    engine rows (max concurrent requests). ``max_queue`` bounds the
    admission queue (``submit`` raises ``QueueFull`` beyond it);
    ``preempt`` enables page-pressure preemption with re-prefill.

    ``seq_shards``, ``kv_dtype`` and ``page_sparsity_threshold`` keep the
    reference's fields; only their single-device, compute-dtype, dense
    values are served by the port so far. There is no ``decode_impl``:
    the slab's device decides kernel or plain version."""
    n_pages: int
    page: int = 8
    chunk: int = 16
    max_batch: int = 4
    seq_shards: int = 1
    kv_dtype: str = "compute"
    page_sparsity_threshold: Optional[float] = None
    max_queue: Optional[int] = None
    preempt: bool = True


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP {item}")


class ContinuousEngine:
    """Continuous-batching serving over the paged ring-cache slab, on one
    device. Greedy decoding only; attention-block architectures with a
    causal 1-D SALO pattern."""

    def __init__(self, model: Model, ccfg: ContinuousConfig,
                 device="cuda",
                 clock: Optional[Callable[[], float]] = None,
                 obs: Optional[Observability] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ContinuousEngine(device='cuda') needs a CUDA device and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain versions on the CPU")
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        if ccfg.seq_shards != 1:
            raise _not_ported("sequence-parallel serving (seq_shards > 1)",
                              "'multi-GPU'")
        if ccfg.kv_dtype == "int8":
            raise _not_ported("the int8 slab (kv_dtype='int8')",
                              "'K4 variants' (int8 dequant)")
        if ccfg.kv_dtype != "compute":
            raise ValueError(f"kv_dtype must be 'compute' or 'int8', got "
                             f"{ccfg.kv_dtype!r}")
        if ccfg.page_sparsity_threshold is not None:
            raise _not_ported("page sparsity (page_sparsity_threshold)",
                              "'K4 variants' (page stats)")
        cfg = model.cfg
        if cfg.mrope_sections is not None or cfg.encoder_decoder:
            raise NotImplementedError("continuous serving: text-only LMs")
        self.model = model
        self.ccfg = ccfg
        self.pattern = L.salo_pattern(cfg, causal=True)
        if self.pattern.is_2d or not self.pattern.causal:
            raise NotImplementedError("continuous serving: causal 1-D only")
        self.obs = obs if obs is not None else Observability()
        self.tracer = self.obs.tracer
        self.registry = self.obs.registry
        self.layout = layout_for_pattern(self.pattern, ccfg.page)
        self.batcher = Batcher(self.layout, ccfg.n_pages, ccfg.max_batch,
                               max_queue=ccfg.max_queue,
                               clock=clock or time.monotonic, obs=self.obs)

        lay = self.layout
        self.chunk_pad = -(-max(ccfg.chunk, 1) // ccfg.page) * ccfg.page
        self.nq = self.chunk_pad // ccfg.page
        self.ctx_len = lay.n_sink + lay.ring_cap
        # step-table width: the full view, so every chunk has one shape
        self.table_w = (self.ctx_len + self.chunk_pad) // ccfg.page

        dtype = L.dt(cfg, "compute")
        self.slabs = {
            f"seg{i}_{kind}": slab_init(n, ccfg.n_pages, ccfg.page,
                                        cfg.n_kv_heads, cfg.hd, dtype,
                                        self.device)
            for i, (kind, n) in enumerate(model.program)}
        self.slot_pos = empty_positions(ccfg.max_batch, lay, self.device)
        self.page_tables = np.zeros((ccfg.max_batch, lay.pages_per_req),
                                    np.int32)
        self.counters = CountersView(self.registry)
        for key in CountersView.KEYS:
            self.registry.counter("serve_" + key)
        # Per-launch estimated HBM traffic of the KV slab reads (pages read
        # x page bytes across all layers).
        itemsize = torch.empty((), dtype=dtype).element_size()
        self._page_read_bytes = (2 * sum(n for _, n in model.program)
                                 * ccfg.page * cfg.n_kv_heads * cfg.hd
                                 * itemsize)
        self.registry.set("serve_slab_resident_bytes",
                          self.slab_resident_bytes())

    # --------------------------- device steps -------------------------- #
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

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
                self.pattern)
        return x

    def _decode_fn(self, params, page_tables, tokens, t_vec,
                   active) -> torch.Tensor:
        """Every in-flight request advances one token at its own position.
        Inactive rows write to the null page; their logits are discarded.
        Returns logits (R, V)."""
        cfg = self.model.cfg
        lay = self.layout
        R = tokens.shape[0]
        slot = lay.slot(t_vec).long()
        phys_w, off_w = lay.write_target(page_tables, t_vec, keep=active)
        rows = torch.arange(R, device=self.device)
        self.slot_pos[rows, slot] = torch.where(
            active, t_vec, self.slot_pos[rows, slot])
        x = self.model._embed_inputs(params, {"tokens": tokens[:, None]})
        for i, (kind, _) in enumerate(self.model.program):
            key = f"seg{i}_{kind}"
            x = T.segment_decode_paged(
                params[key], self.slabs[key], x, page_tables, self.slot_pos,
                t_vec, phys_w, off_w, cfg, kind, self.pattern)
        return self._head(params, x)[:, 0, :]

    # --------------------------- host driving -------------------------- #
    def submit(self, prompt, max_new: int, priority: int = 0,
               deadline_s: Optional[float] = None) -> int:
        return self.batcher.submit(prompt, max_new, priority=priority,
                                   deadline_s=deadline_s)

    def _admit(self):
        for req in self.batcher.admit():
            self.page_tables[req.row] = req.pages
            self.slot_pos[req.row] = PAD_SENTINEL

    def _advance_prefill(self, params, req):
        """Run the request's next chunk: ONE fused table-driven pass.

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
        npp = lay.pages_per_req
        kv, fl = plan.padded_tables(self.nq, self.table_w)
        phys = np.where(keep, req.pages[slot // page], 0).astype(np.int32)
        off = np.where(keep, slot % page, 0).astype(np.int32)
        x = self._chunk_fn(params, self._dev(req.pages), self._dev(ctx_pos),
                           self._dev(pos_q), self._dev(tokens),
                           self._dev(kv), self._dev(fl), self._dev(phys),
                           self._dev(off))
        self.counters["prefill_launches"] += 1
        self.counters["prefill_tokens"] += clen
        self.counters["prefill_pages_read"] += npp
        self.counters["prefill_pages_total"] += npp
        self.registry.inc("serve_prefill_est_hbm_bytes",
                          npp * self._page_read_bytes)
        self.registry.inc("serve_prefill_tiles",
                          plan.stats()["executed_tiles"])
        req.prefilled = c1
        if c1 == P:
            # only the last prompt row's logits are ever used
            logits = self._head(params, x[:, clen - 1])[0]
            first = int(np.argmax(logits.float().cpu().numpy()))
            rvp = ring_view_positions(P, lay.n_sink, lay.ring_cap,
                                      lay.n_global)
            self.slot_pos[req.row] = self._dev(rvp)
            self.batcher.to_decode(req, first)

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
        with self.tracer.span("ragged_decode", cohort=len(reqs)):
            logits = self._decode_fn(params, self._dev(self.page_tables),
                                     self._dev(tokens), self._dev(t_vec),
                                     self._dev(active))
            logits = logits.float().cpu().numpy()   # span covers the sync
        pages_read = len(reqs) * lay.pages_per_req
        self.counters["decode_launches"] += 1
        self.counters["decode_tokens"] += len(reqs)
        self.counters["decode_pages_read"] += pages_read
        self.counters["decode_pages_total"] += pages_read
        self.registry.inc("serve_decode_est_hbm_bytes",
                          pages_read * self._page_read_bytes)
        with self.tracer.span("sample", cohort=len(reqs)):
            for req in reqs:
                self.batcher.record_token(req,
                                          int(np.argmax(logits[req.row])))

    def slab_resident_bytes(self) -> int:
        """Actual bytes of the pooled KV slabs (all segments, K+V)."""
        return sum(a.numel() * a.element_size()
                   for s in self.slabs.values() for a in s)

    def step(self, params) -> bool:
        """One engine iteration: expire overdue requests, admit (preempting
        lower-priority decoders on page pressure), advance every prefilling
        request by one chunk, run one ragged decode step for the decoding
        cohort. Returns True while work remains.

        If nothing is in flight and the queue head still cannot get pages,
        raises the recoverable :class:`~repro_torch.ft.faults
        .ResourceExhausted`."""
        trc = self.tracer
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

    def state_dict(self) -> dict:
        raise _not_ported("engine snapshots (state_dict)",
                          "'host services' (obs/ft snapshot)")

    def load_state(self, tree: dict) -> None:
        raise _not_ported("engine snapshots (load_state)",
                          "'host services' (obs/ft snapshot)")
