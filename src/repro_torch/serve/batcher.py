"""Request scheduler for the continuous-batching engine.

Host-side control plane: requests enter a priority/FIFO admission queue,
get pages and an engine row on admission, move through PREFILL (one
plan-driven chunk per engine step) into DECODE (all decoding rows share one
ragged kernel launch per step), and on completion release their pages back
to the pool — which is what lets the next waiting request in. The engine
(:class:`repro_torch.serve.engine.ContinuousEngine`) owns the device arrays; this
module owns the lifecycle.

Per-step work assembly (:meth:`Batcher.assemble`) deliberately mixes the
two phases: every engine step advances each prefilling request by exactly
one chunk AND runs one decode step for the whole decoding cohort, so long
prompts never stall token emission for requests already decoding — the
standard continuous-batching contract (Orca/vLLM), driven here by the
ChunkPlan/ragged-decode machinery.

Robust-serving semantics (the fault-tolerance control plane):

* **Variable footprints** — admission allocates only the pages a request's
  full span ``prompt_len + max_new - 1`` can ever touch
  (:meth:`PagedLayout.pages_needed`); unneeded page-table tail entries stay
  on the null page. A short request no longer pins the worst-case ring.
* **Admission control** — ``submit`` rejects immediately
  (:class:`~repro_torch.ft.faults.RejectedRequest`, with sizing) when the
  footprint exceeds what the pool can EVER provide — the scenario that
  previously deadlocked behind FIFO until a drain-time ``RuntimeError`` —
  and applies backpressure (:class:`~repro_torch.ft.faults.QueueFull`) when the
  bounded queue is full.
* **Preemption** — when admission stalls on pages, the youngest
  strictly-lower-priority DECODE request is evicted: pages released,
  request requeued carrying ``prompt + out``, later recovered through the
  ordinary chunked re-prefill path (``prefill_tokens``). Emission stays
  exactly-once: a resumed request's re-prefill does NOT re-sample the token
  it already emitted.
* **Deadlines** — ``submit(..., deadline_s=...)`` arms a per-request
  deadline on the injectable ``clock``; :meth:`expire` moves overdue
  requests (queued or running) to a failed-with-reason terminal state and
  frees their pages instead of occupying them forever.
* **Snapshot/restore** — :meth:`state_dict`/:meth:`load_state` serialize
  the ENTIRE lifecycle (queue, rows, finished, allocator free lists in
  exact order, counters), riding the engine snapshot so a restored run
  replays deterministically.
* **Observability** — every lifecycle transition (submitted -> admitted ->
  first token -> preempted/expired/finished) emits a trace event on the
  ``requests`` track and feeds the metrics registry: queue-wait, TTFT and
  per-output-token latency histograms plus preemption / deadline-miss /
  completion counters, all labeled by priority class (the per-tenant
  fairness story in BENCH_serve.json). Timestamps ride the batcher's
  injectable ``clock`` — the same one deadlines use — and survive
  snapshot/restore as relative offsets, like deadlines do.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.ft.faults import QueueFull, RejectedRequest
from repro_torch.obs import Observability
from repro_torch.serve.paged_cache import PageAllocator, PagedLayout

WAITING, PREFILL, DECODE, DONE, FAILED = (
    "waiting", "prefill", "decode", "done", "failed")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32
    max_new: int
    priority: int = 0             # higher preempts lower on page pressure
    deadline: Optional[float] = None   # absolute, on the batcher's clock
    state: str = WAITING
    row: int = -1                 # engine batch row while running
    pages: Optional[np.ndarray] = None   # (pages_per_req,) physical pages
    prefilled: int = 0            # prefill tokens already in the cache
    out: List[int] = dataclasses.field(default_factory=list)
    error: Optional[str] = None   # failure reason in FAILED state
    preemptions: int = 0
    # Lifecycle timestamps on the batcher's clock (observability):
    # ``submit_ts`` anchors TTFT, ``wait_since`` anchors the current
    # queue-wait (reset on preemption requeue), ``last_token_ts`` anchors
    # per-output-token latency. Snapshots carry them as relative offsets.
    submit_ts: Optional[float] = None
    wait_since: Optional[float] = None
    last_token_ts: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def total_positions(self) -> int:
        """Positions this request can ever write: the prompt plus every
        generated token that gets fed back (the final sampled token is
        emitted but never fed)."""
        return self.prompt_len + self.max_new - 1

    @property
    def prefill_tokens(self) -> np.ndarray:
        """What (re-)prefill must feed: the prompt, plus — after a
        preemption — every already-emitted token except the last (which is
        fed by the next decode step, exactly as it would have been)."""
        if not self.out:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.out[:-1], np.int32)])

    @property
    def prefill_len(self) -> int:
        return self.prompt_len + max(len(self.out) - 1, 0)

    @property
    def t_next(self) -> int:
        """Position of the next token to feed in DECODE state (the last
        sampled token): prompt_len + generated - 1."""
        return self.prompt_len + len(self.out) - 1

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new


class Batcher:
    """Admission, per-step batch assembly, preemption/expiry, completion."""

    # Release callback, set by the engine: called as
    # ``on_finish(row, pages)`` whenever a row's pages return to the pool
    # (completion, preemption, deadline expiry) and before the row is
    # cleared — the engine uses it to retire per-row page statistics and
    # zero recycled pages' int8 scales so a reused page starts from a
    # fresh quantization grid.
    on_finish = None

    # Fault-injection hook (``FaultInjector.attach``): admission treats a
    # False return exactly like an empty page pool.
    admission_gate: Optional[Callable[[], bool]] = None

    def __init__(self, layout: PagedLayout, n_pages: int, max_batch: int,
                 max_queue: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 obs: Optional[Observability] = None):
        # One allocator per sequence shard (layout.shards == 1 -> exactly
        # the single-pool engine): a request takes its per-shard page needs
        # (:meth:`PagedLayout.pages_needed_per_shard`) from each shard's
        # pool, so ``n_pages`` is the per-shard pool size. Request.pages is
        # the full-width (pages_per_req,) table image — entry j names a
        # physical page on shard j // pages_per_shard, 0 (null) where the
        # request's span never reaches.
        self.layout = layout
        self.n_pages = n_pages
        self.allocs = [PageAllocator(n_pages) for _ in range(layout.shards)]
        self.alloc = self.allocs[0]
        self.max_batch = max_batch
        self.max_queue = max_queue
        self.clock = clock
        self.queue: List[Request] = []
        self.rows: List[Optional[Request]] = [None] * max_batch
        self.finished: Dict[int, Request] = {}
        self._next_rid = 0
        self.preemptions = 0
        self.expired = 0
        self.obs = obs if obs is not None else Observability()

    # --------------------------- observability ------------------------- #
    def _event(self, name: str, req: Request, **args) -> None:
        self.obs.tracer.instant(name, track="requests", rid=req.rid,
                                priority=req.priority, **args)

    def _observe_wait(self, req: Request) -> float:
        """Record the queue wait ending now (admission); returns it."""
        wait = (0.0 if req.wait_since is None
                else max(self.clock() - req.wait_since, 0.0))
        self.obs.registry.observe("serve_queue_wait_s", wait,
                                  priority=req.priority)
        return wait

    # ------------------------------- intake ---------------------------- #
    def submit(self, prompt, max_new: int, priority: int = 0,
               deadline_s: Optional[float] = None) -> int:
        """Admission-controlled intake. Raises
        :class:`~repro_torch.ft.faults.RejectedRequest` when the request's KV
        footprint can never fit the page pool (previously discovered only
        at drain time via ``engine.step``'s RuntimeError), and
        :class:`~repro_torch.ft.faults.QueueFull` when the bounded queue is at
        capacity (backpressure — shed load or retry later)."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        assert prompt.size > 0 and max_new > 0
        total = int(prompt.size) + max_new - 1
        needs = self.layout.pages_needed_per_shard(total)
        usable = self.n_pages - 1     # page 0 is the reserved null page
        if max(needs) > usable:
            self.obs.registry.inc("serve_requests_rejected")
            raise RejectedRequest(
                f"request can never fit: prompt_len={prompt.size} + "
                f"max_new={max_new} spans {total} positions needing "
                f"{max(needs)} pages on a shard (page={self.layout.page}), "
                f"but each pool holds only {usable} usable pages — resize "
                f"n_pages or split the request")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self.obs.registry.inc("serve_queue_full")
            raise QueueFull(
                f"admission queue full ({len(self.queue)} waiting, "
                f"max_queue={self.max_queue})")
        rid = self._next_rid
        self._next_rid += 1
        now = self.clock()
        req = Request(
            rid=rid, prompt=prompt, max_new=max_new, priority=priority,
            deadline=(None if deadline_s is None else now + deadline_s),
            submit_ts=now, wait_since=now)
        self.queue.append(req)
        self.obs.registry.inc("serve_requests_submitted", priority=priority)
        self._event("request.submitted", req, prompt_len=int(prompt.size),
                    max_new=max_new)
        return rid

    # ----------------------------- admission --------------------------- #
    def _sort_queue(self) -> None:
        """Priority order, FIFO within a priority class."""
        self.queue.sort(key=lambda r: (-r.priority, r.rid))

    def _shard_needs(self, req: Request) -> List[int]:
        return self.layout.pages_needed_per_shard(req.total_positions)

    def _pages_fit(self, needs: List[int]) -> bool:
        if self.admission_gate is not None and not self.admission_gate():
            return False
        return all(a.can_alloc(n) for a, n in zip(self.allocs, needs))

    def _take_pages(self, needs: List[int]) -> np.ndarray:
        pps = self.layout.pages_per_shard
        pages = np.zeros(self.layout.pages_per_req, np.int32)
        for s, (a, n) in enumerate(zip(self.allocs, needs)):
            if n:
                pages[s * pps: s * pps + n] = a.alloc(n)
        return pages

    def admit(self) -> List[Request]:
        """Head-of-line admission in priority order while a row AND the
        head's page needs are available (head-of-line per sorted order —
        later requests cannot starve an earlier bigger one)."""
        admitted = []
        while self.queue:
            self._sort_queue()
            row = next((r for r, q in enumerate(self.rows) if q is None),
                       None)
            if row is None:
                break
            needs = self._shard_needs(self.queue[0])
            if not self._pages_fit(needs):
                break  # head-of-line waits for recycled pages (or preempts)
            req = self.queue.pop(0)
            req.pages = self._take_pages(needs)
            req.row = row
            req.state = PREFILL
            req.prefilled = 0
            self.rows[row] = req
            admitted.append(req)
            wait = self._observe_wait(req)
            self.obs.registry.inc("serve_requests_admitted",
                                  priority=req.priority)
            self._event("request.admitted", req, row=row,
                        queue_wait_s=round(wait, 6))
        return admitted

    def maybe_preempt(self) -> int:
        """Page-pressure preemption: while the queue head cannot get its
        pages, evict the youngest DECODE request of strictly lower
        priority — release its pages, requeue it carrying ``prompt + out``
        for chunked re-prefill. Only strictly-lower-priority victims are
        eligible (monotone: a requeued victim can never bounce its own
        preemptor), so equal-priority traffic stays FIFO and livelock-free.
        Returns the number of requests preempted."""
        n = 0
        while self.queue:
            self._sort_queue()
            head = self.queue[0]
            if next((r for r in self.rows if r is None), None) is not None \
                    and self._pages_fit(self._shard_needs(head)):
                break
            victims = [q for q in self.rows
                       if q is not None and q.state == DECODE
                       and q.priority < head.priority]
            if not victims:
                break
            victim = max(victims, key=lambda q: (-q.priority, q.rid))
            self.preempt(victim)
            n += 1
        return n

    def preempt(self, req: Request) -> None:
        """Evict one DECODE request: pages back to the pool, request back
        to the queue with its emitted tokens intact (re-prefill recovers
        the KV; nothing is re-emitted)."""
        assert req.state == DECODE, req.state
        self._release(req)
        req.state = WAITING
        req.prefilled = 0
        req.preemptions += 1
        self.preemptions += 1
        req.wait_since = self.clock()   # queue wait restarts at eviction
        self.queue.append(req)
        self.obs.registry.inc("serve_preemptions", priority=req.priority)
        self._event("request.preempted", req, emitted=len(req.out))

    # ---------------------------- assembly ----------------------------- #
    def assemble(self) -> Tuple[List[Request], List[Request]]:
        """Work for one engine step: (prefilling requests — one chunk each,
        decoding requests — one shared ragged decode step)."""
        pre = [q for q in self.rows if q is not None and q.state == PREFILL]
        dec = [q for q in self.rows if q is not None and q.state == DECODE]
        return pre, dec

    # --------------------------- transitions --------------------------- #
    def to_decode(self, req: Request, first_token: int) -> None:
        """Prefill finished. A fresh request records the token sampled from
        the last-chunk logits; a preemption-resumed request (``out``
        non-empty) already emitted that token before eviction — re-sampling
        would double-emit, so it goes straight back to the decode cohort
        (exactly-once emission)."""
        assert req.state == PREFILL and req.prefilled == req.prefill_len
        now = self.clock()
        if not req.out:
            req.out.append(int(first_token))
            ttft = (max(now - req.submit_ts, 0.0)
                    if req.submit_ts is not None else 0.0)
            self.obs.registry.observe("serve_ttft_s", ttft,
                                      priority=req.priority)
            self._event("request.first_token", req, ttft_s=round(ttft, 6))
        req.last_token_ts = now
        if req.done:
            self.finish(req)
        else:
            req.state = DECODE

    def record_token(self, req: Request, token: int) -> None:
        assert req.state == DECODE
        req.out.append(int(token))
        now = self.clock()
        if req.last_token_ts is not None:
            self.obs.registry.observe(
                "serve_tpot_s", max(now - req.last_token_ts, 0.0),
                priority=req.priority)
        req.last_token_ts = now
        if req.done:
            self.finish(req)

    def _release(self, req: Request) -> None:
        """Return a running request's pages to the pool and free its row
        (shared by completion, preemption, and deadline expiry)."""
        pps = self.layout.pages_per_shard
        for s, a in enumerate(self.allocs):
            held = req.pages[s * pps: (s + 1) * pps]
            a.release(held[held > 0])
        if self.on_finish is not None:
            self.on_finish(req.row, req.pages)
        self.rows[req.row] = None
        req.pages = None
        req.row = -1

    def finish(self, req: Request) -> None:
        """Completion/eviction: recycle the pages, free the row."""
        req.state = DONE
        self._release(req)
        self.finished[req.rid] = req
        self.obs.registry.inc("serve_requests_finished",
                              priority=req.priority)
        self._event("request.finished", req, n_out=len(req.out),
                    preemptions=req.preemptions)

    def expire(self) -> List[Request]:
        """Deadline sweep: move every overdue request — queued or running —
        to the FAILED terminal state with a reason, freeing its pages/row
        so it stops occupying the pool. Returns the expired requests."""
        now = self.clock()
        out = []
        for req in list(self.queue) + [q for q in self.rows if q]:
            if req.deadline is None or now <= req.deadline:
                continue
            if req.row >= 0:
                self._release(req)
            else:
                self.queue.remove(req)
            req.state = FAILED
            req.error = (f"deadline expired after "
                         f"{len(req.out)}/{req.max_new} tokens")
            self.finished[req.rid] = req
            self.expired += 1
            out.append(req)
            self.obs.registry.inc("serve_deadline_miss",
                                  priority=req.priority)
            self._event("request.expired", req, emitted=len(req.out))
        return out

    # --------------------------- snapshotting --------------------------- #
    def state_dict(self) -> dict:
        """JSON-serializable image of the whole lifecycle. Deadlines are
        stored as remaining time and re-anchored on the restoring
        process's clock; allocator free lists keep their exact order so a
        restored run hands out the same physical pages (determinism)."""
        now = self.clock()

        def rel(t: Optional[float]) -> Optional[float]:
            return None if t is None else t - now

        def enc(req: Optional[Request]):
            if req is None:
                return None
            return {"rid": req.rid, "prompt": req.prompt.tolist(),
                    "max_new": req.max_new, "priority": req.priority,
                    "deadline_rem": (None if req.deadline is None
                                     else req.deadline - now),
                    "state": req.state, "row": req.row,
                    "pages": (None if req.pages is None
                              else req.pages.tolist()),
                    "prefilled": req.prefilled, "out": list(req.out),
                    "error": req.error, "preemptions": req.preemptions,
                    "submit_rel": rel(req.submit_ts),
                    "wait_since_rel": rel(req.wait_since),
                    "last_token_rel": rel(req.last_token_ts)}

        return {"queue": [enc(q) for q in self.queue],
                "rows": [enc(q) for q in self.rows],
                "finished": [enc(q) for q in self.finished.values()],
                "next_rid": self._next_rid,
                "free": [list(a._free) for a in self.allocs],
                "preemptions": self.preemptions,
                "expired": self.expired}

    def load_state(self, st: dict) -> None:
        now = self.clock()

        def abs_(r: Optional[float]) -> Optional[float]:
            # old snapshots have no timestamp keys -> None (metrics that
            # need them degrade gracefully, nothing else changes)
            return None if r is None else now + r

        def dec(d):
            if d is None:
                return None
            return Request(
                rid=d["rid"], prompt=np.asarray(d["prompt"], np.int32),
                max_new=d["max_new"], priority=d["priority"],
                deadline=(None if d["deadline_rem"] is None
                          else now + d["deadline_rem"]),
                state=d["state"], row=d["row"],
                pages=(None if d["pages"] is None
                       else np.asarray(d["pages"], np.int32)),
                prefilled=d["prefilled"], out=list(d["out"]),
                error=d["error"], preemptions=d["preemptions"],
                submit_ts=abs_(d.get("submit_rel")),
                wait_since=abs_(d.get("wait_since_rel")),
                last_token_ts=abs_(d.get("last_token_rel")))

        self.queue = [dec(d) for d in st["queue"]]
        self.rows = [dec(d) for d in st["rows"]]
        self.finished = {r.rid: r for r in map(dec, st["finished"])}
        self._next_rid = st["next_rid"]
        for a, free in zip(self.allocs, st["free"]):
            a._free = [int(p) for p in free]
        self.preemptions = st["preemptions"]
        self.expired = st["expired"]

    # ------------------------------ status ----------------------------- #
    @property
    def idle(self) -> bool:
        return not self.queue and all(q is None for q in self.rows)

    def results(self) -> Dict[int, np.ndarray]:
        """Generated tokens of successfully completed requests."""
        return {rid: np.asarray(req.out, dtype=np.int32)
                for rid, req in sorted(self.finished.items())
                if req.state == DONE}

    def failures(self) -> Dict[int, str]:
        """rid -> reason for requests in the FAILED terminal state."""
        return {rid: req.error for rid, req in sorted(self.finished.items())
                if req.state == FAILED}
