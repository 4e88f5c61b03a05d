"""The plan soundness prover: static proofs over concrete step tables.

The port of :mod:`repro.analysis.plan_verify`, over the port's own plans
(:mod:`repro_torch.core.scheduler`, :mod:`repro_torch.dist.sharded_plan`),
with the same passes, messages and counterexamples.

Every check here is an *independent* numpy re-derivation — masks are
re-evaluated from the pattern definition (not through the
``step_mask`` the engines use), visit multisets are rebuilt from the raw
tables, and the exchange schedule is replayed hop by hop — so a bug in
the table construction cannot hide inside a shared helper. What is
proved, per plan:

* **coverage** (:func:`verify_coverage`): walking the forward tables and
  applying each step's flag-gated mask touches every attended
  (query, key) pair of ``window ∪ global-column`` exactly once — no
  missing tiles, no double-counted tiles across fused steps — and the
  union, mapped back through the data-reordering permutation, equals the
  dense ``pattern.mask(n)`` oracle on every row the plan owns (global
  rows belong to the dense epilogue).
* **adjoint** (:func:`verify_transposed` / :func:`verify_packed`): the
  transposed and packed-transposed tables are an exact permutation of
  the forward walk — the same ``(q_block, kv_tile, flags)`` visit
  multiset, nothing dropped, nothing invented.
* **exchange** (:func:`verify_sharded`): each shard's remapped
  ``[local | halo | global]`` tables, pushed through
  ``ShardedPlan.view_map``, reconstruct exactly the unsharded visit set;
  every halo view slot's owner sits at its group's declared distance and
  the owner's ``send_idx`` schedules precisely that tile on that
  ppermute hop; every global tile has exactly one owner feeding the
  masked psum; view positions agree with the owning tile's positions.
* **never-drop** (:func:`verify_never_drop`): global/sink steps and
  causal-local tiles are all inside the always-keep mask, the worst-case
  always count fits the table width (a feasible keep budget exists),
  ``check_keep`` accepts it and rejects one less, and an adversarial
  top-k simulation (content maximally against the protected tiles)
  still keeps every protected step.
* **chunk** (:func:`verify_chunk`): each prefill chunk slice covers,
  exactly once, every causally attended (query position, cached/chunk
  key position) pair; every attended key position is actually present
  in the ``[sink | ring | chunk]`` view (the ring never evicts a key
  the pattern still needs); the per-shard chunk tables reconstruct the
  unsharded chunk walk with each view tile on exactly one shard.

Failures come back as :class:`repro_torch.analysis.Finding` values naming the
offending (q-block, kv-block) tile.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.analysis import Finding
from repro_torch.core.plan_contract import (PAD_SENTINEL, STEP_GLOBAL,
                                            STEP_WINDOW, VALID_FLAGS,
                                            iter_real_steps)
from repro_torch.core.scheduler import (BandSchedule, ChunkPlan,
                                        ExecutionPlan, PackedTransposedPlan,
                                        TransposedPlan)

Visit = Tuple[int, int, int]           # (q_block, kv_tile, flags)
VisitCounter = Counter                 # Counter[Visit]


# ---------------------------------------------------------------------- #
# Independent numpy mask references (NOT the jnp step_mask the engines run)
# ---------------------------------------------------------------------- #
def _np_window(sched: BandSchedule, pi: np.ndarray,
               pj: np.ndarray) -> np.ndarray:
    p = sched.pattern
    pi = pi.astype(np.int64)
    pj = pj.astype(np.int64)
    ok = (pi < sched.n) & (pj < sched.n)
    if p.is_2d:
        g = p.n_global
        _, w = p.grid2d
        wh, ww = p.window2d
        yi, xi = (pi - g) // w, (pi - g) % w
        yj, xj = (pj - g) // w, (pj - g) % w
        m = (np.abs(yj - yi) <= wh // 2) & (np.abs(xj - xi) <= ww // 2)
        m = m & (pi >= g) & (pj >= g)
    else:
        a, b = p.window
        rel = pj - pi
        m = (rel >= a) & (rel <= b)
        if p.dilation > 1:
            m = m & (rel % p.dilation == 0)
    if sched.causal:
        m = m & (pj <= pi)
    return m & ok


def _np_step_mask(sched: BandSchedule, pi: np.ndarray, pj: np.ndarray,
                  flags: int) -> np.ndarray:
    w = _np_window(sched, pi, pj)
    m = w & bool(flags & STEP_WINDOW)
    if sched.n_global > 0:
        gcol = (pj.astype(np.int64) < sched.n_global) \
            & (pi.astype(np.int64) < sched.n) & ~w
        if sched.causal:
            gcol = gcol & (pj.astype(np.int64) <= pi.astype(np.int64))
        m = m | (gcol & bool(flags & STEP_GLOBAL))
    return m


def _np_causal_union(pattern, qp: np.ndarray, kp: np.ndarray,
                     flags: int) -> np.ndarray:
    """Serving-side reference of ``causal_step_mask`` (original positions,
    causal window ∪ global column, flag-gated) in pure numpy."""
    qp = qp.astype(np.int64)
    kp = kp.astype(np.int64)
    a, b = pattern.window
    rel = kp - qp
    w = (rel >= a) & (rel <= min(b, 0))
    if pattern.dilation > 1:
        w = w & (rel % pattern.dilation == 0)
    m = w & bool(flags & STEP_WINDOW)
    if pattern.n_global > 0:
        m = m | ((kp < pattern.n_global) & bool(flags & STEP_GLOBAL))
    return m & (kp <= qp) & (qp < PAD_SENTINEL) & (kp < PAD_SENTINEL)


# ---------------------------------------------------------------------- #
# Visit multisets
# ---------------------------------------------------------------------- #
def forward_visits(plan: ExecutionPlan) -> VisitCounter:
    """The forward walk as a ``(q_block, kv_tile, flags)`` multiset."""
    return Counter((i, t, f)
                   for i, _s, t, f in iter_real_steps(plan.kv_blocks,
                                                      plan.flags))


def _diff_visits(fwd: VisitCounter, other: VisitCounter, pass_name: str,
                 target: str, other_name: str) -> List[Finding]:
    out: List[Finding] = []
    for (i, t, f), c in sorted((fwd - other).items()):
        out.append(Finding(
            pass_name, target,
            f"{other_name} drops {c} forward visit(s) of q_block {i} x "
            f"kv_block {t} (flags {f})", q_block=i, kv_block=t))
    for (i, t, f), c in sorted((other - fwd).items()):
        out.append(Finding(
            pass_name, target,
            f"{other_name} invents {c} visit(s) of q_block {i} x "
            f"kv_block {t} (flags {f}) absent from the forward walk",
            q_block=i, kv_block=t))
    return out


# ---------------------------------------------------------------------- #
# 1. Coverage
# ---------------------------------------------------------------------- #
def verify_coverage(plan: ExecutionPlan, target: str = "") -> List[Finding]:
    """Prove exact tile coverage of the forward tables (see module doc)."""
    findings: List[Finding] = []
    sched = plan.sched
    bq, bk = plan.block_q, plan.block_k
    pos = plan.positions_padded().astype(np.int64)
    pos_q = pos.reshape(plan.nq, bq)
    pos_k = pos.reshape(plan.nkb, bk)

    count = np.zeros((plan.n_pad, plan.n_pad), dtype=np.int32)
    for i, _s, t, f in iter_real_steps(plan.kv_blocks, plan.flags):
        if f & ~VALID_FLAGS:
            findings.append(Finding(
                "coverage", target,
                f"step of q_block {i} carries unknown flag bits {f}",
                q_block=i, kv_block=t))
            continue
        sub = _np_step_mask(sched, pos_q[i][:, None], pos_k[t][None, :], f)
        count[i * bq:(i + 1) * bq, t * bk:(t + 1) * bk] += sub

    expected = _np_step_mask(sched, pos[:, None], pos[None, :], VALID_FLAGS)

    dbl = count > 1
    if dbl.any():
        wi, wj = (int(x) for x in np.argwhere(dbl)[0])
        findings.append(Finding(
            "coverage", target,
            f"pair (working {wi}, {wj}) = original "
            f"({int(pos[wi])}, {int(pos[wj])}) is double-counted across "
            f"fused steps ({int(count[wi, wj])} visits)",
            q_block=wi // bq, kv_block=wj // bk))
    miss = expected & (count == 0)
    if miss.any():
        wi, wj = (int(x) for x in np.argwhere(miss)[0])
        findings.append(Finding(
            "coverage", target,
            f"attended pair (working {wi}, {wj}) = original "
            f"({int(pos[wi])}, {int(pos[wj])}) is missing from every step",
            q_block=wi // bq, kv_block=wj // bk))
    extra = (count > 0) & ~expected
    if extra.any():
        wi, wj = (int(x) for x in np.argwhere(extra)[0])
        findings.append(Finding(
            "coverage", target,
            f"unattended pair (working {wi}, {wj}) is covered by a step",
            q_block=wi // bq, kv_block=wj // bk))

    # Cross-check against the dense pattern oracle on ORIGINAL positions.
    n, g = sched.n, sched.n_global
    valid = pos < n
    vp = pos[valid].astype(np.int64)
    cov = np.zeros((n, n), dtype=bool)
    cov[vp[:, None], vp[None, :]] = (count > 0)[np.ix_(valid, valid)]
    oracle = sched.pattern.mask(n)
    rowsel = np.ones(n, dtype=bool)
    if g > 0 and sched.global_rows:
        rowsel[:g] = False          # dense-epilogue rows: not the plan's job
    mismatch = (cov != oracle) & rowsel[:, None]
    if mismatch.any():
        oi, oj = (int(x) for x in np.argwhere(mismatch)[0])
        inv = sched.inverse_perm()
        wi = int(inv[oi]) if inv is not None else oi
        wj = int(inv[oj]) if inv is not None else oj
        what = "missing from" if oracle[oi, oj] else "not in the pattern yet"
        findings.append(Finding(
            "coverage", target,
            f"plan coverage disagrees with pattern.mask at original pair "
            f"({oi}, {oj}): pair {what} the plan walk",
            q_block=wi // bq, kv_block=wj // bk))
    return findings


# ---------------------------------------------------------------------- #
# 2. Adjoint
# ---------------------------------------------------------------------- #
def verify_transposed(plan: ExecutionPlan,
                      tp: Optional[TransposedPlan] = None,
                      target: str = "") -> List[Finding]:
    """Prove the transposed tables are an exact permutation of the forward
    walk (adjoint soundness of the dK/dV schedule)."""
    tp = plan.transposed() if tp is None else tp
    got: VisitCounter = Counter(
        (qb, j, f) for j, _s, qb, f in iter_real_steps(tp.q_blocks, tp.flags))
    return _diff_visits(forward_visits(plan), got, "adjoint", target,
                        "transposed walk")


def verify_packed(plan: ExecutionPlan,
                  pk: Optional[PackedTransposedPlan] = None,
                  target: str = "") -> List[Finding]:
    """Same proof for the packed layout: rows map through ``row_tile``."""
    pk = plan.transposed_packed() if pk is None else pk
    got: VisitCounter = Counter(
        (qb, int(pk.row_tile[r]), f)
        for r, _s, qb, f in iter_real_steps(pk.q_blocks, pk.flags))
    return _diff_visits(forward_visits(plan), got, "adjoint", target,
                        "packed transposed walk")


# ---------------------------------------------------------------------- #
# 3. Shard-exchange soundness
# ---------------------------------------------------------------------- #
def verify_sharded(plan: ExecutionPlan, n_shards: int, sp=None,
                   target: str = "") -> List[Finding]:
    """Prove a ShardedPlan reconstructs the unsharded tile set exactly and
    that its ppermute/psum exchange schedule delivers every referenced
    halo/global view slot (see module doc)."""
    from repro_torch.dist.sharded_plan import shard_plan
    sp = shard_plan(plan, n_shards) if sp is None else sp
    findings: List[Finding] = []
    nkb_l, nq_l = sp.nkb_l, sp.nq_l
    vm = np.asarray(sp.view_map)

    # Local view region must be the shard's own tiles, in order.
    for s in range(sp.n_shards):
        want = np.arange(s * nkb_l, (s + 1) * nkb_l)
        if not np.array_equal(vm[s, :nkb_l], want):
            t = int(np.nonzero(vm[s, :nkb_l] != want)[0][0])
            findings.append(Finding(
                "exchange", target,
                f"shard {s} local view slot {t} maps to tile "
                f"{int(vm[s, t])}, expected {int(want[t])}",
                kv_block=int(want[t])))

    # View positions must agree with the mapped tile's positions.
    pos_t = plan.positions_padded().reshape(plan.nkb, plan.block_k)
    for s in range(sp.n_shards):
        for vt in range(sp.view_tiles):
            gt = int(vm[s, vt])
            if gt >= 0:
                if not np.array_equal(sp.pos_k[s, vt], pos_t[gt]):
                    findings.append(Finding(
                        "exchange", target,
                        f"shard {s} view slot {vt} positions disagree with "
                        f"tile {gt}'s positions", kv_block=gt))
            elif not (sp.pos_k[s, vt] == PAD_SENTINEL).all():
                findings.append(Finding(
                    "exchange", target,
                    f"shard {s} padded view slot {vt} carries non-sentinel "
                    f"positions", kv_block=vt))

    # The per-shard tables, remapped to global tiles, must reconstruct the
    # unsharded visit multiset exactly.
    got: VisitCounter = Counter()
    for s in range(sp.n_shards):
        for i_l, _st, vt, f in iter_real_steps(sp.tables[s], sp.flags[s]):
            gt = int(vm[s, vt]) if 0 <= vt < sp.view_tiles else -1
            if gt < 0:
                findings.append(Finding(
                    "exchange", target,
                    f"shard {s} row {i_l} references view slot {vt}, which "
                    f"no exchange ever fills",
                    q_block=s * nq_l + i_l, kv_block=vt))
                continue
            got[(s * nq_l + i_l, gt, f)] += 1
    findings += _diff_visits(forward_visits(plan), got, "exchange", target,
                             f"{sp.n_shards}-shard reconstruction")

    # Every halo view slot's owner must sit at the group's distance and be
    # scheduled to send exactly that tile on that hop.
    off = nkb_l
    for d_i, (delta, T) in enumerate(zip(sp.halo_dists, sp.halo_counts)):
        send = np.asarray(sp.send_idx[d_i])
        for s in range(sp.n_shards):
            for slot in range(T):
                gt = int(vm[s, off + slot])
                if gt < 0:
                    continue
                owner = gt // nkb_l
                if owner != s + delta:
                    findings.append(Finding(
                        "exchange", target,
                        f"shard {s} halo slot {slot} (distance {delta}) "
                        f"holds tile {gt} owned by shard {owner} — owner "
                        f"distance {owner - s} has no hop in this group",
                        kv_block=gt))
                elif int(send[owner, slot]) != gt - owner * nkb_l:
                    findings.append(Finding(
                        "exchange", target,
                        f"no scheduled ppermute hop delivers tile {gt} to "
                        f"shard {s}: owner {owner} sends local tile "
                        f"{int(send[owner, slot])} on distance-{delta} "
                        f"slot {slot}, expected {gt - owner * nkb_l}",
                        kv_block=gt))
        off += T

    # Global slots: exactly one owner feeding the masked psum, the owner's
    # local index correct, and the slot mapped identically on every shard.
    g_base = sp.view_tiles - sp.n_gt
    for gi, t in enumerate(sp.gtiles):
        owners = np.nonzero(np.asarray(sp.g_owned)[:, gi])[0]
        if owners.size != 1:
            findings.append(Finding(
                "exchange", target,
                f"global tile {t} has {owners.size} psum owners "
                f"(exactly 1 required)", kv_block=int(t)))
            continue
        o = int(owners[0])
        if o != t // nkb_l or int(sp.g_owner_idx[o, gi]) != t - o * nkb_l:
            findings.append(Finding(
                "exchange", target,
                f"global tile {t} claimed by shard {o} local "
                f"{int(sp.g_owner_idx[o, gi])}, expected shard "
                f"{t // nkb_l} local {t % nkb_l}", kv_block=int(t)))
        for s in range(sp.n_shards):
            if int(vm[s, g_base + gi]) != t:
                findings.append(Finding(
                    "exchange", target,
                    f"shard {s} global slot {gi} maps to tile "
                    f"{int(vm[s, g_base + gi])}, expected {t}",
                    kv_block=int(t)))

    # Per-shard packed transposed tables: the dK/dV walk over the view must
    # also be the exact adjoint of the unsharded forward.
    tgot: VisitCounter = Counter()
    for s in range(sp.n_shards):
        for r, _st, qb, f in iter_real_steps(sp.t_q_blocks[s],
                                             sp.t_flags[s]):
            vt = int(sp.t_row_tile[s, r])
            gt = int(vm[s, vt]) if 0 <= vt < sp.view_tiles else -1
            if gt < 0:
                findings.append(Finding(
                    "exchange", target,
                    f"shard {s} packed dK/dV row {r} accumulates into "
                    f"unfilled view slot {vt}", kv_block=vt))
                continue
            tgot[(s * nq_l + qb, gt, f)] += 1
    findings += _diff_visits(forward_visits(plan), tgot, "exchange", target,
                             f"{sp.n_shards}-shard packed dK/dV walk")
    return findings


# ---------------------------------------------------------------------- #
# 4. Never-drop
# ---------------------------------------------------------------------- #
def verify_never_drop(plan: ExecutionPlan,
                      local_window: Optional[int] = None,
                      target: str = "", seeds: int = 3) -> List[Finding]:
    """Prove the dynamic never-drop invariant for this plan's candidate
    tables (see module doc)."""
    from repro_torch.core.dynamic import check_keep, plan_always_keep
    findings: List[Finding] = []
    lw = int(local_window) if local_window is not None \
        else max(plan.block_q, plan.block_k)
    always = np.asarray(plan_always_keep(plan, lw))

    pos = plan.positions_padded().astype(np.int64)
    pos_q = pos.reshape(plan.nq, plan.block_q)
    pos_k = pos.reshape(plan.nkb, plan.block_k)
    vq, vk = pos_q < PAD_SENTINEL, pos_k < PAD_SENTINEL

    for i, s, t, f in iter_real_steps(plan.kv_blocks, plan.flags):
        if (f & STEP_GLOBAL) and not always[i, s]:
            findings.append(Finding(
                "never-drop", target,
                f"global/sink step (q_block {i}, kv_block {t}) is "
                f"droppable under a tight keep budget",
                q_block=i, kv_block=t))
            continue
        if not (vq[i].any() and vk[t].any()):
            continue
        qlo, qhi = int(pos_q[i][vq[i]].min()), int(pos_q[i][vq[i]].max())
        tlo, thi = int(pos_k[t][vk[t]].min()), int(pos_k[t][vk[t]].max())
        reach = qhi if plan.sched.causal else qhi + lw
        if thi >= qlo - lw and tlo <= reach and not always[i, s]:
            findings.append(Finding(
                "never-drop", target,
                f"causal-local tile (q_block {i}, kv_block {t}; positions "
                f"[{tlo}, {thi}] vs row [{qlo}, {qhi}]) is droppable",
                q_block=i, kv_block=t))
    if (always & (np.asarray(plan.flags) == 0)).any():
        i, s = (int(x) for x in
                np.argwhere(always & (np.asarray(plan.flags) == 0))[0])
        findings.append(Finding(
            "never-drop", target,
            f"padding step (row {i}, step {s}) marked always-keep",
            q_block=i))

    need = int(always.sum(axis=1).max()) if always.size else 0
    if need > plan.max_steps:
        findings.append(Finding(
            "never-drop", target,
            f"worst-case always-kept count {need} exceeds the table width "
            f"{plan.max_steps}: no feasible keep budget exists"))
        return findings
    try:
        check_keep(need, always)
    except ValueError:
        findings.append(Finding(
            "never-drop", target,
            f"check_keep rejects the provably sufficient budget {need}"))
    if need > 0:
        try:
            check_keep(need - 1, always)
            findings.append(Finding(
                "never-drop", target,
                f"check_keep accepts keep={need - 1}, one below the "
                f"worst-case always-kept count {need}"))
        except ValueError:
            pass

        # Adversarial selection: content scores maximally against the
        # protected set must still keep every protected step at keep=need.
        rng = np.random.default_rng(0)
        flags = np.asarray(plan.flags)
        for _ in range(seeds):
            score = rng.standard_normal(always.shape)
            score = np.where(always, np.inf, score)
            score = np.where(flags != 0, score, -np.inf)
            kept = np.zeros_like(always)
            top = np.argpartition(-score, need - 1, axis=1)[:, :need]
            np.put_along_axis(kept, top, True, axis=1)
            dropped = always & ~kept
            if dropped.any():
                i, s = (int(x) for x in np.argwhere(dropped)[0])
                findings.append(Finding(
                    "never-drop", target,
                    f"adversarial top-k at keep={need} drops protected "
                    f"step (q_block {i}, kv_block "
                    f"{int(plan.kv_blocks[i, s])})",
                    q_block=i, kv_block=int(plan.kv_blocks[i, s])))
                break
    return findings


# ---------------------------------------------------------------------- #
# 5. ChunkPlan prefill slices
# ---------------------------------------------------------------------- #
def verify_chunk(cp: ChunkPlan, target: str = "",
                 n_shards: Tuple[int, ...] = ()) -> List[Finding]:
    """Prove one prefill chunk slice covers its causal pair set exactly
    once over a view that actually holds every needed key (module doc)."""
    findings: List[Finding] = []
    pat = cp.pattern
    c0, c1 = cp.chunk_start, cp.chunk_start + cp.chunk_len
    vpos = cp.view_positions.astype(np.int64)
    block = cp.block

    live = vpos[vpos < PAD_SENTINEL]
    if np.unique(live).size != live.size:
        dup = int(live[np.argwhere(
            np.diff(np.sort(live)) == 0)[0][0] + 1])
        findings.append(Finding(
            "chunk", target,
            f"view holds position {dup} in more than one slot"))

    # Query positions per chunk row (PAD beyond the chunk length).
    qpos = np.full(cp.chunk_pad, PAD_SENTINEL, dtype=np.int64)
    qpos[: cp.chunk_len] = np.arange(c0, c1)

    count = np.zeros((cp.chunk_pad, cp.view_len), dtype=np.int32)
    for i, _s, t, f in iter_real_steps(cp.kv_blocks, cp.flags):
        qp = qpos[i * block:(i + 1) * block]
        kp = vpos[t * block:(t + 1) * block]
        sub = _np_causal_union(pat, qp[:, None], kp[None, :], f)
        count[i * block:(i + 1) * block,
              t * block:(t + 1) * block] += sub
    expected = _np_causal_union(pat, qpos[:, None], vpos[None, :],
                                VALID_FLAGS)
    dbl = count > 1
    if dbl.any():
        qi, vj = (int(x) for x in np.argwhere(dbl)[0])
        findings.append(Finding(
            "chunk", target,
            f"chunk [{c0},{c1}) double-counts pair (query {int(qpos[qi])}, "
            f"key {int(vpos[vj])})", q_block=qi // block,
            kv_block=vj // block))
    miss = expected & (count == 0)
    if miss.any():
        qi, vj = (int(x) for x in np.argwhere(miss)[0])
        findings.append(Finding(
            "chunk", target,
            f"chunk [{c0},{c1}) misses attended pair (query "
            f"{int(qpos[qi])}, key {int(vpos[vj])})",
            q_block=qi // block, kv_block=vj // block))

    # View completeness: every key position the pattern attends from any
    # chunk query must be resident in [sink | ring | chunk].
    present = set(int(p) for p in live)
    oracle = pat.mask(c1)
    for q in range(c0, c1):
        needed = np.nonzero(oracle[q, : q + 1])[0]
        for kpos in needed:
            if int(kpos) not in present:
                inv_row = (q - c0) // block
                findings.append(Finding(
                    "chunk", target,
                    f"view under-provisioned for chunk [{c0},{c1}): query "
                    f"{q} attends key {int(kpos)}, which no sink/ring/"
                    f"chunk slot holds", q_block=inv_row))
                break
        else:
            continue
        break

    # Sharded chunk tables: union must reconstruct the unsharded walk with
    # every (row, view tile) step on exactly one shard.
    ctx_tiles = (cp.n_sink + cp.ring_cap) // block
    base: VisitCounter = Counter(
        (i, t, f) for i, _s, t, f in iter_real_steps(cp.kv_blocks, cp.flags))
    for S in n_shards:
        if ctx_tiles % S:
            continue
        tps = ctx_tiles // S
        kv, fl = cp.sharded_tables(S, cp.nq, cp.max_steps + tps)
        got: VisitCounter = Counter()
        for s in range(S):
            for i, _st, lt, f in iter_real_steps(kv[s], fl[s]):
                gt = s * tps + lt if lt < tps else ctx_tiles + (lt - tps)
                got[(i, gt, f)] += 1
        findings += _diff_visits(base, got, "chunk", target,
                                 f"{S}-shard chunk [{c0},{c1}) tables")
    return findings


# ---------------------------------------------------------------------- #
# 6. Dynamic full-keep replay (runtime, tiny)
# ---------------------------------------------------------------------- #
def verify_dynamic_full_keep(plan: ExecutionPlan,
                             target: str = "") -> List[Finding]:
    """A full keep budget must reproduce the static walk step-for-step —
    the machinery-off invariant, replayed on random content."""
    import torch

    from repro_torch.core.dynamic import DynamicConfig, dynamic_tables
    rng = np.random.default_rng(7)
    n, d = plan.sched.n, 16
    q = rng.standard_normal((1, n, d)).astype(np.float32)
    k = rng.standard_normal((1, n, d)).astype(np.float32)
    _plan, kvt, flg, _always = dynamic_tables(
        torch.from_numpy(q), torch.from_numpy(k), plan.sched.pattern,
        DynamicConfig(keep=plan.max_steps), block_q=plan.block_q,
        block_k=plan.block_k)
    kvt, flg = kvt.cpu().numpy(), flg.cpu().numpy()
    if not (np.array_equal(kvt, plan.kv_blocks)
            and np.array_equal(flg, plan.flags)):
        bad = np.argwhere((kvt != plan.kv_blocks) | (flg != plan.flags))
        i, s = (int(x) for x in bad[0])
        return [Finding(
            "dynamic-full-keep", target,
            f"full-keep selection diverges from the static walk at row {i} "
            f"step {s}: got (tile {int(kvt[i, s])}, flags {int(flg[i, s])})"
            f", static (tile {int(plan.kv_blocks[i, s])}, flags "
            f"{int(plan.flags[i, s])})",
            q_block=i, kv_block=int(plan.kv_blocks[i, s]))]
    return []


# ---------------------------------------------------------------------- #
# All proofs of one plan (what the CLI gate runs)
# ---------------------------------------------------------------------- #
def verify_plan(plan: ExecutionPlan, target: str = "",
                n_shards: Tuple[int, ...] = (),
                never_drop: bool = False,
                local_window: Optional[int] = None) -> List[Finding]:
    """All static proofs for one plan: coverage, adjoint (transposed and
    packed), per-shard exchange soundness, and optionally never-drop."""
    findings = verify_coverage(plan, target)
    findings += verify_transposed(plan, target=target)
    findings += verify_packed(plan, target=target)
    for S in n_shards:
        if plan.nq % S == 0 and plan.nkb % S == 0:
            findings += verify_sharded(plan, S, target=f"{target}@{S}shards")
        else:
            findings.append(Finding(
                "exchange", target,
                f"plan grid ({plan.nq}, {plan.nkb}) not divisible by "
                f"{S} shards — build with pad_multiple", severity="warn"))
    if never_drop:
        findings += verify_never_drop(plan, local_window, target=target)
    return findings


def verify_stats(findings: List[Finding]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for f in findings:
        out[f.pass_name] = out.get(f.pass_name, 0) + 1
    return out
