"""Sequence-parallel serving of the port (``seq_shards > 1``) against the
JAX package, on the CPU.

* The sharded layout, the per-shard chunk tables and the decode write
  routing are bit-equal to the reference's functions.
* ``masked_psum_merge`` over a 4-rank gloo group and over a
  ``StackedGroup`` agrees with the reference's under ``jax.vmap(...,
  axis_name="seq")`` within 1e-6 (f32), rows empty on every shard and on
  some shards included.
* The engine at ``seq_shards`` 2 and 4 (gloo ranks on the CPU) gives
  greedy tokens IDENTICAL to the port's unsharded engine and to JAX's
  single-device engine on the reference's sharded cases, its per-shard
  pools end fully freed, and every rank sees bitwise-equal logits. A
  2-rank supervisor kill-and-resume gives the uninterrupted tokens, and the
  CLI at ``--seq-shards 2`` prints ``--seq-shards 1``'s.

The reference's own sharded tests need an 8-device mesh, which fails on
this JAX; the single-device JAX engine is what the port is held to, as the
reference's tests hold its sharded engine to it. The spawned ranks import
this module, so it imports JAX only inside the functions that run it.
Every test that spawns ranks has a deadline of at most 120 s.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.renorm import NEG_INF
from repro_torch.core.scheduler import build_chunk_plan
from repro_torch.core.patterns import causal_sliding_window
from repro_torch.dist.group import StackedGroup, run_ranks
from repro_torch.dist.sharded_plan import masked_psum_merge
from repro_torch.ft import FaultInjector, FaultPlan, ServeSupervisor
from repro_torch.models.layers import salo_pattern
from repro_torch.models.model import build_model
from repro_torch.serve.engine import (ContinuousConfig, ContinuousEngine,
                                     sharded_write_target)
from repro_torch.serve.paged_cache import PagedLayout, layout_for_pattern

torch.set_num_threads(2)
DEADLINE_S = 120.0
MERGE_TOL = 1e-6          # f32 merge; the reductions sum in other orders

# The reference's sharded cases (tests/test_distributed.py, the
# sequence-parallel serving section, and tests/test_serve_quant.py's
# sharded int8 case): salo overrides, compute dtype, prompt lengths, new
# tokens, engine rows, extra ContinuousConfig fields, parameter seed.
CASES = {
    "ragged_recycling": dict(lens=(5, 11, 7, 9, 6), n_new=4, max_batch=2),
    "bf16": dict(lens=(9, 14), n_new=6, max_batch=2, seed=2,
                 dtype="bfloat16"),
    "ring_wrap_w8": dict(lens=(21, 6), n_new=40, max_batch=2,
                         salo=dict(window=8)),
    "dilated_w4_g2": dict(lens=(11, 17), n_new=10, max_batch=2,
                          salo=dict(window=4, dilation=2, n_global=2)),
    "int8_page_sparse": dict(lens=(24, 17, 9, 30), n_new=8, max_batch=4,
                             seed=0, extra=dict(kv_dtype="int8",
                                                page_sparsity_threshold=-0.5,
                                                page_stat_decay=0.3)),
    # window 24: 4 pages a request, which stripe over 2 and 4 shards with
    # no alignment padding, so the page counters must be equal too
    "int8_page_sparse_w24": dict(lens=(24, 17, 9, 30), n_new=8,
                                 max_batch=4, seed=0, salo=dict(window=24),
                                 extra=dict(kv_dtype="int8",
                                            page_sparsity_threshold=-0.5,
                                            page_stat_decay=0.3)),
}
PAGE_KEYS = ("decode_pages_read", "decode_pages_total", "prefill_pages_read",
             "prefill_pages_total")
KILL_LENS, KILL_NEW = (5, 11, 7, 9), 6


def _cfg(case, module="torch"):
    if module == "torch":
        cfg = get_smoke("smollm-135m")
    else:
        from repro.configs import get_smoke as j_smoke
        cfg = j_smoke("smollm-135m")
    if case.get("salo"):
        cfg = dataclasses.replace(cfg, salo=dataclasses.replace(
            cfg.salo, **case["salo"]))
    if case.get("dtype"):
        cfg = dataclasses.replace(cfg, compute_dtype=case["dtype"])
    return cfg


def _amplify(jparams, gain=6.0):
    """Scale the residual branches' output projections: at the plain init
    the tied embedding dominates and greedy decoding repeats the input
    token; amplified, the tokens depend on attention."""
    seg = dict(jparams["seg0_attn_mlp"])
    seg["attn"] = dict(seg["attn"], wo=seg["attn"]["wo"] * gain)
    seg["mlp"] = dict(seg["mlp"], w_out=seg["mlp"]["w_out"] * gain)
    return dict(jparams, seg0_attn_mlp=seg)


def _prompts(cfg, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
            for n in lens]


def _jax_case(case):
    """JAX's single-device engine on ``case``: (jax tokens, jax counters,
    the port's parameters converted from the same JAX parameters)."""
    import jax

    from repro.models.layers import salo_pattern as j_pattern
    from repro.models.model import build_model as j_build
    from repro.serve.engine import ContinuousConfig as JConfig
    from repro.serve.engine import ContinuousEngine as JEngine
    from repro.serve.paged_cache import layout_for_pattern as j_layout
    from repro_torch.convert import params_from_jax

    jcfg = _cfg(case, "jax")
    jmodel = j_build(jcfg)
    jparams = _amplify(jmodel.init(jax.random.PRNGKey(case.get("seed", 1))))
    lay = j_layout(j_pattern(jcfg, causal=True), 8)
    jeng = JEngine(jmodel, JConfig(
        n_pages=1 + case["max_batch"] * lay.pages_per_req, page=8, chunk=8,
        max_batch=case["max_batch"], **case.get("extra", {})))
    rids = [jeng.submit(p, case["n_new"])
            for p in _prompts(jcfg, case["lens"])]
    res = jeng.run(jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return ([np.asarray(res[r]).tolist() for r in rids],
            dict(jeng.counters), tparams)


def _serve(group, case, params):
    """The port's engine on ``case``: one device (``group`` None) or one
    rank of a sequence group. Returns tokens, counters, each shard pool's
    free pages and the logits of every decode step."""
    cfg = _cfg(case)
    S = 1 if group is None else group.size
    lay = layout_for_pattern(salo_pattern(cfg, causal=True), 8, shards=S)
    eng = ContinuousEngine(
        build_model(cfg, "cpu"),
        ContinuousConfig(n_pages=1 + case["max_batch"] * lay.pages_per_shard,
                         page=8, chunk=8, max_batch=case["max_batch"],
                         seq_shards=S, **case.get("extra", {})),
        device="cpu", group=group)
    logits = []
    decode_fn = eng._decode_fn

    def recording(*a, **k):
        lg, pm = decode_fn(*a, **k)
        logits.append(lg.float().clone())
        return lg, pm

    eng._decode_fn = recording
    rids = [eng.submit(p, case["n_new"]) for p in _prompts(cfg, case["lens"])]
    res = eng.run(params)
    return dict(tokens=[res[r].tolist() for r in rids],
                counters=dict(eng.counters),
                free=[a.n_free for a in eng.batcher.allocs],
                n_pages=eng.ccfg.n_pages,
                pages_per_req=lay.pages_per_req,
                logits=torch.stack(logits).numpy())


def _kill_resume(group, params, ckpt_dir):
    """The reference's sharded kill-and-resume case on this rank: crashes
    at steps 3 and 6, a snapshot every 2 steps, a fresh engine per boot."""
    cfg = get_smoke("smollm-135m")
    lay = layout_for_pattern(salo_pattern(cfg, causal=True), 8,
                             shards=group.size)
    model = build_model(cfg, "cpu")
    prompts = _prompts(cfg, KILL_LENS)

    def make():
        eng = ContinuousEngine(model, ContinuousConfig(
            n_pages=1 + 4 * lay.pages_per_shard, page=8, chunk=8,
            max_batch=4, seq_shards=group.size), device="cpu", group=group)
        for p in prompts:
            eng.submit(p, KILL_NEW)
        return eng

    sup = ServeSupervisor(make, params, ckpt_dir, checkpoint_every=2,
                          injector=FaultInjector(FaultPlan(
                              crash_steps=frozenset({3, 6}))), group=group)
    eng, hist = sup.run()
    res = eng.batcher.results()
    return dict(tokens=[res[r].tolist() for r in sorted(res)],
                restarts=hist["restarts"],
                max_step_loss=hist["max_step_loss"],
                free=[a.n_free for a in eng.batcher.allocs],
                n_pages=eng.ccfg.n_pages)


def _rank_body(group, cases, params, merge_parts, kill):
    """Everything one rank of a group runs, in one spawn: the merge of
    this rank's partials, every serving case, and (when ``kill`` holds a
    directory and parameters) the kill-and-resume case."""
    out = {}
    if merge_parts is not None:
        o, m, l = (torch.from_numpy(a[group.index]) for a in merge_parts)
        out["merge"] = masked_psum_merge(o, m, l, group).numpy()
    for name, case in cases.items():
        out[name] = _serve(group, case, params[name])
    if kill is not None:
        out["kill"] = _kill_resume(group, *kill)
    return out


def _merge_parts(S=4, B=3, H=2, Q=5, D=8, seed=7):
    """Per-shard (out, m, l) partials with the empty-row identity on row
    (b=0, q=0) of every shard and on rows (b=1, q<3) of shards 0 and 2."""
    rng = np.random.default_rng(seed)
    out = rng.normal(size=(S, B, H, Q, D)).astype(np.float32)
    m = rng.normal(size=(S, B, H, Q)).astype(np.float32) * 3
    l = rng.uniform(0.5, 4.0, size=(S, B, H, Q)).astype(np.float32)
    for s, b, q in [(s, 0, 0) for s in range(S)] + \
            [(s, 1, q) for s in (0, 2) for q in range(3)]:
        out[s, b, :, q] = 0.0
        m[s, b, :, q] = NEG_INF
        l[s, b, :, q] = 0.0
    return out, m, l


def _jax_merge(parts):
    import jax
    import jax.numpy as jnp

    from repro.dist.sharded_plan import masked_psum_merge as j_merge

    fn = jax.vmap(lambda o, m, l: j_merge(o, m, l, "seq"), axis_name="seq")
    return np.asarray(fn(*(jnp.asarray(a) for a in parts)))


# ------------------------------------------------------------------ #
# layout, tables, write routing: bit-equal to the reference
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_layout_matches_jax(shards):
    from repro.serve.paged_cache import PagedLayout as JLayout

    for page in (2, 4):
        kw = dict(page=page, window=8, n_global=2, dilation=2, shards=shards)
        jl, tl = JLayout(**kw), PagedLayout(**kw)
        for f in ("ring_pages", "pages_per_req", "pages_per_shard",
                  "slots_per_shard", "n_sink", "ring_cap"):
            assert getattr(tl, f) == getattr(jl, f), f
        s = np.arange(tl.slots_per_req, dtype=np.int32)
        np.testing.assert_array_equal(
            tl.slot_owner(torch.from_numpy(s)).numpy(),
            np.asarray(jl.slot_owner(s)))
        np.testing.assert_array_equal(
            tl.slot_local(torch.from_numpy(s)).numpy(),
            np.asarray(jl.slot_local(s)))
        assert tl.slot_owner(s).max() == shards - 1
        for total in range(0, 3 * tl.slots_per_req):
            assert tl.pages_needed_per_shard(total) == \
                jl.pages_needed_per_shard(total), total


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_chunk_tables_match_jax(shards):
    from repro.core.patterns import causal_sliding_window as j_window
    from repro.core.scheduler import build_chunk_plan as j_plan

    page, chunk = 4, 8
    lay = PagedLayout(page=page, window=8, n_global=2, dilation=2,
                      shards=shards)
    tpat = causal_sliding_window(8, n_sinks=2, dilation=2)
    jpat = j_window(8, n_sinks=2, dilation=2)
    ctx = lay.n_sink + lay.ring_cap
    nq, width = chunk // page, (ctx // shards + chunk) // page
    n_checked = 0
    for c0 in range(0, 60, 3):
        for clen in (1, 5, chunk):
            kw = dict(n_sink=lay.n_sink, ring_cap=lay.ring_cap, block=page,
                      chunk_pad=chunk)
            tp = build_chunk_plan(tpat, c0, clen, **kw)
            jp = j_plan(jpat, c0, clen, **kw)
            for owner in (None, 0):
                tkv, tfl = tp.sharded_tables(shards, nq, width, owner)
                jkv, jfl = jp.sharded_tables(shards, nq, width, owner)
                assert tkv.dtype == np.int32 and tfl.dtype == np.int32
                np.testing.assert_array_equal(tkv, jkv)
                np.testing.assert_array_equal(tfl, jfl)
                n_checked += int((tfl != 0).sum())
    assert n_checked > 0
    with pytest.raises(ValueError, match="not divisible"):
        build_chunk_plan(tpat, 0, 4, n_sink=4, ring_cap=8, block=4,
                         chunk_pad=8).sharded_tables(2, 2, 8)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_write_target_matches_jax(shards):
    import jax.numpy as jnp

    from repro.serve.engine import sharded_write_target as j_target
    from repro.serve.paged_cache import PagedLayout as JLayout

    kw = dict(page=4, window=8, n_global=2, dilation=2, shards=shards)
    jl, tl = JLayout(**kw), PagedLayout(**kw)
    rng = np.random.default_rng(shards)
    R = 7
    pt = rng.integers(1, 50, (R, tl.pages_per_shard)).astype(np.int32)
    t = rng.integers(0, 200, R).astype(np.int32)
    active = rng.random(R) < 0.7
    for idx in range(shards):
        got = sharded_write_target(tl, torch.from_numpy(pt),
                                   torch.from_numpy(t),
                                   torch.from_numpy(active), idx)
        want = j_target(jl, jnp.asarray(pt), jnp.asarray(t),
                        jnp.asarray(active), idx)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_single_shard_write_target_is_write_target():
    lay = PagedLayout(page=4, window=8, n_global=2, dilation=2)
    rng = np.random.default_rng(0)
    pt = torch.from_numpy(rng.integers(1, 50, (5, lay.pages_per_req))
                          .astype(np.int32))
    t = torch.from_numpy(rng.integers(0, 200, 5).astype(np.int32))
    active = torch.tensor([True, False, True, True, False])
    keep, _, phys, off = sharded_write_target(lay, pt, t, active, 0)
    want = lay.write_target(pt, t, keep=active)
    assert torch.equal(keep, active)
    assert torch.equal(phys, want[0]) and torch.equal(off, want[1])


@pytest.mark.parametrize("shards", [2, 4])
def test_chunk_attention_state_per_shard_matches_jax(shards):
    """Each shard's chunked-prefill partial (``return_state``) on its local
    view ``[owned ctx tiles | chunk]`` under its sharded tables equals
    JAX's within 1e-5 (f32; rows with no step on a shard carry the (0,
    NEG_INF, 0) identity), and the shards' partials merged equal the
    unsharded chunk attention within 1e-5."""
    import jax.numpy as jnp

    from repro.core.attention import hybrid_chunk_attention as j_chunk
    from repro.core.patterns import causal_sliding_window as j_window
    from repro_torch.core.attention import hybrid_chunk_attention
    from repro_torch.core.scheduler import ring_view_positions

    page, chunk, H, Hkv, D = 4, 8, 4, 2, 16
    lay = PagedLayout(page=page, window=8, n_global=2, dilation=2,
                      shards=shards)
    tpat = causal_sliding_window(8, n_sinks=2, dilation=2)
    jpat = j_window(8, n_sinks=2, dilation=2)
    ctx = lay.n_sink + lay.ring_cap
    nq, width = chunk // page, (ctx // shards + chunk) // page
    rng = np.random.default_rng(shards)
    q = rng.normal(size=(1, H, chunk, D)).astype(np.float32)
    k = rng.normal(size=(1, Hkv, ctx + chunk, D)).astype(np.float32)
    v = rng.normal(size=(1, Hkv, ctx + chunk, D)).astype(np.float32)
    sps = lay.slots_per_shard
    n_empty = 0
    # a chunk deep in the ring (chunk on the last shard), and one at the
    # start with the chunk on shard 0: the other shards hold no step
    for c0, clen, owner in ((37, 6, None), (3, 5, 0)):
        plan = build_chunk_plan(tpat, c0, clen, n_sink=lay.n_sink,
                                ring_cap=lay.ring_cap, block=page,
                                chunk_pad=chunk)
        kv, fl = plan.sharded_tables(shards, nq, width, owner)
        pos_q = np.full((1, chunk), 2 ** 30, np.int32)
        pos_q[0, :clen] = np.arange(c0, c0 + clen)
        pos_k = np.concatenate([ring_view_positions(
            c0, lay.n_sink, lay.ring_cap, 2)[None], pos_q], axis=1)
        parts = []
        for s in range(shards):
            sel = np.r_[s * sps:(s + 1) * sps, ctx:ctx + chunk]
            args = (q, k[:, :, sel], v[:, :, sel], pos_q, pos_k[:, sel],
                    kv[s], fl[s])
            got = hybrid_chunk_attention(*(torch.from_numpy(
                np.ascontiguousarray(a)) for a in args), tpat,
                return_state=True)
            want = j_chunk(*(jnp.asarray(a) for a in args), jpat,
                           return_state=True)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-5, atol=1e-5)
            n_empty += int((got[1] <= NEG_INF / 2).sum())
            parts.append(got)
        merged = masked_psum_merge(
            *(torch.stack([p[i] for p in parts]) for i in range(3)),
            StackedGroup(shards))[0]
        kv1, fl1 = plan.padded_tables(nq, (ctx + chunk) // page)
        whole = hybrid_chunk_attention(
            *(torch.from_numpy(a) for a in (q, k, v, pos_q, pos_k, kv1,
                                            fl1)), tpat)
        np.testing.assert_allclose(merged.numpy()[:, :, :clen],
                                   whole.numpy()[:, :, :clen], rtol=1e-5,
                                   atol=1e-5)
    assert n_empty > 0


# ------------------------------------------------------------------ #
# the merge
# ------------------------------------------------------------------ #
def test_masked_psum_merge_stacked_matches_jax():
    parts = _merge_parts()
    got = masked_psum_merge(*(torch.from_numpy(a) for a in parts),
                            StackedGroup(parts[0].shape[0]))
    want = _jax_merge(parts)
    np.testing.assert_allclose(got.numpy(), want, rtol=MERGE_TOL,
                               atol=MERGE_TOL)
    # the row empty on every shard merges to 0; the rows empty on two
    # shards take the other shards' weights only
    assert (got.numpy()[:, 0, :, 0] == 0).all()
    assert np.isfinite(got.numpy()).all()


def test_stacked_group_rejects_a_missing_shard_axis():
    with pytest.raises(ValueError, match="leads with"):
        StackedGroup(4).psum_(torch.zeros(3, 2))


# ------------------------------------------------------------------ #
# the engine on gloo ranks
# ------------------------------------------------------------------ #
@pytest.fixture(scope="module")
def refs():
    """Per case: the JAX engine's tokens and counters, the port's
    parameters and its unsharded engine's run."""
    out = {}
    for name, case in CASES.items():
        jt, jc, tparams = _jax_case(case)
        out[name] = dict(jax_tokens=jt, jax_counters=jc, params=tparams,
                         port=_serve(None, case, tparams))
    return out


@pytest.fixture(scope="module")
def kill_ref():
    """JAX's uninterrupted single-device run of the kill-and-resume case
    (the reference's plain init from PRNGKey(1)) and the port's
    parameters."""
    import jax

    from repro.configs import get_smoke as j_smoke
    from repro.models.layers import salo_pattern as j_pattern
    from repro.models.model import build_model as j_build
    from repro.serve.engine import ContinuousConfig as JConfig
    from repro.serve.engine import ContinuousEngine as JEngine
    from repro.serve.paged_cache import layout_for_pattern as j_layout
    from repro_torch.convert import params_from_jax

    jcfg = j_smoke("smollm-135m")
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    lay = j_layout(j_pattern(jcfg, causal=True), 8)
    jeng = JEngine(jmodel, JConfig(n_pages=1 + 4 * lay.pages_per_req,
                                   page=8, chunk=8, max_batch=4))
    rids = [jeng.submit(p, KILL_NEW) for p in _prompts(jcfg, KILL_LENS)]
    res = jeng.run(jparams)
    return ([np.asarray(res[r]).tolist() for r in rids],
            params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"))


@pytest.fixture(scope="module")
def ranks(refs, kill_ref, tmp_path_factory):
    """One spawn per group size runs every case on every rank: S=2 also
    the kill-and-resume case, S=4 also the merge."""
    params = {name: r["params"] for name, r in refs.items()}
    ckpt = tmp_path_factory.mktemp("sharded-snapshots")
    out = {}
    for S in (2, 4):
        kill = (kill_ref[1], str(ckpt)) if S == 2 else None
        merge = _merge_parts(S=4) if S == 4 else None
        out[S] = run_ranks(_rank_body, S, backend="gloo", device="cpu",
                           timeout_s=DEADLINE_S,
                           args=(CASES, params, merge, kill))
    out["ckpt"] = ckpt
    return out


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_tokens_equal_port_and_jax(ranks, refs, name, S):
    """Tolerance: exact greedy token ids, on every rank."""
    ref = refs[name]
    assert ref["port"]["tokens"] == ref["jax_tokens"]
    for r, res in enumerate(ranks[S]):
        assert res[name]["tokens"] == ref["port"]["tokens"], (name, S, r)
    assert len({x for t in ref["jax_tokens"] for x in t}) > 1


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_counters(ranks, refs, name, S):
    """Every counter is the same on every rank. The launch, token and step
    counters equal the unsharded engine's; so do the page counters where
    the layout needs no shard-alignment padding (the w24 case). Elsewhere
    the shard-aligned layout has more pages a request (its padding pages
    are never written), so the page totals differ by exactly that ratio."""
    res = [r[name] for r in ranks[S]]
    one = refs[name]["port"]
    assert all(r["counters"] == res[0]["counters"] for r in res)
    got, want = res[0]["counters"], one["counters"]
    for key in set(want) - set(PAGE_KEYS):
        assert got[key] == want[key], key
    if res[0]["pages_per_req"] == one["pages_per_req"]:
        assert got == want
    else:
        for key in ("decode_pages_total", "prefill_pages_total"):
            assert got[key] * one["pages_per_req"] == \
                want[key] * res[0]["pages_per_req"], key
    if "page_sparsity_threshold" in CASES[name].get("extra", {}):
        # pages really skipped, on both sides
        assert 0 < got["decode_pages_read"] < got["decode_pages_total"]
        assert 0 < want["decode_pages_read"] < want["decode_pages_total"]


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_pools_freed_and_logits_bitwise_equal(ranks, S):
    for name in CASES:
        res = [r[name] for r in ranks[S]]
        for r in res:
            assert r["free"] == [r["n_pages"] - 1] * S, name
        for r in res[1:]:
            assert r["logits"].shape == res[0]["logits"].shape
            assert r["logits"].tobytes() == res[0]["logits"].tobytes(), name


def test_masked_psum_merge_gloo_matches_jax(ranks):
    parts = _merge_parts(S=4)
    want = _jax_merge(parts)
    got = [r["merge"] for r in ranks[4]]
    for g in got:
        np.testing.assert_allclose(g, want[0], rtol=MERGE_TOL,
                                   atol=MERGE_TOL)
        assert g.tobytes() == got[0].tobytes()
    assert (got[0][0, :, 0] == 0).all()


def test_sharded_kill_resume_equals_uninterrupted(ranks, kill_ref):
    """2 ranks under the supervisor, crashes at steps 3 and 6: the tokens
    of JAX's uninterrupted single-device run, 2 restarts losing at most 2
    steps each, every shard pool freed, one snapshot directory per rank."""
    want, _ = kill_ref
    for res in ranks[2]:
        k = res["kill"]
        assert k["tokens"] == want
        assert k["restarts"] == 2 and k["max_step_loss"] <= 2
        assert k["free"] == [k["n_pages"] - 1] * 2
    for r in range(2):
        assert any((ranks["ckpt"] / f"rank{r}").iterdir())


# ------------------------------------------------------------------ #
# the group runner and the CLI
# ------------------------------------------------------------------ #
def _fail_on_rank1(group):
    if group.index == 1:
        raise ValueError("rank 1 fails")
    group.psum_(torch.ones(1))         # rank 0 waits for a dead peer


def test_run_ranks_raises_when_a_rank_fails():
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        run_ranks(_fail_on_rank1, 2, backend="gloo", device="cpu",
                  timeout_s=60.0)


@pytest.mark.parametrize("kw,match", [
    (dict(backend="nccl"), "backend='gloo'"),
    (dict(backend="gloo"), "needs the device"),
    (dict(backend="mpi", device="cpu"), "backend must be")])
def test_run_ranks_backend_is_explicit(kw, match):
    """No rank starts: NCCL with more ranks than cards raises and names
    gloo, gloo without a device and an unknown backend raise."""
    n = (torch.cuda.device_count() if torch.cuda.is_available() else 0) + 1
    with pytest.raises((RuntimeError, ValueError), match=match):
        run_ranks(_fail_on_rank1, n, **kw)


def test_serve_cli_seq_shards_prints_single_device_tokens(capfd):
    from repro_torch.launch.serve import main

    base = ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
            "--batch", "3", "--prompt-len", "20", "--new-tokens", "5",
            "--chunk", "8"]
    one = main(base)
    out_one = capfd.readouterr().out
    two = main(base + ["--seq-shards", "2", "--dist-backend", "gloo",
                       "--dist-timeout", str(DEADLINE_S)])
    out_two = capfd.readouterr().out
    assert sorted(one) == sorted(two)
    for rid in one:
        np.testing.assert_array_equal(one[rid], two[rid])
    samples = [ln for ln in out_one.splitlines() if ln.startswith("sample")]
    assert samples and samples == [ln for ln in out_two.splitlines()
                                   if ln.startswith("sample")]
    assert "seq_shards=2 backend=gloo" in out_two
    with pytest.raises(SystemExit):
        main(base + ["--seq-shards", "2", "--dist-backend", "nccl"])
    assert "--dist-backend gloo" in capfd.readouterr().err
