"""Port parity for fault-tolerant serving: every single-device case of
``tests/test_serve_ft.py`` and the engine and supervisor cases of
``tests/test_obs.py``, re-run on the port's ``ContinuousEngine`` on the
CPU (smollm smoke, page 8, chunk 8, f32), plus reference snapshots
restored into the port. Oracles: the port's lockstep ``ServeEngine`` and
the uninterrupted continuous run (greedy token ids, exact), and for the
cross-package cases the JAX engine's uninterrupted run (exact)."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_smoke
from repro.ft import save as j_save
from repro.models.layers import salo_pattern as j_pattern
from repro.models.model import build_model as j_build
from repro.serve.engine import ContinuousConfig as JConfig
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.paged_cache import layout_for_pattern as j_layout
from repro_torch.configs import get_smoke
from repro_torch.convert import engine_state_from_jax, params_from_jax
from repro_torch.ft import (FaultInjector, FaultPlan, ServeSupervisor,
                            StragglerWatchdog, restore, save)
from repro_torch.ft.faults import (QueueFull, RejectedRequest,
                                   ResourceExhausted, RestartsExhausted)
from repro_torch.models.layers import salo_pattern
from repro_torch.models.model import build_model
from repro_torch.obs import Observability, summary_line, validate_chrome_trace
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serve.batcher import DECODE, Batcher
from repro_torch.serve.engine import (ContinuousConfig, ContinuousEngine,
                                      ServeConfig, ServeEngine)
from repro_torch.serve.paged_cache import layout_for_pattern

torch.set_num_threads(2)
RNG = np.random.default_rng(11)


def _amplify(params, gain=6.0):
    """Scale every residual branch's output projection, so greedy tokens
    depend on attention (at the plain init they repeat the input)."""
    out = dict(params)
    out["seg0_attn_mlp"] = [
        dict(layer, attn=dict(layer["attn"], wo=layer["attn"]["wo"] * gain),
             mlp=dict(layer["mlp"], w_out=layer["mlp"]["w_out"] * gain))
        for layer in params["seg0_attn_mlp"]]
    return out


@pytest.fixture(scope="module")
def stack():
    cfg = get_smoke("smollm-135m")   # window 16, page 8 -> 3 pages/request
    model = build_model(cfg, "cpu")
    params = _amplify(model.init(torch.Generator().manual_seed(0)))
    lay = layout_for_pattern(salo_pattern(cfg, causal=True), 8)
    return cfg, model, params, lay


def _refs(model, params, prompts, n_new):
    """The lockstep oracle, request by request."""
    out = []
    for p in prompts:
        eng = ServeEngine(model, ServeConfig(max_len=len(p) + n_new))
        out.append(eng.generate(params, torch.from_numpy(p)[None],
                                n_new)[0].numpy())
    return out


def _engine(model, lay, *, n_pages=None, max_batch=4, clock=None,
            max_queue=None, obs=None):
    return ContinuousEngine(model, ContinuousConfig(
        n_pages=n_pages or 1 + max_batch * lay.pages_per_req, page=8,
        chunk=8, max_batch=max_batch, max_queue=max_queue), device="cpu",
        clock=clock, obs=obs)


def _prompts(cfg, lens):
    return [RNG.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
            for n in lens]


# ======================= lifecycle snapshotting ======================== #
def test_batcher_state_roundtrip(stack):
    """Queue, resident rows, finished, the allocator free list's ORDER,
    counters and remaining deadlines survive state_dict/load_state into a
    fresh batcher."""
    _, _, _, lay = stack
    clk = [100.0]
    b = Batcher(lay, n_pages=7, max_batch=2, max_queue=8,
                clock=lambda: clk[0])
    r0 = b.submit(np.arange(12) + 1, 6, priority=1, deadline_s=9.0)
    b.submit(np.arange(5) + 1, 4)
    r2 = b.submit(np.arange(3) + 1, 2)
    b.admit()
    req0 = next(q for q in b.rows if q is not None and q.rid == r0)
    req0.state = DECODE
    req0.out.extend([7, 8])
    st = json.loads(json.dumps(b.state_dict()))   # the snapshot's JSON trip

    clk[0] = 200.0   # restore on a shifted clock: deadlines re-anchor
    b2 = Batcher(lay, n_pages=7, max_batch=2, clock=lambda: clk[0])
    b2.load_state(st)
    q0 = next(q for q in b2.rows if q is not None and q.rid == r0)
    assert q0.state == DECODE and q0.out == [7, 8] and q0.priority == 1
    assert q0.deadline == pytest.approx(209.0)
    np.testing.assert_array_equal(q0.pages, req0.pages)
    assert [q.rid for q in b2.queue] == [q.rid for q in b.queue]
    assert b2._next_rid == 3 and r2 in {q.rid for q in b2.queue}
    for a, a2 in zip(b.allocs, b2.allocs):
        assert a._free == a2._free
    assert b2.submit(np.arange(4) + 1, 2) == 3


def test_engine_snapshot_restore_parity(stack, tmp_path):
    """Snapshot mid-flight (one row still prefilling, the others
    decoding), through the atomic writer, restored into a FRESH engine:
    the resumed run emits exactly the remaining tokens, equal to the
    uninterrupted run and the lockstep oracle (exactly-once)."""
    cfg, model, params, lay = stack
    n_new = 8
    prompts = _prompts(cfg, (5, 9, 13, 50))
    refs = _refs(model, params, prompts, n_new)

    eng = _engine(model, lay)
    rids = [eng.submit(p, n_new) for p in prompts]
    for _ in range(5):
        eng.step(params)
    pre, dec = eng.batcher.assemble()
    assert pre and dec
    save(tmp_path / "ck", eng.state_dict(), step=5)
    while eng.step(params):
        pass
    uninterrupted = eng.batcher.results()

    eng2 = _engine(model, lay)
    own = [a for s in eng2.slabs.values() for a in s.tensors()]
    eng2.load_state(restore(tmp_path / "ck", eng2.state_dict()))
    assert [a for s in eng2.slabs.values() for a in s.tensors()] == own
    assert eng2.counters["engine_steps"] == 5
    while eng2.step(params):
        pass
    resumed = eng2.batcher.results()
    assert len({int(x) for r in rids for x in resumed[r]}) > 4
    for rid, ref in zip(rids, refs):
        np.testing.assert_array_equal(resumed[rid], uninterrupted[rid])
        np.testing.assert_array_equal(resumed[rid], ref)
    assert dict(eng2.counters) == dict(eng.counters)


def test_state_dict_holds_clones(stack):
    """The engine updates its slabs and slot map in place: a snapshot
    taken before further steps is unchanged by them, and loading it back
    rewinds the live tensors it was cloned from."""
    cfg, model, params, lay = stack
    eng = _engine(model, lay)
    for p in _prompts(cfg, (9, 20)):
        eng.submit(p, 6)
    for _ in range(2):
        eng.step(params)
    snap = eng.state_dict()
    frozen = {k: [a.clone() for a in s.tensors()]
              for k, s in snap["slabs"].items()}
    pos = snap["slot_pos"].clone()
    for _ in range(3):
        eng.step(params)
    assert not torch.equal(eng.slot_pos, pos)
    for k, s in snap["slabs"].items():
        assert all(torch.equal(a, b) for a, b in zip(s.tensors(), frozen[k]))
    assert torch.equal(snap["slot_pos"], pos)
    eng.load_state(snap)
    assert torch.equal(eng.slot_pos, pos)
    assert eng.counters["engine_steps"] == 2


def test_load_state_rejects_another_config(stack):
    cfg, model, params, lay = stack
    fp = _engine(model, lay)
    q8 = ContinuousEngine(model, ContinuousConfig(
        n_pages=1 + 4 * lay.pages_per_req, page=8, chunk=8, max_batch=4,
        kv_dtype="int8"), device="cpu")
    with pytest.raises(ValueError, match="quantized"):
        q8.load_state(fp.state_dict())
    small = _engine(model, lay, max_batch=2)
    with pytest.raises(ValueError, match="slot_pos|slab"):
        small.load_state(fp.state_dict())


@pytest.mark.parametrize("plan,every,shared_obs", [
    ({3, 6}, 2, False),
    # a crash before the first snapshot restarts from scratch; with one
    # obs shared by every engine the lost steps' counts must go too
    ({1, 9}, 4, True)])
def test_supervisor_kill_resume_parity(stack, tmp_path, plan, every,
                                       shared_obs):
    """Injected step crashes mid-serve: the supervisor restores the latest
    snapshot into a rebuilt engine (or restarts from scratch) and finishes
    with the lockstep oracle's tokens and the uninterrupted run's
    counters; work lost per crash is bounded by the checkpoint
    interval."""
    cfg, model, params, lay = stack
    n_new = 8
    prompts = _prompts(cfg, (20, 18, 22))
    refs = _refs(model, params, prompts, n_new)
    obs = Observability() if shared_obs else None

    def make_engine():
        eng = _engine(model, lay, max_batch=4, obs=obs)
        for p in prompts:
            eng.submit(p, n_new)
        return eng

    plain = make_engine()
    plain.run(params)
    want = dict(plain.counters)
    obs = Observability() if shared_obs else None
    sup = ServeSupervisor(
        make_engine, params, tmp_path / "snap", checkpoint_every=every,
        injector=FaultInjector(FaultPlan(crash_steps=frozenset(plan))))
    eng, hist = sup.run()
    res = eng.batcher.results()
    for rid, ref in zip(sorted(res), refs):
        np.testing.assert_array_equal(res[rid], ref)
    assert hist["restarts"] == 2
    assert hist["max_step_loss"] <= every
    assert dict(eng.counters) == want
    assert all(a.n_free == eng.ccfg.n_pages - 1
               for a in eng.batcher.allocs)


def test_supervisor_restart_budget(stack, tmp_path):
    cfg, model, params, lay = stack

    def make_engine():
        eng = _engine(model, lay)
        eng.submit(np.arange(4) + 1, 2)
        return eng

    sup = ServeSupervisor(
        make_engine, params, tmp_path / "snap", max_restarts=2,
        injector=FaultInjector(FaultPlan(crash_steps=frozenset(range(50)))))
    with pytest.raises(RestartsExhausted):
        sup.run()


# ================ preemption, admission control, deadlines ============= #
def test_preemption_reprefill_parity(stack):
    """Page pressure with a higher-priority arrival: low-priority decoding
    requests are evicted and recover by chunked re-prefill; every request
    still matches the lockstep oracle, nothing double-emitted."""
    cfg, model, params, lay = stack
    n_new = 8
    pa, pb, pc = _prompts(cfg, (20, 18, 22))
    refs = _refs(model, params, [pa, pb, pc], n_new)
    eng = _engine(model, lay, n_pages=1 + 2 * lay.pages_per_req)
    ra = eng.submit(pa, n_new, priority=0)
    rb = eng.submit(pb, n_new, priority=0)
    while True:   # both resident and decoding -> pool fully occupied
        eng.step(params)
        if len(eng.batcher.assemble()[1]) == 2:
            break
    rc = eng.submit(pc, n_new, priority=1)
    res = eng.run(params)
    for rid, ref in zip((ra, rb, rc), refs):
        np.testing.assert_array_equal(res[rid], ref, err_msg=str(rid))
    assert eng.batcher.preemptions >= 1
    victim = next(r for r in eng.batcher.finished.values()
                  if r.preemptions > 0)
    assert victim.priority == 0
    assert all(a.n_free == eng.ccfg.n_pages - 1
               for a in eng.batcher.allocs)


def test_small_footprint_fits_small_pool(stack):
    cfg, model, params, lay = stack
    eng = _engine(model, lay, n_pages=lay.pages_per_req)  # 2 usable < 3
    prompt = (np.arange(4) + 1).astype(np.int32)
    rid = eng.submit(prompt, 2)    # spans 5 positions -> 1 page
    res = eng.run(params)
    np.testing.assert_array_equal(
        res[rid], _refs(model, params, [prompt], 2)[0])


def test_admission_control_at_submit(stack):
    cfg, model, _, lay = stack
    eng = _engine(model, lay, n_pages=lay.pages_per_req, max_queue=2)
    with pytest.raises(RejectedRequest, match="can never fit"):
        eng.submit(np.arange(40) + 1, 8)   # needs all 3 pages, pool has 2
    eng.submit(np.arange(4) + 1, 2)
    eng.submit(np.arange(4) + 1, 2)
    with pytest.raises(QueueFull, match="max_queue=2"):
        eng.submit(np.arange(4) + 1, 2)


def test_deadline_expiry_frees_pages(stack):
    cfg, model, params, lay = stack
    clk = [0.0]
    n_new = 8
    pa, pb = _prompts(cfg, (20, 18))
    ref_b = _refs(model, params, [pb], n_new)[0]
    eng = _engine(model, lay, clock=lambda: clk[0])
    rd = eng.submit(pa, n_new, deadline_s=5.0)
    ro = eng.submit(pb, n_new)
    for _ in range(4):
        eng.step(params)
    clk[0] = 10.0   # past rd's deadline mid-decode
    res = eng.run(params)
    assert rd not in res
    assert "deadline expired" in eng.batcher.failures()[rd]
    np.testing.assert_array_equal(res[ro], ref_b)
    assert eng.batcher.expired == 1
    assert all(a.n_free == eng.ccfg.n_pages - 1
               for a in eng.batcher.allocs)


# ========================= fault injection ============================= #
def test_injected_exhaustion_recovery(stack, tmp_path):
    """An injected exhaustion window: the bare engine raises the
    recoverable ResourceExhausted when nothing is in flight; under the
    supervisor the same plan costs restarts, and the tokens still match
    the oracle."""
    cfg, model, params, lay = stack
    n_new = 6
    prompts = _prompts(cfg, (7, 12))
    refs = _refs(model, params, prompts, n_new)

    def make_engine():
        eng = _engine(model, lay)
        for p in prompts:
            eng.submit(p, n_new)
        return eng

    inj = FaultInjector(FaultPlan(exhaust_steps=frozenset({0, 1})))
    eng = make_engine()
    inj.attach(eng)
    inj.before_step(0)
    with pytest.raises(ResourceExhausted, match="admission stalled"):
        eng.step(params)

    sup = ServeSupervisor(
        make_engine, params, tmp_path / "snap",
        injector=FaultInjector(FaultPlan(exhaust_steps=frozenset({0, 1}))))
    eng, hist = sup.run()
    res = eng.batcher.results()
    for rid, ref in zip(sorted(res), refs):
        np.testing.assert_array_equal(res[rid], ref)
    assert hist["restarts"] == 2


def test_injected_stragglers_flagged(stack, tmp_path):
    cfg, model, params, lay = stack
    naps = []
    inj = FaultInjector(FaultPlan(straggle_steps=frozenset({5}),
                                  straggle_s=0.3), sleep=naps.append)
    prompt = _prompts(cfg, (9,))[0]

    def make_engine():
        eng = _engine(model, lay)
        eng.submit(prompt, 6)
        return eng

    ServeSupervisor(make_engine, params, tmp_path / "snap",
                    injector=inj).run()
    assert inj.injected["stragglers"] == 1 and naps == [0.3]
    wd = StragglerWatchdog(threshold=3.0, warmup_steps=1)
    times = [0.1, 0.1, 0.1, 0.1, 0.9, 0.1]   # one 9x outlier
    assert [wd.observe(t) for t in times].count(True) == 1
    assert wd.events == 1


# ================== engine instrumentation + compat ===================== #
def test_counters_view_compat_and_metrics(stack):
    cfg, model, params, lay = stack
    eng = _engine(model, lay)
    prompts = _prompts(cfg, (11, 6))
    for p in prompts:
        eng.submit(p, 4)
    eng.run(params)
    c = dict(eng.counters)
    assert c["engine_steps"] > 0 and isinstance(c["engine_steps"], int)
    assert set(c) == set(eng.counters.KEYS)
    assert eng.counters["prefill_launches"] == \
        sum(-(-len(p) // 8) for p in prompts)
    assert eng.registry.value("serve_engine_steps") == c["engine_steps"]
    assert eng.registry.percentiles("serve_ttft_s",
                                    priority=0)["count"] == 2
    assert eng.registry.percentiles("serve_tpot_s",
                                    priority=0)["count"] == 2 * 3
    assert eng.registry.percentiles("serve_queue_wait_s",
                                    priority=0)["count"] == 2
    assert summary_line(eng.registry).startswith("steps=")


def test_engine_snapshot_roundtrip_and_old_format(stack):
    """Registry and tokens through a snapshot into a fresh engine, and an
    old-format snapshot (no "metrics" in the control blob) still loads."""
    cfg, model, params, lay = stack
    prompts = _prompts(cfg, (9, 13))

    def mk():
        eng = _engine(model, lay)
        for p in prompts:
            eng.submit(p, 6)
        return eng

    full = mk().run(params)
    eng = mk()
    for _ in range(4):
        eng.step(params)
    snap = eng.state_dict()
    eng2 = mk()
    eng2.load_state(snap)
    assert eng2.registry.state_dict() == eng.registry.state_dict()
    assert dict(eng2.counters) == dict(eng.counters)
    res = eng2.run(params)
    assert all(np.array_equal(full[r], res[r]) for r in full)

    ctl = json.loads(bytes(snap["control"]).decode())
    assert "metrics" in ctl
    del ctl["metrics"]
    old = dict(snap, control=np.frombuffer(json.dumps(ctl).encode(),
                                           np.uint8))
    eng3 = mk()
    eng3.load_state(old)
    assert dict(eng3.counters) == dict(eng.counters)
    res3 = eng3.run(params)
    assert all(np.array_equal(full[r], res3[r]) for r in full)


def test_engine_trace_lifecycle_events(stack):
    cfg, model, params, lay = stack
    obs = Observability(tracing=True)
    eng = _engine(model, lay, obs=obs)
    eng.submit(_prompts(cfg, (10,))[0], 4)
    eng.run(params)
    names = {e["name"] for e in obs.tracer.events()}
    for want in ("engine.step", "assemble", "chunk_prefill", "ragged_decode",
                 "sample", "request.submitted", "request.admitted",
                 "request.first_token", "request.finished"):
        assert want in names, want
    steps = obs.tracer.find("engine.step")
    assert len(steps) == eng.counters["engine_steps"]
    assert all(e["depth"] == 0 for e in steps)
    assert all(e["depth"] == 1 for e in obs.tracer.find("assemble"))
    assert obs.tracer.find("request.first_token")[0]["args"]["ttft_s"] > 0
    validate_chrome_trace(obs.tracer.to_chrome_trace())


def test_engine_default_obs_disabled(stack):
    _, model, _, lay = stack
    eng = _engine(model, lay)
    assert eng.tracer is NULL_TRACER
    assert not eng.obs.tracing


def test_supervisor_fault_events_land_in_trace(stack, tmp_path):
    cfg, model, params, lay = stack
    prompts = _prompts(cfg, (9, 7))
    obs = Observability(tracing=True)

    def mk():
        eng = _engine(model, lay, obs=obs)
        for p in prompts:
            eng.submit(p, 4)
        return eng

    sup = ServeSupervisor(
        mk, params, str(tmp_path / "ck"), checkpoint_every=2,
        injector=FaultInjector(FaultPlan(crash_steps=frozenset({3}))),
        obs=obs)
    _, hist = sup.run()
    assert hist["restarts"] == 1
    names = [e["name"] for e in obs.tracer.events()]
    assert "ft.fault" in names and "ft.restart" in names \
        and "ft.snapshot" in names
    assert obs.tracer.find("ft.fault")[0]["args"]["kind"] == "StepCrash"
    assert obs.tracer.find("ft.restore")
    assert obs.registry.value("ft_restarts") == 1
    assert obs.registry.value("ft_faults", kind="StepCrash") == 1
    doc = obs.tracer.to_chrome_trace()
    validate_chrome_trace(doc)
    tracks = {e["args"]["name"] for e in doc["traceEvents"]
              if e["ph"] == "M"}
    assert {"engine", "requests", "ft"} <= tracks


def test_serve_cli_crashes_reproduce_tokens(tmp_path):
    """The CLI under ``--snapshot-dir`` with injected crashes returns the
    tokens of the plain run; ``--inject-crash-at`` alone is refused."""
    from repro_torch.launch.serve import main

    args = ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
            "--batch", "3", "--prompt-len", "20", "--new-tokens", "6"]
    plain = main(args)
    crashed = main(args + ["--snapshot-dir", str(tmp_path / "snap"),
                           "--inject-crash-at", "3,7"])
    assert sorted(plain) == sorted(crashed)
    for rid in plain:
        np.testing.assert_array_equal(plain[rid], crashed[rid])
    with pytest.raises(SystemExit):
        main(args + ["--inject-crash-at", "3"])


# ==================== reference snapshots into the port ================= #
@pytest.mark.parametrize("path", ["memory", "disk"])
@pytest.mark.parametrize("slab", ["fp", "int8_sparse"])
def test_reference_snapshot_resumes_in_port(tmp_path, slab, path):
    """The JAX engine runs 5 steps (one request still prefilling) and
    takes a snapshot; the port's engine loads it (in memory through
    ``engine_state_from_jax``, or from disk through ``repro.ft.save`` and
    the port's ``restore``) and finishes with the tokens and counters of
    the JAX engine's uninterrupted run, for the fp slab and the int8
    page-sparse slab (window 64, threshold -3, decay 0.3)."""
    import dataclasses

    from repro_torch.configs import get_smoke as t_smoke

    jcfg, tcfg = j_smoke("smollm-135m"), t_smoke("smollm-135m")
    kw = {}
    if slab == "int8_sparse":
        jcfg = dataclasses.replace(jcfg, salo=dataclasses.replace(
            jcfg.salo, window=64))
        tcfg = dataclasses.replace(tcfg, salo=dataclasses.replace(
            tcfg.salo, window=64))
        kw = dict(kv_dtype="int8", page_sparsity_threshold=-3.0,
                  page_stat_decay=0.3)
    lay = j_layout(j_pattern(jcfg, causal=True), 8)
    kw.update(n_pages=1 + 4 * lay.pages_per_req, page=8, chunk=8,
              max_batch=4)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(5))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab_size, (n,)).astype(np.int32)
               for n in (24, 17, 9, 50)]
    n_new = 24

    def jeng():
        e = JEngine(jmodel, JConfig(**kw))
        rids = [e.submit(p, n_new) for p in prompts]
        return e, rids

    ref, rids = jeng()
    ref_out = ref.run(jparams)
    half, _ = jeng()
    for _ in range(5):
        half.step(jparams)
    assert half.batcher.assemble()[0]            # one still prefilling
    snap = jax.tree.map(np.asarray, half.state_dict())

    teng = ContinuousEngine(build_model(tcfg, "cpu"), ContinuousConfig(**kw),
                            device="cpu")
    if path == "memory":
        teng.load_state(engine_state_from_jax(snap, "cpu"))
    else:
        j_save(str(tmp_path / "snap"), snap, 5)
        teng.load_state(restore(tmp_path / "snap", teng.state_dict()))
    assert teng.counters["engine_steps"] == 5
    out = teng.run(tparams)
    for r in rids:
        np.testing.assert_array_equal(out[r], ref_out[r])
    assert dict(teng.counters) == dict(ref.counters)
    c = teng.counters
    if slab == "int8_sparse":
        assert 0 < c["decode_pages_read"] < c["decode_pages_total"]
        np.testing.assert_allclose(teng.page_hist, ref.page_hist, rtol=0,
                                   atol=1e-6)


def test_engine_state_from_jax_consumes_every_leaf():
    jcfg = j_smoke("smollm-135m")
    lay = j_layout(j_pattern(jcfg, causal=True), 8)
    jeng = JEngine(j_build(jcfg), JConfig(n_pages=1 + 2 * lay.pages_per_req,
                                          page=8, chunk=8, max_batch=2,
                                          kv_dtype="int8"))
    snap = jax.tree.map(np.asarray, jeng.state_dict())
    got = engine_state_from_jax(snap, "cpu")
    (key, s), = got["slabs"].items()
    assert s.quantized and s.k.dtype == torch.int8
    assert s.k_scale.dtype == torch.float32
    assert got["slot_pos"].dtype == torch.int32
    assert got["control"].dtype == np.uint8
    with pytest.raises(ValueError, match="unconsumed"):
        engine_state_from_jax(dict(snap, extra=np.zeros(2)), "cpu")
    with pytest.raises(KeyError):
        engine_state_from_jax({k: v for k, v in snap.items()
                               if k != "page_hist"}, "cpu")
