"""Port parity: runtime plans (``core/dynamic.py``) and the scatter dK/dV
twin against the JAX reference, on the CPU (the port's plain versions; the
reference's XLA scans and its Pallas kernels in interpret mode).

Every single-device case of ``tests/test_dynamic_plan.py`` runs on the port
at the reference's tolerances (1e-4; 2e-4 for the small-keep gradients
against masked dense attention). Against JAX: the selected tables equal
exactly (also on the tile-ratio workload of ``benchmarks/dynamic_stats.py``,
whose inputs are rebuilt here), and out and the three gradients within
1e-4. Inputs are f32, made with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import patterns as JP
from repro.core import dynamic as JD
from repro.core.blockwise import blockwise_attention as j_blockwise
from repro_torch.core import dynamic as TD
from repro_torch.core import patterns as TP
from repro_torch.core.attention import hybrid_attention
from repro_torch.core.blockwise import (plan_tables, table_dkv_scan,
                                        table_dkv_scatter_scan)
from repro_torch.core.plan_contract import validate_tables
from repro_torch.core.scheduler import schedule
from repro_torch.kernels import salo_attention as TKA
from repro_torch.kernels import salo_backward as TKB
from repro_torch.kernels.ops import salo_attention as t_static
from repro_torch.obs.metrics import global_registry

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)

PATTERNS = [
    ("window_sinks", JP.causal_sliding_window(48, n_sinks=8)),
    ("longformer_global", JP.longformer(32, n_global=8)),
    ("dilated", JP.dilated_window(32, 2)),
]
IDS = [name for name, _ in PATTERNS]


def _tpat(jpat):
    return TP.HybridSparsePattern(**{f: getattr(jpat, f) for f in (
        "window", "dilation", "n_global", "global_rows", "causal", "grid2d",
        "window2d")})


def _data(rng, n=256, d=32, b=2, count=4):
    return tuple(rng.normal(size=(b, n, d)).astype(np.float32)
                 for _ in range(count))


def _t_fwd_grads(fn, q, k, v, cot):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fn(qt, kt, vt)
    (out * torch.tensor(cot)).sum().backward()
    return [x.detach().numpy() for x in (out, qt.grad, kt.grad, vt.grad)]


def _j_fwd_grads(fn, q, k, v, cot):
    def loss(a, b, c):
        out = fn(a, b, c)
        return jnp.sum(out * cot), out
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return [np.asarray(x) for x in (out, *grads)]


def _close(got, want, names="out dq dk dv".split(), **tol):
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **(tol or TOL))


# --------------- the reference's single-device cases, on the port -------- #
@pytest.mark.parametrize("name,jpat", PATTERNS, ids=IDS)
def test_full_keep_matches_static(name, jpat):
    """keep >= max_steps selects every candidate step: outputs and all
    three gradients equal the static path's within 1e-4."""
    pat = _tpat(jpat)
    q, k, v, cot = _data(np.random.default_rng(0))
    cfg = TD.DynamicConfig(keep=10 ** 6)
    ref = _t_fwd_grads(lambda a, b, c: t_static(a, b, c, pat, 32, 32),
                       q, k, v, cot)
    got = _t_fwd_grads(lambda a, b, c: TD.dynamic_attention(
        a, b, c, pat, cfg, block_q=32, block_k=32), q, k, v, cot)
    _close(got, ref)


def test_small_keep_matches_masked_dense():
    """keep < max_steps equals dense attention under the implied token
    mask (the pattern's mask restricted to the selected tiles), forward
    within 1e-4 and gradients within 2e-4, as the reference's test."""
    jpat = JP.causal_sliding_window(64)
    pat = _tpat(jpat)
    N, BLK, KEEP = 256, 32, 3
    q, k, v, cot = _data(np.random.default_rng(1), n=N)
    cfg = TD.DynamicConfig(keep=KEEP)
    plan, kvt, flg, _ = TD.dynamic_tables(torch.tensor(q), torch.tensor(k),
                                          pat, cfg, block_q=BLK, block_k=BLK)
    assert np.array_equal(plan.positions_padded(), np.arange(N))
    kvt, flg = kvt.numpy(), flg.numpy()
    sel = np.zeros((N // BLK, N // BLK), bool)
    for i in range(N // BLK):
        sel[i, kvt[i][flg[i] != 0]] = True
    mask = torch.from_numpy(pat.mask(N) & np.repeat(
        np.repeat(sel, BLK, axis=0), BLK, axis=1))

    def dense_ref(a, b, c):
        s = torch.einsum("bqd,bkd->bqk", a, b) * (32 ** -0.5)
        s = torch.where(mask[None], s, -1e30)
        return torch.einsum("bqk,bkd->bqd", torch.softmax(s, dim=-1), c)

    ref = _t_fwd_grads(dense_ref, q, k, v, cot)
    got = _t_fwd_grads(lambda a, b, c: TD.dynamic_attention(
        a, b, c, pat, cfg, block_q=BLK, block_k=BLK), q, k, v, cot)
    _close(got[:1], ref[:1])
    _close(got[1:], ref[1:], names=["dq", "dk", "dv"], rtol=1e-4, atol=2e-4)
    assert (flg != 0).sum() < (plan.flags != 0).sum()


@pytest.mark.parametrize("name,jpat", PATTERNS, ids=IDS)
def test_never_drop_and_contract(name, jpat):
    """Every always-keep step (causal-local + global/sink tiles) is
    selected whatever the content, and the tables pass the contract."""
    q, k, _, _ = _data(np.random.default_rng(2))
    cfg = TD.DynamicConfig(keep=6)
    plan, kvt, flg, always = TD.dynamic_tables(
        torch.tensor(q), torch.tensor(k), _tpat(jpat), cfg, block_q=32,
        block_k=32)
    assert kvt.dtype == flg.dtype == torch.int32
    assert kvt.is_contiguous() and flg.is_contiguous()
    validate_tables(kvt, flg, nkb=plan.nkb, name=f"dynamic[{name}]")
    kvt, flg = kvt.numpy(), flg.numpy()
    for i in range(plan.nq):
        picked = set(kvt[i][flg[i] != 0].tolist())
        needed = set(plan.kv_blocks[i][always[i]].tolist())
        assert needed <= picked, \
            f"{name} row {i}: dropped always-keep tiles {needed - picked}"
        assert len(picked) <= 6
        real = flg[i] != 0          # ascending tiles, right-padded
        assert real[:real.sum()].all() and np.all(np.diff(kvt[i][real]) > 0)


def test_check_keep_raises():
    q, k, _, _ = _data(np.random.default_rng(3))
    with pytest.raises(ValueError, match="always-kept"):
        TD.dynamic_tables(torch.tensor(q), torch.tensor(k),
                          _tpat(JP.causal_sliding_window(48, n_sinks=8)),
                          TD.DynamicConfig(keep=1), block_q=32, block_k=32)
    TD.check_keep(3, np.ones((4, 3), bool)[:, :2])  # 3 >= 2: fine


def test_hybrid_attention_dynamic_route():
    """plan="dynamic" on the multi-head entry point (GQA heads expanded as
    on the static path); dense_ref, a missing keep and an unknown plan are
    rejected."""
    rng = np.random.default_rng(5)
    q = torch.tensor(rng.normal(size=(2, 4, 128, 16)).astype(np.float32))
    k, v = (torch.tensor(rng.normal(size=(2, 2, 128, 16)).astype(np.float32))
            for _ in range(2))
    pat = _tpat(JP.causal_sliding_window(32, n_sinks=4))
    ref = hybrid_attention(q, k, v, pat, block_q=16, block_k=16)
    full = hybrid_attention(q, k, v, pat, plan="dynamic",
                            dynamic_keep=10 ** 6, block_q=16, block_k=16)
    np.testing.assert_allclose(full.numpy(), ref.numpy(), **TOL)
    small = hybrid_attention(q, k, v, pat, plan="dynamic", dynamic_keep=4,
                             block_q=16, block_k=16, dynamic_pool_k=4,
                             dynamic_local_window=16)
    assert small.shape == q.shape and bool(torch.isfinite(small).all())
    with pytest.raises(ValueError, match="dense_ref"):
        hybrid_attention(q, k, v, pat, plan="dynamic", dynamic_keep=4,
                         impl="dense_ref")
    with pytest.raises(ValueError, match="dynamic_keep"):
        hybrid_attention(q, k, v, pat, plan="dynamic")
    with pytest.raises(ValueError, match="plan"):
        hybrid_attention(q, k, v, pat, plan="adaptive")


def test_invalid_impl_rejected():
    q, k, v, _ = (torch.tensor(x) for x in
                  _data(np.random.default_rng(6), n=64))
    with pytest.raises(ValueError, match="table-driven"):
        TD.dynamic_attention(q, k, v,
                             _tpat(JP.causal_sliding_window(32)),
                             TD.DynamicConfig(keep=4), block_q=32,
                             block_k=32, impl="dense_ref")


# ------------------------------ against JAX ------------------------------ #
def _segments(rng, B=2, N=2048, D=64, a=1.5, n_topics=16, mean_seg=96):
    """``benchmarks/dynamic_stats._segments``: geometric-length topical
    runs; q and k inside a segment share that segment's topic."""
    topics = rng.normal(size=(n_topics, D))
    topics /= np.linalg.norm(topics, axis=1, keepdims=True)
    q = rng.normal(size=(B, N, D))
    k = rng.normal(size=(B, N, D))
    for b in range(B):
        pos = 0
        while pos < N:
            ln = max(16, int(rng.geometric(1.0 / mean_seg)))
            t = topics[rng.integers(n_topics)]
            q[b, pos:pos + ln] += a * t
            k[b, pos:pos + ln] += a * t
            pos += ln
    return q.astype(np.float32), k.astype(np.float32)


def _tables_case(case):
    """(jax pattern, q, k, keep, block, pool_k) of a table-equality case."""
    if case == "tile_ratio":
        q, k = _segments(np.random.default_rng(1))
        return JP.full(causal=True), q, k, 8, 64, 4
    if case == "small_keep":
        q, k, _, _ = _data(np.random.default_rng(1))
        return JP.causal_sliding_window(64), q, k, 3, 32, None
    name, keep = case.rsplit("_", 1)
    jpat = dict(PATTERNS)[name]
    q, k, _, _ = _data(np.random.default_rng(2))
    return jpat, q, k, int(keep), 32, None


TABLE_CASES = ([f"{n}_{keep}" for n in IDS for keep in (6, 1000000)]
               + ["small_keep", "tile_ratio"])


@pytest.mark.parametrize("case", TABLE_CASES)
def test_dynamic_tables_equal_jax(case):
    """The selected tables equal the reference's exactly. On the tile-ratio
    workload (``benchmarks/dynamic_stats.py``: full causal, n 2048, 64 x 64
    tiles, keep 8, pool_k 4) the reference executes 235 of 559 tiles
    (``BENCH_dynamic.json``)."""
    jpat, q, k, keep, blk, pool_k = _tables_case(case)
    jcfg = JD.DynamicConfig(keep=keep, pool_k=pool_k)
    tcfg = TD.DynamicConfig(keep=keep, pool_k=pool_k)
    jplan, jk, jf, jal = JD.dynamic_tables(jnp.asarray(q), jnp.asarray(k),
                                           jpat, jcfg, block_q=blk,
                                           block_k=blk)
    tplan, tk, tf, tal = TD.dynamic_tables(torch.tensor(q), torch.tensor(k),
                                           _tpat(jpat), tcfg, block_q=blk,
                                           block_k=blk)
    assert np.array_equal(tal, np.asarray(jal))
    differ = np.flatnonzero((np.asarray(jk) != tk.numpy()).any(1)
                            | (np.asarray(jf) != tf.numpy()).any(1))
    if differ.size:   # the score gap at the keep boundary of those rows
        est = TD.block_scores(
            torch.tensor(q), torch.tensor(k),
            torch.tensor(tplan.positions_padded().reshape(tplan.nq, blk)),
            torch.tensor(tplan.positions_padded().reshape(tplan.nkb, blk)),
            q.shape[-1] ** -0.5, pool_k)
        gaps = {int(i): np.sort(est[i].numpy())[::-1][keep - 1:keep + 1]
                for i in differ}
        pytest.fail(f"rows {differ.tolist()} differ from JAX's; scores at "
                    f"the keep boundary: {gaps}")
    if case == "tile_ratio":
        assert int((tf != 0).sum()) == 235
        assert int((tplan.flags != 0).sum()) == 559


@pytest.mark.parametrize("jimpl", ["blockwise", "pallas_interpret"])
@pytest.mark.parametrize("name,jpat", PATTERNS, ids=IDS)
def test_dynamic_attention_matches_jax(name, jpat, jimpl):
    """out and dq/dk/dv within 1e-4 of the reference's dynamic_attention on
    its XLA scans and on its Pallas kernels in interpret mode."""
    q, k, v, cot = _data(np.random.default_rng(4))
    keep = 5 if name != "longformer_global" else 6
    want = _j_fwd_grads(lambda a, b, c: JD.dynamic_attention(
        a, b, c, jpat, JD.DynamicConfig(keep=keep), block_q=32, block_k=32,
        impl=jimpl), q, k, v, cot)
    got = _t_fwd_grads(lambda a, b, c: TD.dynamic_attention(
        a, b, c, _tpat(jpat), TD.DynamicConfig(keep=keep), block_q=32,
        block_k=32), q, k, v, cot)
    _close(got, want)


def test_static_path_matches_jax_blockwise():
    """The dynamic op at full keep against the reference's STATIC
    blockwise path (the machinery-off invariant across packages)."""
    jpat = JP.causal_sliding_window(48, n_sinks=8)
    q, k, v, cot = _data(np.random.default_rng(7))
    want = _j_fwd_grads(lambda a, b, c: j_blockwise(
        a, b, c, jpat, block_q=32, block_k=32), q, k, v, cot)
    got = _t_fwd_grads(lambda a, b, c: TD.dynamic_attention(
        a, b, c, _tpat(jpat), TD.DynamicConfig(keep=10 ** 6), block_q=32,
        block_k=32), q, k, v, cot)
    _close(got, want)


# ------------------------------ supporting ------------------------------- #
def test_ties_break_like_jax_top_k():
    """Every KV tile a copy of one tile: the estimates of all tiles are
    exactly equal (finite ties), and the selection keeps the lowest steps
    beyond the always-kept ones, as ``jax.lax.top_k`` does."""
    rng = np.random.default_rng(8)
    B, N, D, BLK, KEEP = 2, 512, 16, 32, 4
    q = rng.normal(size=(B, N, D)).astype(np.float32)
    k = np.tile(rng.normal(size=(B, BLK, D)), (1, N // BLK, 1)).astype(
        np.float32)
    jpat = JP.full(causal=True)
    jplan, jk, jf, _ = JD.dynamic_tables(jnp.asarray(q), jnp.asarray(k),
                                         jpat, JD.DynamicConfig(keep=KEEP),
                                         block_q=BLK, block_k=BLK)
    plan, tk, tf, always = TD.dynamic_tables(
        torch.tensor(q), torch.tensor(k), _tpat(jpat),
        TD.DynamicConfig(keep=KEEP), block_q=BLK, block_k=BLK)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    for i in range(plan.nq):
        real = plan.flags[i] != 0
        cand = plan.kv_blocks[i][real]
        pinned = set(plan.kv_blocks[i][always[i]].tolist())
        rest = [t for t in cand.tolist() if t not in pinned]
        want = sorted(pinned | set(rest[:max(KEEP - len(pinned), 0)]))
        assert tk[i][tf[i] != 0].tolist() == want, i


@pytest.mark.parametrize("name,jpat", PATTERNS, ids=IDS)
def test_scatter_dkv_matches_transposed_scan(name, jpat):
    """On static tables the scatter twin equals the packed transposed walk
    (K3's plain version) within 1e-5."""
    pat = _tpat(jpat)
    rng = np.random.default_rng(9)
    sched = schedule(pat, 256)
    plan = sched.plan(32, 32)
    t = plan_tables(plan, torch.device("cpu"))
    B, D = 2, 32
    q, k, v, dout = (torch.tensor(rng.normal(size=(B, plan.n_pad, D))
                                  .astype(np.float32)) for _ in range(4))
    _, m, l = TKA.salo_table_attention_plain(
        q, k, v, t.pos.reshape(plan.nq, 32), t.pos.reshape(plan.nkb, 32),
        t.kv_blocks, t.flags, sched=sched, scale=D ** -0.5)
    delta = torch.tensor(rng.normal(size=(B, plan.n_pad)).astype(np.float32))
    common = (dout, delta, m, l, q, k, v, t.pos.reshape(plan.nq, 32),
              t.pos.reshape(plan.nkb, 32))
    want = table_dkv_scan(*common, t.row_tile, t.q_blocks, t.pk_flags, sched,
                          D ** -0.5)
    got = table_dkv_scatter_scan(*common, t.kv_blocks, t.flags, sched,
                                 D ** -0.5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_replayed_selection_equals_saved_tables():
    """The forward saves the selected tables; replaying the selection from
    the saved q and k (what the reference's backward does) gives them
    again."""
    jpat = JP.longformer(32, n_global=8)
    pat = _tpat(jpat)
    q, k, v, _ = (torch.tensor(x, requires_grad=True)
                  for x in _data(np.random.default_rng(10)))
    cfg = TD.DynamicConfig(keep=6)
    out = TD.dynamic_attention(q, k, v, pat, cfg, block_q=32, block_k=32)
    saved = out.grad_fn.saved_tensors
    kvt, flg = saved[-2:]
    assert kvt.dtype == flg.dtype == torch.int32
    _, rk, rf, _ = TD.dynamic_tables(saved[0], saved[1], pat, cfg,
                                     block_q=32, block_k=32)
    assert torch.equal(rk, kvt) and torch.equal(rf, flg)


def test_launch_counts_and_registry():
    """One fwd + bwd: one plain K1 call, one plain K2 call, no K3 call (the
    scatter twin takes dK/dV); the registry books one plan build, its keep
    ratio and the kept steps for K1 and K2."""
    pat = _tpat(JP.causal_sliding_window(48, n_sinks=8))
    q, k, v, cot = (torch.tensor(x, requires_grad=True)
                    for x in _data(np.random.default_rng(11)))
    counters = (TKA.salo_table_attention_plain,
                TKB.salo_table_backward_dq_plain,
                TKB.salo_table_backward_dkv_plain)
    reg = global_registry()
    before = [f.calls for f in counters]
    builds = reg.value("dynamic_plan_builds")
    tiles = [reg.value("kernel_tiles", kernel=n) for n in (
        "salo_table_attention", "salo_table_backward_dq")]
    cfg = TD.DynamicConfig(keep=3)
    out = TD.dynamic_attention(q, k, v, pat, cfg, block_q=32, block_k=32)
    assert [f.calls - b for f, b in zip(counters, before)] == [1, 0, 0]
    (out * cot.detach()).sum().backward()
    assert [f.calls - b for f, b in zip(counters, before)] == [1, 1, 0]
    assert all(f.launches == 0 for f in (TKA.salo_table_attention,
                                         TKB.salo_table_backward_dq,
                                         TKB.salo_table_backward_dkv))
    assert reg.value("dynamic_plan_builds") == builds + 1
    plan = schedule(pat, 256).plan(32, 32)
    kept = int(np.minimum((plan.flags != 0).sum(-1), 3).sum())
    for name, before_t in zip(("salo_table_attention",
                               "salo_table_backward_dq"), tiles):
        assert reg.value("kernel_tiles", kernel=name) == \
            before_t + 2 * kept
