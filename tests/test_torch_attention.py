"""Port parity: the training attention op and its kernel modules against
the JAX reference, on the CPU (the port's plain versions; the reference's
Pallas kernels in interpret mode and its XLA engines).

Inputs are f32, made with numpy from a seed. Tolerance 1e-4 (abs and rel)
for outputs and gradients, as the reference's own gradient tests: the same
algorithm in f32, summed in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import patterns as JP
from repro.core import scheduler as JS
from repro.core.attention import hybrid_attention as j_attention
from repro.core import blockwise as JB
from repro.core.blockwise import working_stream as j_working
from repro.kernels import salo_attention as JKA
from repro.kernels import salo_backward as JKB
from repro_torch.core import patterns as TP
from repro_torch.core import scheduler as TS
from repro_torch.core.attention import hybrid_attention as t_attention
from repro_torch.core.blockwise import plan_tables
from repro_torch.core.renorm import NEG_INF
from repro_torch.kernels import salo_attention as TKA
from repro_torch.kernels import salo_backward as TKB

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)

# tests/test_backward.py's six GRAD_CASES (JAX patterns; the port's are
# built field by field), then a causal sliding window with four sinks and
# 32-blocks shaped like smollm-135m's, and an asymmetric-block case.
CASES = [
    ("longformer", JP.longformer(8, n_global=2), 37, 8, 8),
    ("longformer_causal", JP.longformer(8, n_global=2, causal=True), 37, 8,
     8),
    ("vil_2d", JP.vil((5, 7), (3, 3), n_global=2), None, 8, 8),
    ("vil_2d_overlap", JP.vil((5, 4), (3, 5), n_global=1), None, 8, 8),
    ("dilated", JP.dilated_window(4, 3), 29, 8, 8),
    ("reordered_global", JP.causal_sliding_window(5, n_sinks=2, dilation=2),
     31, 8, 8),
    ("causal_sinks_smollm", JP.causal_sliding_window(40, n_sinks=4), 96, 32,
     32),
    ("asym_blocks", JP.causal_sliding_window(7), 33, 8, 16),
]


def _tpat(jpat):
    return TP.HybridSparsePattern(**{f: getattr(jpat, f) for f in (
        "window", "dilation", "n_global", "global_rows", "causal", "grid2d",
        "window2d")})


def _inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _jax_fwd_grads(impl, pat, bq, bk, q, k, v, cot):
    def loss(q_, k_, v_):
        out = j_attention(q_, k_, v_, pat, impl=impl, block_q=bq, block_k=bk)
        return jnp.sum(out * cot), out
    # jit: one compile of the whole graph is faster than eager dispatch of
    # the interpret-mode kernels
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return [np.asarray(x) for x in (out, *grads)]


def _torch_fwd_grads(impl, pat, bq, bk, q, k, v, cot):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = t_attention(qt, kt, vt, pat, impl=impl, block_q=bq, block_k=bk)
    (out * torch.tensor(cot)).sum().backward()
    return [x.detach().numpy() for x in (out, qt.grad, kt.grad, vt.grad)]


@pytest.mark.parametrize("jimpl", ["pallas_interpret", "blockwise"])
@pytest.mark.parametrize("name,pat,n,bq,bk", CASES,
                         ids=[c[0] for c in CASES])
def test_hybrid_attention_matches_jax(jimpl, name, pat, n, bq, bk):
    """Forward and the grads of sum(out * cot) (the port's plan backward:
    dQ over the forward tables, dK/dV over the packed transposed tables)
    equal the reference's."""
    n = n if n is not None else pat.seq_len()
    q, k, v, cot = _inputs([(1, 2, n, 16)] * 4, seed=0)
    want = _jax_fwd_grads(jimpl, pat, bq, bk, q, k, v, cot)
    got = _torch_fwd_grads("blockwise", _tpat(pat), bq, bk, q, k, v, cot)
    for what, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, err_msg=f"{name}: {what}", **TOL)


@pytest.mark.parametrize("jimpl", ["pallas_interpret", "blockwise"])
def test_gqa_matches_jax(jimpl):
    """GQA: KV heads expanded by copy in the port; KV grads keep
    (B, Hkv, N, D) and equal the reference's."""
    pat = JP.longformer(8, n_global=1)
    b, h, hkv, n, d = 2, 4, 2, 24, 8
    q, k, v, cot = _inputs([(b, h, n, d), (b, hkv, n, d), (b, hkv, n, d),
                            (b, h, n, d)], seed=3)
    want = _jax_fwd_grads(jimpl, pat, 8, 8, q, k, v, cot)
    for impl in ("blockwise", "pallas"):
        got = _torch_fwd_grads(impl, _tpat(pat), 8, 8, q, k, v, cot)
        for what, a, b_ in zip(("out", "dq", "dk", "dv"), got, want):
            assert a.shape == b_.shape, what
            np.testing.assert_allclose(a, b_, err_msg=f"{impl}: {what}",
                                       **TOL)


def test_dense_ref_matches_jax():
    pat = JP.vil((5, 7), (3, 3), n_global=2)
    n = pat.seq_len()
    q, k, v, cot = _inputs([(1, 2, n, 16)] * 4, seed=1)
    want = _jax_fwd_grads("dense_ref", pat, 8, 8, q, k, v, cot)
    got = _torch_fwd_grads("dense_ref", _tpat(pat), 8, 8, q, k, v, cot)
    for what, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, err_msg=what, **TOL)


def test_dead_rows_identity_and_zero_grads():
    """Rows with no reachable key: (out=0, m=NEG_INF, l=0) from the forward
    launch, as the reference kernel emits, and exactly zero, finite
    gradients through the plan backward."""
    jpat = JP.HybridSparsePattern(window=(2, 5))   # rows >= n-2: nothing
    pat = _tpat(jpat)
    n, d = 16, 8
    q, k, v, cot = _inputs([(1, n, d)] * 4, seed=4)
    empty = ~jpat.mask(n).any(axis=1)
    assert empty.sum() >= 2

    jsched = JS.schedule(jpat, n)
    jplan = jsched.plan(8, 8)
    jw = [j_working(jnp.asarray(x), jsched, jplan) for x in (q, k, v)]
    jo, jm, jl = JKA.salo_plan_attention(
        *jw, jnp.asarray(jplan.positions_padded()), plan=jplan,
        scale=d ** -0.5, interpret=True)
    plan = TS.schedule(pat, n).plan(8, 8)
    t = plan_tables(plan, torch.device("cpu"))
    out_w, m, l = TKA.salo_plan_attention(
        *(torch.tensor(x) for x in (q, k, v)), t.pos, plan=plan,
        scale=d ** -0.5)
    assert (l[0, :n][torch.from_numpy(empty)] == 0).all()
    assert (m[0, :n][torch.from_numpy(empty)] == NEG_INF).all()
    assert (out_w[0, :n][torch.from_numpy(empty)] == 0).all()
    for a, b in ((out_w, jo), (m, jm), (l, jl)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)

    got = _torch_fwd_grads("blockwise", pat, 8, 8, *(x[None] for x in
                                                      (q, k, v, cot)))
    for g in got[1:]:
        assert np.isfinite(g).all()
    assert (got[1][0, 0][empty] == 0).all()


# ----------------------- the kernel modules alone ----------------------- #
KERNEL_CASES = [c for c in CASES if c[0] in ("vil_2d", "reordered_global",
                                             "asym_blocks")]


def _kernel_io(pat, n, bq, bk, seed):
    """Working-space inputs of one plan, for both packages."""
    jsched = JS.schedule(pat, n)
    jplan = jsched.plan(bq, bk)
    b, d = 2, 16
    q, k, v, dout = _inputs([(b, jplan.n_pad, d)] * 4, seed)
    tplan = TS.schedule(_tpat(pat), n).plan(bq, bk)
    return jplan, tplan, q, k, v, dout, d ** -0.5


@pytest.mark.parametrize("name,pat,n,bq,bk", KERNEL_CASES,
                         ids=[c[0] for c in KERNEL_CASES])
def test_k1_module_matches_jax_kernel(name, pat, n, bq, bk):
    """salo_table_attention (its CPU path, the plain version) == the
    reference's K1 in interpret mode: (out, m, l)."""
    n = n if n is not None else pat.seq_len()
    jplan, tplan, q, k, v, _, scale = _kernel_io(pat, n, bq, bk, seed=7)
    pos = jplan.positions_padded()
    want = JKA.salo_table_attention(
        *(jnp.asarray(x) for x in (q, k, v)),
        jnp.asarray(pos.reshape(jplan.nq, bq)),
        jnp.asarray(pos.reshape(jplan.nkb, bk)),
        jnp.asarray(jplan.kv_blocks.reshape(-1)),
        jnp.asarray(jplan.flags.reshape(-1)), sched=jplan.sched, block_q=bq,
        block_k=bk, scale=scale, interpret=True)
    t = plan_tables(tplan, torch.device("cpu"))
    calls = TKA.salo_table_attention_plain.calls
    got = TKA.salo_table_attention(
        *(torch.tensor(x) for x in (q, k, v)), t.pos.reshape(tplan.nq, bq),
        t.pos.reshape(tplan.nkb, bk), t.kv_blocks, t.flags,
        sched=tplan.sched, scale=scale)
    assert TKA.salo_table_attention_plain.calls == calls + 1
    for what, a, b in zip(("out", "m", "l"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=what,
                                   **TOL)


@pytest.mark.parametrize("name,pat,n,bq,bk", KERNEL_CASES,
                         ids=[c[0] for c in KERNEL_CASES])
def test_k2_k3_modules_match_jax_kernels(name, pat, n, bq, bk):
    """salo_table_backward_dq / _dkv (their CPU paths) == the reference's
    K2 and K3 in interpret mode, on the forward's own (m, l, delta)."""
    n = n if n is not None else pat.seq_len()
    jplan, tplan, q, k, v, dout, scale = _kernel_io(pat, n, bq, bk, seed=8)
    pos = jplan.positions_padded()
    jpos = jnp.asarray(pos)
    jq, jk, jv, jd = (jnp.asarray(x) for x in (q, k, v, dout))
    out, m, l = JKA.salo_plan_attention(jq, jk, jv, jpos, plan=jplan,
                                        scale=scale, interpret=True)
    delta = jnp.sum(jd * out, axis=-1)
    res = (jd, delta, m, l, jq, jk, jv, jpos)
    want_dq = JKB.salo_plan_backward_dq(*res, plan=jplan, scale=scale,
                                        interpret=True)
    want_dk, want_dv = JKB.salo_plan_backward_dkv(*res, plan=jplan,
                                                  scale=scale,
                                                  interpret=True)
    t = plan_tables(tplan, torch.device("cpu"))
    tres = [torch.tensor(np.asarray(x)) for x in (jd, delta, m, l, jq, jk,
                                                  jv)]
    dq = TKB.salo_plan_backward_dq(*tres, t.pos, plan=tplan, scale=scale)
    dk, dv = TKB.salo_plan_backward_dkv(*tres, t.pos, plan=tplan,
                                        scale=scale)
    for what, a, b in (("dq", dq, want_dq), ("dk", dk, want_dk),
                       ("dv", dv, want_dv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=what,
                                   **TOL)
    # the same CPU paths against the reference's plan-level XLA scan twins
    want_sdq = JB.bwd_dq_scan(*res, plan=jplan, scale=scale)
    want_sdk, want_sdv = JB.bwd_dkv_scan(*res, plan=jplan, scale=scale)
    for what, a, b in (("dq", dq, want_sdq), ("dk", dk, want_sdk),
                       ("dv", dv, want_sdv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=f"scan {what}", **TOL)


def test_renorm_merge_matches_jax():
    """merge of two disjoint-key partials, including the empty identity
    (0, NEG_INF, 0) on some rows. Tolerance 1e-6: two exps and a sum."""
    from repro.core import renorm as JR
    from repro_torch.core import renorm as TR

    acc_a, acc_b = _inputs([(3, 5, 4)] * 2, seed=9)
    m_a, m_b, l_a, l_b = _inputs([(3, 5)] * 4, seed=10)
    l_a, l_b = np.abs(l_a), np.abs(l_b)
    acc_a[:, 0], m_a[:, 0], l_a[:, 0] = 0.0, NEG_INF, 0.0
    j = JR.merge(JR.PartialState(acc_a, m_a, l_a),
                 JR.PartialState(acc_b, m_b, l_b))
    t = TR.merge(TR.PartialState(*map(torch.tensor, (acc_a, m_a, l_a))),
                 TR.PartialState(*map(torch.tensor, (acc_b, m_b, l_b))))
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_plain_launch_counts_one_forward_two_backward():
    """One op = one forward (plain) call; its backward = one dQ and one
    dK/dV call and NO forward inside (the saved (out, m, l) are reused)."""
    pat = _tpat(JP.vil((5, 7), (3, 3), n_global=2))
    n = pat.seq_len()
    q, k, v = (torch.tensor(x, requires_grad=True)
               for x in _inputs([(1, 2, n, 16)] * 3, seed=2))
    counters = (TKA.salo_table_attention_plain,
                TKB.salo_table_backward_dq_plain,
                TKB.salo_table_backward_dkv_plain)
    before = [f.calls for f in counters]
    out = t_attention(q, k, v, pat, impl="pallas", block_q=8, block_k=8)
    assert [f.calls - b for f, b in zip(counters, before)] == [1, 0, 0]
    out.sum().backward()
    assert [f.calls - b for f, b in zip(counters, before)] == [1, 1, 1]
    kernels = (TKA.salo_table_attention, TKB.salo_table_backward_dq,
               TKB.salo_table_backward_dkv)
    assert all(f.launches == 0 for f in kernels)    # no CUDA tensor here


def test_dynamic_plan_raises_naming_roadmap():
    """plan="dynamic" is ported (tests/test_torch_dynamic.py holds it to
    the reference): without ``dynamic_keep`` it raises the reference's
    ValueError, and with it it runs."""
    pat = _tpat(JP.causal_sliding_window(8))
    x = torch.zeros((1, 1, 16, 16))
    with pytest.raises(ValueError, match="dynamic_keep"):
        t_attention(x, x, x, pat, plan="dynamic")
    out = t_attention(x, x, x, pat, plan="dynamic", dynamic_keep=2,
                      block_q=8, block_k=8)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
