"""Port parity for the recurrent families: recurrentgemma-9b (RG-LRU +
local attention, the griffin program) and mamba2-370m (SSD), each at its
``SMOKE`` shape, against the JAX reference on the CPU.

Inputs are f32, made from a seed (the JAX init, handed to the port as numpy
through ``params_from_jax``; tokens and activations from numpy).
Tolerances: the block functions (causal conv, SSD, RG-LRU scan and their
decode steps) 1e-5 (abs and rel; the same f32 algorithm, another summation
or scan order), logits 1e-5, loss 1e-6 (rel), every gradient 1e-4 (the
reference's own gradient bar), ``decode_step`` logits 1e-5, greedy tokens
exact. The port's own decode against its own forward: 1e-4 (the
reference's ``test_recurrent_decode_matches_forward`` holds JAX to 5e-2;
the port's f32 paths agree far closer).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_smoke as j_smoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.ft import checkpoint as j_ck
from repro.models import rglru as JRG
from repro.models import ssm as JSSM
from repro.models.model import build_model as j_build
from repro.optim import adamw as j_adamw
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs as TC
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_smoke as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.ft import checkpoint as t_ck
from repro_torch.kernels import salo_attention as TKA
from repro_torch.kernels import salo_backward as TKB
from repro_torch.models import rglru as TRG
from repro_torch.models import ssm as TSSM
from repro_torch.models.model import build_model as t_build
from repro_torch.optim import adamw as t_adamw
from repro_torch.serve.engine import (ContinuousConfig, ContinuousEngine,
                                      ServeConfig, ServeEngine)
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("recurrentgemma-9b", "mamba2-370m")
SEQ, BATCH = 64, 2


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _models(arch, seed=0, **fields):
    jcfg = dataclasses.replace(j_smoke(arch), **fields)
    tcfg = dataclasses.replace(t_smoke(arch), **fields)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tparams = params_from_jax(_np(jparams), "cpu")
    return jcfg, tcfg, (jmodel, jparams), (t_build(tcfg, "cpu"), tparams)


def _block_params(arch, part):
    """One layer's ``part`` sub-dict of the smoke model, as (JAX, port)."""
    jcfg, tcfg, (_, jp), (_, tp) = _models(arch)
    key = next(k for k in jp if k.startswith("seg0_"))
    jblock = jax.tree.map(lambda a: a[0], jp[key])
    tblock = tp[key][0]
    if arch == "recurrentgemma-9b":          # griffin: its first rec block
        jblock, tblock = jblock["r1"], tblock["r1"]
    return jcfg, tcfg, jblock[part], tblock[part]


# ============================== configs ================================ #
def test_registry_lists_the_recurrent_archs():
    assert set(ARCHS) <= set(TC.ARCHS)
    rg, m2 = t_config("recurrentgemma-9b"), t_config("mamba2-370m")
    assert (rg.n_layers, rg.d_model, rg.n_heads, rg.n_kv_heads, rg.hd,
            rg.d_ff, rg.vocab_size, rg.recurrent.local_window,
            rg.salo.window, rg.salo.n_global) == (
        38, 4096, 16, 1, 256, 12288, 256000, 2048, 2048, 4)
    assert (m2.n_layers, m2.d_model, m2.ssm.d_state, m2.ssm.head_dim,
            m2.ssm.expand, m2.ssm.chunk, m2.salo.enabled) == (
        48, 1024, 128, 64, 2, 128, False)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    """CONFIG and SMOKE equal the reference's field for field, and the
    programs are the reference's."""
    for jget, tget in ((j_config, t_config), (j_smoke, t_smoke)):
        assert dataclasses.asdict(tget(arch)) == \
            dataclasses.asdict(jget(arch))
        assert t_build(tget(arch), "cpu").program == \
            j_build(jget(arch)).program
    assert t_build(t_config("recurrentgemma-9b"), "cpu").program == [
        ("griffin", 12), ("rec_mlp", 2)]


# =========================== block functions =========================== #
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32) if with_state \
        else None
    for jact, tact in ((jax.nn.silu, torch.nn.functional.silu),
                       (None, None)):
        jy, js = JSSM._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                   None if st is None else jnp.asarray(st),
                                   act=jact)
        ty, ts = TSSM._causal_conv(_t(x), _t(w),
                                   None if st is None else _t(st), act=tact)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("chunk", [8, 16])
def test_ssd_chunked_matches_jax(chunk):
    rng = np.random.default_rng(1)
    B, T, H, P, N = 2, 32, 3, 4, 5
    x = rng.normal(size=(B, T, H, P)).astype(np.float32)
    Bm = rng.normal(size=(B, T, N)).astype(np.float32)
    Cm = rng.normal(size=(B, T, N)).astype(np.float32)
    a = -rng.uniform(0.0, 1.5, size=(B, T, H)).astype(np.float32)
    want = JSSM.ssd_chunked(*(jnp.asarray(v) for v in (x, Bm, Cm, a)), chunk)
    got = TSSM.ssd_chunked(_t(x), _t(Bm), _t(Cm), _t(a), chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ssd_chunked_gradient_is_finite_where_exp_overflows():
    """A masked pair's exp(L) overflows f32 at a steep decay over a chunk;
    the port masks L before the exp, so the gradient stays finite (the
    values are the reference's where(causal, exp(L), 0))."""
    rng = np.random.default_rng(2)
    B, T, H, P, N = 1, 16, 2, 4, 3
    x = _t(rng.normal(size=(B, T, H, P)).astype(np.float32))
    Bm, Cm = (_t(rng.normal(size=(B, T, N)).astype(np.float32))
              for _ in range(2))
    a = torch.full((B, T, H), -8.0, requires_grad=True)   # 15 x 8 > 88.7
    y = TSSM.ssd_chunked(x, Bm, Cm, a, 16)
    y.sum().backward()
    assert torch.isfinite(y).all() and torch.isfinite(a.grad).all()


@pytest.mark.parametrize("a_val,finite", [(-8.0, False), (-1.0, True)])
def test_reference_ssd_gradient_overflows_where_the_port_masks(a_val,
                                                               finite):
    """The reference's own gradient, pinned (ROADMAP "Known differences"):
    ``jax.grad`` of ``repro.models.ssm.ssd_chunked`` over one 16-step
    chunk is non-finite at a = -8, where a masked pair's exp(L) overflows
    f32 and ``where(causal, exp(L), 0)`` passes 0 x inf back, and finite
    at a = -1; the port's gradient is finite at both."""
    rng = np.random.default_rng(2)
    B, T, H, P, N = 1, 16, 2, 4, 3
    x = rng.normal(size=(B, T, H, P)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, T, N)).astype(np.float32)
              for _ in range(2))
    a = np.full((B, T, H), a_val, np.float32)
    jg = jax.grad(lambda a_: JSSM.ssd_chunked(
        jnp.asarray(x), jnp.asarray(Bm), jnp.asarray(Cm), a_, 16).sum())(
        jnp.asarray(a))
    assert bool(np.isfinite(np.asarray(jg)).all()) == finite
    ta = _t(a).requires_grad_()
    TSSM.ssd_chunked(_t(x), _t(Bm), _t(Cm), ta, 16).sum().backward()
    assert torch.isfinite(ta.grad).all()


def test_ssm_apply_matches_jax():
    jcfg, tcfg, jp, tp = _block_params("mamba2-370m", "ssm")
    x = np.random.default_rng(3).normal(size=(2, 32, jcfg.d_model)) \
        .astype(np.float32)
    want = JSSM.ssm_apply(jp, jnp.asarray(x), jcfg)
    got = TSSM.ssm_apply(tp, _t(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ssm_decode_matches_jax():
    jcfg, tcfg, jp, tp = _block_params("mamba2-370m", "ssm")
    d_inner, H, N, P = TSSM._dims(tcfg)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
    conv = rng.normal(size=(2, 3, d_inner + 2 * N)).astype(np.float32)
    st = rng.normal(size=(2, H, N, P)).astype(np.float32)
    want = JSSM.ssm_decode(jp, *(jnp.asarray(v) for v in (x, conv, st)),
                           jcfg)
    got = TSSM.ssm_decode(tp, _t(x), _t(conv), _t(st), tcfg)
    assert got[2].dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("T,with_h0", [(13, False), (13, True), (37, True),
                                       (64, False)])
def test_rglru_core_matches_associative_scan(T, with_h0):
    """The parallel scan against ``jax.lax.associative_scan`` (the
    reference's ``_rglru_core``), T not a power of two, with and without
    an initial state folded into step 0."""
    jcfg, tcfg, jp, tp = _block_params("recurrentgemma-9b", "rec")
    rng = np.random.default_rng(T)
    xr = rng.normal(size=(2, T, jcfg.d_model)).astype(np.float32)
    h0 = rng.normal(size=(2, jcfg.d_model)).astype(np.float32) \
        if with_h0 else None
    jh, jlast = JRG._rglru_core(jp, jnp.asarray(xr),
                                None if h0 is None else jnp.asarray(h0))
    th, tlast = TRG._rglru_core(tp, _t(xr), None if h0 is None else _t(h0))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)


@pytest.mark.parametrize("T", [5, 64, 1000])
def test_linear_scan_is_log_depth(T):
    """No loop over T: ceil(log2 T) passes of two concatenations each (one
    on the last), whatever T; the result equals the sequential
    recurrence."""
    calls = []
    real_cat = torch.cat

    def counting_cat(*a, **k):
        calls.append(1)
        return real_cat(*a, **k)

    g = torch.Generator().manual_seed(T)
    a = torch.rand((2, T, 3), generator=g, dtype=torch.float64)
    b = torch.randn((2, T, 3), generator=g, dtype=torch.float64)
    torch.cat = counting_cat
    try:
        h = TRG.linear_scan(a, b)
    finally:
        torch.cat = real_cat
    passes = (T - 1).bit_length()
    assert len(calls) == 2 * passes - 1
    want, s = [], torch.zeros((2, 3), dtype=torch.float64)
    for t in range(T):
        s = a[:, t] * s + b[:, t]
        want.append(s)
    torch.testing.assert_close(h, torch.stack(want, 1), rtol=1e-12,
                               atol=1e-12)


def test_rglru_apply_matches_jax():
    jcfg, tcfg, jp, tp = _block_params("recurrentgemma-9b", "rec")
    x = np.random.default_rng(5).normal(size=(2, 29, jcfg.d_model)) \
        .astype(np.float32)
    want = JRG.rglru_apply(jp, jnp.asarray(x), jcfg)
    got = TRG.rglru_apply(tp, _t(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rglru_decode_matches_jax():
    jcfg, tcfg, jp, tp = _block_params("recurrentgemma-9b", "rec")
    rng = np.random.default_rng(6)
    d = jcfg.d_model
    x = rng.normal(size=(2, 1, d)).astype(np.float32)
    conv = rng.normal(size=(2, 3, d)).astype(np.float32)
    h = rng.normal(size=(2, d)).astype(np.float32)
    want = JRG.rglru_decode(jp, *(jnp.asarray(v) for v in (x, conv, h)),
                            jcfg)
    got = TRG.rglru_decode(tp, _t(x), _t(conv), _t(h), tcfg)
    assert got[2].dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# ============================ whole models ============================= #
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(arch):
    """Logits within 1e-5, loss within 1e-6 and the gradient of every
    parameter within 1e-4 of the reference's, on one SyntheticLM batch."""
    jcfg, tcfg, (jm, jp), (tm, tp) = _models(arch)
    batch = JSyntheticLM(jcfg, JDataConfig(SEQ, BATCH, seed=0)).batch(0)
    jlogits = np.asarray(jax.jit(jm.forward)(jp, batch))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jp, batch)
    tbatch = {k: _t(v) for k, v in batch.items()}
    for leaf in tree_leaves(tp):
        leaf.requires_grad_()
    tlogits = tm.forward(tp, tbatch)
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits, **TOL)
    tloss, _ = tm.loss(tp, tbatch)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-6)
    tloss.backward()
    want = tree_leaves(params_from_jax(_np(jgrads), "cpu"))
    got = [x.grad for x in tree_leaves(tp)]
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_logits_match_jax(arch):
    """16 lockstep decode steps (recurrentgemma: past its local window of
    16 after step 15, the two sinks kept): logits within 1e-5 at every
    step, and the caches' dtypes kept (recurrent state f32)."""
    jcfg, tcfg, (jm, jp), (tm, tp) = _models(arch)
    B, n = 2, 16
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, n))
    jc, tc = jm.init_cache(B, n + 4), tm.init_cache(B, n + 4)
    step = jax.jit(jm.decode_step)
    for t in range(n):
        jl, jc = step(jp, jc, {"tokens": jnp.asarray(toks[:, t:t + 1])}, t)
        tl, tc = tm.decode_step(tp, tc, {"tokens": _t(toks[:, t:t + 1])}, t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"step {t}", **TOL)
    jflat = dict(j_ck._flatten(jc, upcast=False)[0])
    tflat = t_ck._flatten(tc)
    assert sorted(jflat) == sorted(tflat)
    for k, v in jflat.items():
        assert tflat[k].dtype == v.dtype, k
        np.testing.assert_allclose(tflat[k], v, err_msg=k, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_decode_matches_forward(arch):
    """The port's recurrent decode equals its own chunked / scanned full
    forward (the reference's ``test_recurrent_decode_matches_forward``)."""
    _, tcfg, _, (tm, tp) = _models(arch)
    B, S = 2, 32
    toks = np.random.default_rng(7).integers(0, tcfg.vocab_size, (B, S))
    full = tm.forward(tp, {"tokens": _t(toks)})
    cache = tm.init_cache(B, S)
    outs = []
    for t in range(S):
        logits, cache = tm.decode_step(tp, cache,
                                       {"tokens": _t(toks[:, t:t + 1])}, t)
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_greedy_tokens_identical(arch):
    """Prompt 20 (past recurrentgemma's 16-slot local window), 12 new
    tokens: the lockstep engines' greedy tokens are identical."""
    jcfg, tcfg, (jm, jp), (tm, tp) = _models(arch)
    prompts = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 20))
    want = JServeEngine(jm, JServeConfig(max_len=32)).generate(
        jp, jnp.asarray(prompts), 12)
    got = ServeEngine(tm, ServeConfig(max_len=32)).generate(tp, prompts, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engine_refuses_recurrent_programs(arch):
    tm = t_build(t_smoke(arch), "cpu")
    with pytest.raises(NotImplementedError, match="attention blocks"):
        ContinuousEngine(tm, ContinuousConfig(n_pages=9), device="cpu")


# ========================= griffin and training ======================== #
def _loss_grads(tcfg, np_params, batch):
    tm = t_build(tcfg, "cpu")
    tp = params_from_jax(np_params, "cpu")
    leaves = tree_leaves(tp)
    for x in leaves:
        x.requires_grad_()
    loss, _ = tm.loss(tp, {k: _t(v) for k, v in batch.items()})
    return loss.detach(), torch.autograd.grad(loss, leaves)


def test_remat_policies_give_equal_losses():
    """recurrentgemma with two griffin groups and a trailing rec_mlp
    segment (7 layers): remat none, full (a whole griffin group as one
    unit) and dots give equal losses and gradients."""
    jcfg, tcfg, (_, jp), _ = _models("recurrentgemma-9b", n_layers=7)
    batch = JSyntheticLM(jcfg, JDataConfig(SEQ, BATCH, seed=1)).batch(0)
    runs = {r: _loss_grads(dataclasses.replace(tcfg, remat=r), _np(jp),
                           batch)
            for r in ("none", "full", "dots")}
    for r in ("full", "dots"):
        np.testing.assert_allclose(float(runs[r][0]), float(runs["none"][0]),
                                   rtol=1e-6)
        for a, b in zip(runs[r][1], runs["none"][1]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-7)


def test_plain_kernel_calls_per_griffin_group():
    """Under remat full a grad runs, per griffin group (its one local
    attention layer), K1 twice (forward and replay), K2 once and K3 once;
    the rec_mlp segment runs none."""
    jcfg, tcfg, (_, jp), _ = _models("recurrentgemma-9b", n_layers=7)
    assert t_build(tcfg, "cpu").program == [("griffin", 2), ("rec_mlp", 1)]
    batch = JSyntheticLM(jcfg, JDataConfig(SEQ, BATCH, seed=1)).batch(0)
    fns = (TKA.salo_table_attention_plain, TKB.salo_table_backward_dq_plain,
           TKB.salo_table_backward_dkv_plain)
    before = [f.calls for f in fns]
    _loss_grads(dataclasses.replace(tcfg, remat="full"), _np(jp), batch)
    assert [f.calls - b for f, b in zip(fns, before)] == [4, 2, 2]


def test_params_from_jax_raises_on_an_extra_griffin_leaf():
    _, _, (_, jp), _ = _models("recurrentgemma-9b")
    tree = _np(jp)
    tree["seg0_griffin"]["r2"]["rec"]["extra"] = \
        tree["seg0_griffin"]["r2"]["rec"]["lam"]
    with pytest.raises(ValueError, match="seg0_griffin/r2/rec"):
        params_from_jax(tree, "cpu")
    tree = _np(jp)
    tree["seg0_griffin"]["a"]["bogus"] = {"w": np.zeros((1, 2), np.float32)}
    with pytest.raises(ValueError, match="bogus"):
        params_from_jax(tree, "cpu")


def test_train_checkpoint_keys_equal_reference(tmp_path):
    """{"params", "opt"} of recurrentgemma's smoke model (griffin's nested
    r1/r2/a parameters, one list entry a group): the port's checkpoint
    keys equal ``repro.ft.checkpoint._flatten``'s of the same tree, and a
    checkpoint crosses between the packages both ways bit-equal."""
    _, _, _, (_, tp) = _models("recurrentgemma-9b")
    jparams = tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    jtree = {"params": jparams,
             "opt": j_adamw.init(j_adamw.AdamWConfig(), jparams)}
    ttree = {"params": tp, "opt": t_adamw.init(t_adamw.AdamWConfig(), tp)}
    jflat, _ = j_ck._flatten(jtree)
    tflat = t_ck._flatten(ttree)
    assert sorted(tflat) == sorted(jflat)
    assert {"params::seg0_griffin::0::r1::rec::lam",
            "params::seg0_griffin::0::a::attn::wq",
            "opt::.m::seg0_griffin::0::r2::mlp::w_gate"} <= set(tflat)
    for k in jflat:
        np.testing.assert_array_equal(tflat[k], jflat[k])
    j_ck.save(str(tmp_path / "j"), jtree, 3)
    got = t_ck.restore(tmp_path / "j", ttree)
    for a, b in zip(tree_leaves(got["params"]), tree_leaves(tp)):
        assert torch.equal(a, b)
    t_ck.save(tmp_path / "t", ttree, 3)
    back = j_ck.restore(str(tmp_path / "t"), jtree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ================================ CLIs ================================= #
@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_loss_falls(arch, capsys):
    from repro_torch.launch.train import main

    final = main(["--arch", arch, "--smoke", "--device", "cpu",
                  "--steps", "20", "--seq", "64", "--batch", "4", "--lr",
                  "5e-3", "--data-branch", "2", "--data-docs", "4"])
    out = capsys.readouterr().out
    first = float(out.split("step     0 loss")[1].split()[0])
    assert final < first - 0.5, out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_lockstep(arch, capsys):
    from repro_torch.launch.serve import main

    toks = main(["--arch", arch, "--smoke", "--device", "cpu", "--engine",
                 "lockstep", "--batch", "2", "--prompt-len", "20",
                 "--new-tokens", "6"])
    assert toks.shape == (2, 6)
    assert "engine=lockstep" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_continuous_raises(arch):
    from repro_torch.launch.serve import main

    with pytest.raises(NotImplementedError, match="attention blocks"):
        main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
              "--prompt-len", "8", "--new-tokens", "2"])
