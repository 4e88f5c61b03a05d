"""Port parity for the dense attention configs: gemma-7b, phi4-mini-3.8b,
granite-3-8b and longformer-4k (each at its ``SMOKE`` shape), and the ViL
stage patterns, against the JAX reference on the CPU.

Inputs are f32, made from a seed (the JAX init, handed to the port as numpy
through ``params_from_jax``; tokens from numpy). Tolerances: logits 1e-5
(abs and rel), loss 1e-6 (rel), every gradient 1e-4 (the reference's own
gradient bar: the same f32 algorithm summed in another order),
``decode_step`` logits 1e-5, greedy tokens exact. The kernel modules at
head dim 256 (gemma-7b's) against the Pallas kernels in interpret mode:
1e-4, as ``tests/test_torch_attention.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_smoke
from repro.configs import vil as JV
from repro.core import patterns as JP
from repro.core import scheduler as JS
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.kernels import salo_attention as JKA
from repro.kernels import salo_backward as JKB
from repro.models.layers import salo_pattern as j_pattern
from repro.models.model import build_model as j_build
from repro.serve.engine import ContinuousConfig as JConfig
from repro.serve.engine import ContinuousEngine as JEngine
from repro_torch import configs as TC
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_smoke as t_smoke
from repro_torch.configs import vil as TV
from repro_torch.convert import params_from_jax
from repro_torch.core import patterns as TP
from repro_torch.core import scheduler as TS
from repro_torch.core.blockwise import plan_tables
from repro_torch.kernels import salo_attention as TKA
from repro_torch.kernels import salo_backward as TKB
from repro_torch.models.model import build_model as t_build
from repro_torch.serve.engine import ContinuousConfig as TConfig
from repro_torch.serve.engine import ContinuousEngine as TEngine
from repro_torch.serve.paged_cache import layout_for_pattern
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)
DENSE = ("gemma-7b", "phi4-mini-3.8b", "granite-3-8b", "longformer-4k")
CAUSAL = ("gemma-7b", "phi4-mini-3.8b", "granite-3-8b")
SEQ, BATCH = 64, 2


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _amplify(params, gain=6.0):
    """Scale every residual branch's output projection, so greedy tokens
    depend on attention (at the plain init the tied embedding dominates)."""
    seg = dict(params["seg0_attn_mlp"])
    seg["attn"] = dict(seg["attn"], wo=seg["attn"]["wo"] * gain)
    seg["mlp"] = dict(seg["mlp"], w_out=seg["mlp"]["w_out"] * gain)
    return dict(params, seg0_attn_mlp=seg)


def _models(arch, seed=0, amplify=False):
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    if amplify:
        jparams = _amplify(jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, (jmodel, jparams), (t_build(tcfg, "cpu"), tparams)


def test_archs_list_the_dense_configs():
    """The registry lists all 11 of the reference's archs, and each is the
    reference's config field for field (CONFIG at its published shape, and
    SMOKE)."""
    from repro.configs import ARCHS as J_ARCHS
    from repro.configs import get_config as j_config
    assert TC.ARCHS == ("smollm-135m",) + DENSE + (
        "recurrentgemma-9b", "mamba2-370m", "arctic-480b", "kimi-k2-1t-a32b",
        "qwen2-vl-2b", "whisper-base")
    assert sorted(TC.ARCHS) == sorted(J_ARCHS) and len(TC.ARCHS) == 11
    for arch in TC.ARCHS:
        for jget, tget in ((j_config, t_config), (j_smoke, t_smoke)):
            assert dataclasses.asdict(tget(arch)) == \
                dataclasses.asdict(jget(arch)), arch
    g = t_config("gemma-7b")
    assert (g.n_layers, g.d_model, g.n_heads, g.hd, g.d_ff, g.vocab_size,
            g.act, g.tie_embeddings, g.logit_softcap) == (
        28, 3072, 16, 256, 24576, 256000, "geglu", True, 30.0)
    lf = t_config("longformer-4k").salo
    assert (lf.window, lf.n_global, lf.bidirectional, lf.global_rows) == (
        512, 1, True, True)


@pytest.mark.parametrize("arch", DENSE)
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
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits,
                               **LOGIT_TOL)
    tloss, _ = tm.loss(tp, tbatch)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-6)
    tloss.backward()
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jgrads),
                                       "cpu"))
    got = [x.grad for x in tree_leaves(tp)]
    assert len(got) == len(want) > 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("arch", CAUSAL)
def test_decode_step_logits_match_jax(arch):
    """20 lockstep decode steps past the smoke window of 16: logits within
    1e-5 at every step."""
    jcfg, tcfg, (jm, jp), (tm, tp) = _models(arch, amplify=True)
    B, n = 2, 20
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, n))
    jc, tc = jm.init_cache(B, n), tm.init_cache(B, n)
    step = jax.jit(jm.decode_step)
    for t in range(n):
        jl, jc = step(jp, jc, {"tokens": jnp.asarray(toks[:, t:t + 1])}, t)
        tl, tc = tm.decode_step(tp, tc, {"tokens": _t(toks[:, t:t + 1])}, t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"step {t}", **LOGIT_TOL)


def _engines(arch, page=8, chunk=8, max_batch=4):
    jcfg, tcfg, (jm, jp), (tm, tp) = _models(arch, amplify=True)
    lay = layout_for_pattern(j_pattern(jcfg, causal=True), page)
    n_pages = 1 + max_batch * lay.pages_per_req
    jeng = JEngine(jm, JConfig(n_pages=n_pages, page=page, chunk=chunk,
                               max_batch=max_batch))
    teng = TEngine(tm, TConfig(n_pages=n_pages, page=page, chunk=chunk,
                               max_batch=max_batch), device="cpu")
    return jcfg, (jeng, jp), (teng, tp)


def _serve_both(arch, lens, n_new):
    jcfg, (jeng, jp), (teng, tp) = _engines(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab_size, (n,)).astype(np.int32)
               for n in lens]
    jr = [jeng.submit(p, n_new) for p in prompts]
    tr = [teng.submit(p, n_new) for p in prompts]
    jo, to = jeng.run(jp), teng.run(tp)
    return [jo[r] for r in jr], [to[r] for r in tr], jeng, teng


def test_gemma_engine_greedy_tokens_identical():
    """gemma's smoke (geglu, logit softcap, tied embeddings) on the
    continuous engine: ragged prompts past the window, greedy tokens and
    counters identical to the JAX engine's."""
    jo, to, jeng, teng = _serve_both("gemma-7b", (5, 9, 13, 26), 8)
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(a, b)
    assert len({int(x) for o in to for x in o}) > 4
    assert dict(jeng.counters) == dict(teng.counters)


def test_longformer_engine_matches_jax():
    """longformer is bidirectional; both continuous engines take its
    pattern's causal form (salo_pattern(cfg, causal=True): the window's
    left half and the sinks), so they serve it with the same tokens."""
    assert j_pattern(j_smoke("longformer-4k"), causal=True).causal
    jo, to, jeng, teng = _serve_both("longformer-4k", (7, 20, 33), 6)
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(a, b)
    assert dict(jeng.counters) == dict(teng.counters)


@pytest.mark.parametrize("arch", ["whisper-base", "qwen2-vl-2b",
                                  "longformer-4k"])
@pytest.mark.parametrize("shape", ["CONFIG", "SMOKE"])
def test_salo_patterns_match_reference(arch, shape):
    """The port's ``salo_pattern`` gives the reference's
    ``HybridSparsePattern`` field for field: the causal decoder pattern
    and the bidirectional encoder pattern (whisper's encoder:
    ``longformer(window, n_global)``, global rows whatever
    ``salo.global_rows`` says), and the same dense mask."""
    from repro.configs import get_config as j_config
    from repro_torch.models.layers import salo_pattern as t_pattern

    jcfg = (j_config if shape == "CONFIG" else j_smoke)(arch)
    tcfg = (t_config if shape == "CONFIG" else t_smoke)(arch)
    fields = [f.name for f in dataclasses.fields(TP.HybridSparsePattern)]
    for causal in (True, False):
        kw = {} if causal else dict(salo=dataclasses.replace(
            jcfg.salo, bidirectional=True))
        tkw = {} if causal else dict(salo=dataclasses.replace(
            tcfg.salo, bidirectional=True))
        j = j_pattern(jcfg, causal=causal, **kw)
        t = t_pattern(tcfg, causal=causal, **tkw)
        assert {f: getattr(t, f) for f in fields} == \
            {f: getattr(j, f) for f in fields}, (arch, causal)
        np.testing.assert_array_equal(t.mask(40), j.mask(40))
    if arch == "whisper-base":
        enc = t_pattern(tcfg, causal=False, salo=dataclasses.replace(
            tcfg.salo, bidirectional=True))
        assert not tcfg.salo.global_rows and enc.global_rows
        assert enc.n_global == tcfg.salo.n_global and not enc.causal


@pytest.mark.parametrize("stage", ["VIL_STAGE1", "VIL_STAGE2"])
def test_vil_stage_masks_match_jax(stage):
    """The paper's Table 2 ViL stages: the same fields and the same dense
    mask as repro.configs.vil's."""
    j, t = getattr(JV, stage), getattr(TV, stage)
    assert {k: v for k, v in t.items() if k != "pattern"} == \
        {k: v for k, v in j.items() if k != "pattern"}
    n = j["pattern"].seq_len()
    assert t["pattern"].seq_len() == n == 1 + j["grid"][0] * j["grid"][1]
    np.testing.assert_array_equal(t["pattern"].mask(n), j["pattern"].mask(n))


# ------------------- the kernel modules at head dim 256 ------------------ #
# gemma-7b's head dim; the patterns of gemma (causal window + sinks) and of
# longformer (bidirectional window, one global token with global rows), cut
# to a small n.
HD256_CASES = [
    ("gemma_like", JP.causal_sliding_window(40, n_sinks=4), 96, 32, 32),
    ("longformer_like", JP.longformer(16, n_global=1), 70, 32, 64),
]


def _tpat(jpat):
    return TP.HybridSparsePattern(**{f: getattr(jpat, f) for f in (
        "window", "dilation", "n_global", "global_rows", "causal", "grid2d",
        "window2d")})


@pytest.mark.parametrize("name,pat,n,bq,bk", HD256_CASES,
                         ids=[c[0] for c in HD256_CASES])
def test_kernel_modules_at_hd256_match_jax_kernels(name, pat, n, bq, bk):
    """K1 (out, m, l), K2 (dq) and K3 (dk, dv) at hd 256, their CPU paths
    (the plain versions), against the Pallas kernels in interpret mode."""
    jplan = JS.schedule(pat, n).plan(bq, bk)
    tplan = TS.schedule(_tpat(pat), n).plan(bq, bk)
    rng = np.random.default_rng(11)
    d = 256
    q, k, v, dout = (rng.normal(size=(2, jplan.n_pad, d)).astype(np.float32)
                     for _ in range(4))
    scale = d ** -0.5
    jpos = jnp.asarray(jplan.positions_padded())
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
    got = TKA.salo_plan_attention(*(torch.tensor(x) for x in (q, k, v)),
                                  t.pos, plan=tplan, scale=scale)
    for what, a, b in zip(("out", "m", "l"), got, (out, m, l)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=what,
                                   **KERNEL_TOL)
    tres = [torch.tensor(np.asarray(x)) for x in (jd, delta, m, l, jq, jk,
                                                  jv)]
    dq = TKB.salo_plan_backward_dq(*tres, t.pos, plan=tplan, scale=scale)
    dk, dv = TKB.salo_plan_backward_dkv(*tres, t.pos, plan=tplan,
                                        scale=scale)
    for what, a, b in (("dq", dq, want_dq), ("dk", dk, want_dk),
                       ("dv", dv, want_dv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=what,
                                   **KERNEL_TOL)


def test_kernel_wrappers_take_hd256():
    """hd 256 passes the training kernels' operand check (it raised before
    the kernels took it); other head dims still raise."""
    x = torch.zeros((1, 32, 256))
    TKA.check_kernel_operands("k", (x,), dtype=torch.bfloat16, hd=256,
                              block_q=256, block_k=256)
    with pytest.raises(ValueError, match="head_dim"):
        TKA.check_kernel_operands("k", (x,), dtype=torch.bfloat16, hd=96,
                                  block_q=256, block_k=256)
