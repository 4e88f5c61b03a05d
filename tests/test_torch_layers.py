"""Port parity: layer functions of the serving path with reference weights
converted by ``params_from_jax``, on the smollm smoke config at f32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_smoke
from repro.core.scheduler import (PAD_SENTINEL, build_chunk_plan,
                                  ring_view_positions)
from repro.models import layers as JL
from repro.models.model import build_model as j_build
from repro.serve.paged_cache import layout_for_pattern
from repro_torch.configs import get_smoke as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as TL

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)     # f32 end to end


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = j_smoke("smollm-135m"), t_smoke("smollm-135m")
    jparams = jax.tree.map(np.asarray,
                           j_build(jcfg).init(jax.random.PRNGKey(0)))
    tparams = params_from_jax(jparams, device="cpu")
    jlayer = jax.tree.map(lambda a: a[0], jparams["seg0_attn_mlp"])
    tlayer = tparams["seg0_attn_mlp"][0]
    return jcfg, tcfg, jlayer, tlayer


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_rmsnorm_and_rope(weights):
    jcfg, _, jl, tl = weights
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    scale = rng.standard_normal(jcfg.d_model).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        TL.rmsnorm({"scale": _t(scale)}, _t(x)).numpy(),
        np.asarray(JL.rmsnorm({"scale": scale}, x)), **TOL)
    xr = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 3000, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(TL.rope(_t(xr), _t(pos)).numpy(),
                               np.asarray(JL.rope(xr, pos)), **TOL)


def test_mlp_apply(weights):
    jcfg, tcfg, jl, tl = weights
    x = np.random.default_rng(1).standard_normal(
        (2, 4, jcfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(
        TL.mlp_apply(tl["mlp"], _t(x), tcfg).numpy(),
        np.asarray(JL.mlp_apply(jl["mlp"], x, jcfg)), **TOL)


@pytest.mark.parametrize("c0,clen", [(0, 8), (13, 8), (40, 5)])
def test_attn_chunk_prefill(weights, c0, clen):
    jcfg, tcfg, jl, tl = weights
    rng = np.random.default_rng(c0)
    jpat = JL.salo_pattern(jcfg)
    tpat = TL.salo_pattern(tcfg)
    page = 8
    lay = layout_for_pattern(jpat, page)
    plan = build_chunk_plan(jpat, c0, clen, n_sink=lay.n_sink,
                            ring_cap=lay.ring_cap, block=page, chunk_pad=8)
    kv, fl = plan.padded_tables(plan.nq, plan.max_steps)
    S = lay.n_sink + lay.ring_cap
    hkv, hd = jcfg.n_kv_heads, jcfg.hd
    x = rng.standard_normal((1, 8, jcfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((1, S, hkv, hd)).astype(np.float32)
    cv = rng.standard_normal((1, S, hkv, hd)).astype(np.float32)
    ctx_pos = plan.view_positions[None, :S].copy()
    pos_q = np.full((1, 8), PAD_SENTINEL, np.int32)
    pos_q[0, :clen] = np.arange(c0, c0 + clen)
    ref = JL.attn_chunk_prefill(jl["attn"], x, ck, cv, ctx_pos, pos_q, kv,
                                fl, jcfg, jpat)
    out = TL.attn_chunk_prefill(tl["attn"], *map(_t, (x, ck, cv, ctx_pos,
                                                      pos_q, kv, fl)),
                                tcfg, tpat)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_attn_decode_paged(weights):
    jcfg, tcfg, jl, tl = weights
    rng = np.random.default_rng(5)
    jpat, tpat = JL.salo_pattern(jcfg), TL.salo_pattern(tcfg)
    page = 8
    lay = layout_for_pattern(jpat, page)
    R, npp = 3, lay.pages_per_req
    n_pages = 1 + R * npp
    hkv, hd = jcfg.n_kv_heads, jcfg.hd
    ks = rng.standard_normal((n_pages, page, hkv, hd)).astype(np.float32)
    vs = rng.standard_normal((n_pages, page, hkv, hd)).astype(np.float32)
    pt = (1 + rng.permutation(n_pages - 1)).reshape(R, npp).astype(np.int32)
    t = np.asarray([4, 19, 70], np.int32)
    pos = np.stack([ring_view_positions(int(x) + 1, lay.n_sink,
                                        lay.ring_cap, lay.n_global)
                    for x in t]).astype(np.int32)
    phys, off = (np.asarray(a) for a in lay.write_target(pt, t))
    x = rng.standard_normal((R, 1, jcfg.d_model)).astype(np.float32)
    ref = JL.attn_decode_paged(jl["attn"], x, jnp.asarray(ks),
                               jnp.asarray(vs), pt, pos, t, phys, off, jcfg,
                               jpat)
    tk, tv = _t(ks.copy()), _t(vs.copy())
    res = TL.attn_decode_paged(tl["attn"], _t(x), tk, tv, _t(pt), _t(pos),
                               _t(t), _t(phys.astype(np.int32)),
                               _t(off.astype(np.int32)), tcfg, tpat)
    # the reference's (out, k_slab, v_slab, k_scale, v_scale, page_m)
    # contract; the slabs are the ones passed in, written in place
    assert len(res) == len(ref) == 6
    assert res[1] is tk and res[2] is tv and res[3:] == (None, None, None)
    out = res[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref[0]), **TOL)
    # the in-place slab write equals the reference's functional one
    np.testing.assert_allclose(tk.numpy()[1:], np.asarray(ref[1])[1:], **TOL)
    np.testing.assert_allclose(tv.numpy()[1:], np.asarray(ref[2])[1:], **TOL)
    assert not np.array_equal(tk.numpy(), ks)


def test_embed_and_logits(weights):
    jcfg, tcfg, _, _ = weights
    jparams = j_build(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tok = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 7))
    jx = JL.embed_apply(jparams["embed"], jnp.asarray(tok), jcfg)
    tx = TL.embed_apply(tparams["embed"], _t(tok), tcfg)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(
        TL.logits_apply(tparams["embed"], None, tx, tcfg).numpy(),
        np.asarray(JL.logits_apply(jparams["embed"], None, jx, jcfg)), **TOL)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_apply_activations(weights, act):
    """Every MLP activation against the reference's; GELU is
    tanh-approximate on both sides (jax.nn.gelu's default)."""
    import dataclasses

    jcfg, tcfg, jl, tl = weights
    jcfg, tcfg = (dataclasses.replace(c, act=act) for c in (jcfg, tcfg))
    x = np.random.default_rng(6).standard_normal(
        (2, 4, jcfg.d_model)).astype(np.float32) * 3.0
    np.testing.assert_allclose(
        TL.mlp_apply(tl["mlp"], _t(x), tcfg).numpy(),
        np.asarray(JL.mlp_apply(jl["mlp"], x, jcfg)), **TOL)


@pytest.mark.parametrize("act", ["geglu", "gelu"])
def test_model_forward_and_loss_match_jax_per_activation(act):
    """A geglu and a gelu model (smollm's smoke config with the activation
    replaced in both packages, f32, the reference's parameters): logits and
    loss within 1e-5."""
    import dataclasses

    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import build_model as t_build

    jcfg = dataclasses.replace(j_smoke("smollm-135m"), act=act)
    tcfg = dataclasses.replace(t_smoke("smollm-135m"), act=act)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    batch = SyntheticLM(jcfg, DataConfig(32, 2, seed=1)).batch(0)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tmodel = t_build(tcfg, "cpu")
    np.testing.assert_allclose(
        tmodel.forward(tparams, tbatch).numpy(),
        np.asarray(jmodel.forward(jparams, batch)), **TOL)
    jloss, _ = jmodel.loss(jparams, batch)
    tloss, _ = tmodel.loss(tparams, tbatch)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
