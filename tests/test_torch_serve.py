"""Port parity for the whole serving slice: the port's ContinuousEngine on
the CPU against the JAX engine, on the smollm smoke config at f32 with the
reference's parameters converted by ``params_from_jax``. Greedy tokens
must be IDENTICAL, the counters equal, the slab state equal outside the
null page 0."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_smoke
from repro.models.layers import salo_pattern as j_pattern
from repro.models.model import build_model as j_build
from repro.serve.engine import ContinuousConfig as JConfig
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.paged_cache import layout_for_pattern
from repro_torch.configs import get_smoke as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.dist.group import SeqGroup
from repro_torch.kernels.salo_decode import salo_paged_decode_plain
from repro_torch.models.model import build_model as t_build
from repro_torch.serve.engine import ContinuousConfig as TConfig
from repro_torch.serve.engine import ContinuousEngine as TEngine

torch.set_num_threads(2)
SLAB_TOL = dict(rtol=1e-5, atol=1e-5)    # f32 end to end


def _cfgs(window=None):
    jcfg, tcfg = j_smoke("smollm-135m"), t_smoke("smollm-135m")
    if window is not None:
        jcfg = dataclasses.replace(jcfg, salo=dataclasses.replace(
            jcfg.salo, window=window))
        tcfg = dataclasses.replace(tcfg, salo=dataclasses.replace(
            tcfg.salo, window=window))
    return jcfg, tcfg


def _amplify(params, gain=6.0):
    """Scale every residual branch's output projection. At the plain init
    the tied embedding dominates the residual stream and greedy decoding
    repeats the input token; with this gain the tokens depend on
    attention, so token identity tests the attention path."""
    seg = dict(params["seg0_attn_mlp"])
    seg["attn"] = dict(seg["attn"], wo=seg["attn"]["wo"] * gain)
    seg["mlp"] = dict(seg["mlp"], w_out=seg["mlp"]["w_out"] * gain)
    return dict(params, seg0_attn_mlp=seg)


def _engines(jcfg, tcfg, *, page, chunk, max_batch, decode_impl, seed):
    lay = layout_for_pattern(j_pattern(jcfg, causal=True), page)
    n_pages = 1 + max_batch * lay.pages_per_req
    jmodel = j_build(jcfg)
    jparams = _amplify(jmodel.init(jax.random.PRNGKey(seed)))
    jeng = JEngine(jmodel, JConfig(n_pages=n_pages, page=page, chunk=chunk,
                                   max_batch=max_batch,
                                   decode_impl=decode_impl))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    teng = TEngine(t_build(tcfg, "cpu"),
                   TConfig(n_pages=n_pages, page=page, chunk=chunk,
                           max_batch=max_batch), device="cpu")
    return (jeng, jparams), (teng, tparams)


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
            for n in lens]


def _run_both(j, t, prompts, n_new):
    (jeng, jparams), (teng, tparams) = j, t
    jr = [jeng.submit(p, n_new) for p in prompts]
    tr = [teng.submit(p, n_new) for p in prompts]
    return ([jeng.run(jparams)[r] for r in jr],
            [teng.run(tparams)[r] for r in tr])


def test_params_from_jax_consumes_every_leaf():
    jcfg, _ = _cfgs()
    jparams = jax.tree.map(np.asarray, j_build(jcfg).init(
        jax.random.PRNGKey(0)))
    tparams = params_from_jax(jparams, "cpu")
    n_j = sum(int(np.size(a)) for a in jax.tree.leaves(jparams))
    n_t = sum(a.numel() for a in jax.tree.leaves(
        tparams, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert n_j == n_t
    assert len(tparams["seg0_attn_mlp"]) == jcfg.n_layers
    bad = dict(jparams, extra={"w": np.zeros(2)})
    with pytest.raises(ValueError, match="unconsumed"):
        params_from_jax(bad, "cpu")
    bad = dict(jparams)
    bad["seg0_attn_mlp"] = dict(jparams["seg0_attn_mlp"],
                                attn=dict(jparams["seg0_attn_mlp"]["attn"],
                                          bias=np.zeros((2, 3))))
    with pytest.raises(ValueError, match="unconsumed"):
        params_from_jax(bad, "cpu")


@pytest.mark.parametrize("decode_impl", ["xla", "pallas_interpret"])
def test_ragged_batch_tokens_identical(decode_impl):
    """Tolerance: exact (greedy token ids), plus equal counters. Prompts
    (5, 9, 13, 26) x 8 new tokens; the ring wraps (window 16)."""
    jcfg, tcfg = _cfgs()
    j, t = _engines(jcfg, tcfg, page=8, chunk=8, max_batch=4,
                    decode_impl=decode_impl, seed=0)
    calls = salo_paged_decode_plain.calls
    jo, to = _run_both(j, t, _prompts(jcfg, (5, 9, 13, 26), 7), 8)
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(a, b)
    assert len({int(x) for o in to for x in o}) > 8      # not one token
    assert dict(j[0].counters) == dict(t[0].counters)
    # every decode step ran the plain version once per layer (CPU tensors)
    assert salo_paged_decode_plain.calls - calls == \
        t[0].counters["decode_launches"] * jcfg.n_layers


@pytest.mark.parametrize("decode_impl", ["xla", "pallas_interpret"])
def test_ring_wraparound_tokens_identical(decode_impl):
    """window 8, prompts (21, 6), 40 new tokens: many ring revolutions.
    Tolerance: exact token ids and counters."""
    jcfg, tcfg = _cfgs(window=8)
    j, t = _engines(jcfg, tcfg, page=8, chunk=8, max_batch=2,
                    decode_impl=decode_impl, seed=1)
    jo, to = _run_both(j, t, _prompts(jcfg, (21, 6), 8), 40)
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(a, b)
    assert dict(j[0].counters) == dict(t[0].counters)


def test_slab_state_equal_outside_null_page():
    """Step both engines in lockstep through prefill (chunks of 8 over
    prompts up to 26) and the first decode steps; after every step the
    slabs agree outside page 0 (whose content is undefined: inactive rows
    and dropped writes all land there). Tolerance: 1e-5 (f32)."""
    jcfg, tcfg = _cfgs()
    (jeng, jparams), (teng, tparams) = _engines(
        jcfg, tcfg, page=8, chunk=8, max_batch=4, decode_impl="xla", seed=2)
    for p in _prompts(jcfg, (5, 9, 13, 26), 9):
        jeng.submit(p, 6)
        teng.submit(p, 6)
    for _ in range(5):
        more_j, more_t = jeng.step(jparams), teng.step(tparams)
        assert more_j == more_t
        for key, js in jeng.slabs.items():
            ts = teng.slabs[key]
            np.testing.assert_allclose(ts.k.numpy()[:, 1:],
                                       np.asarray(js.k)[:, 1:], **SLAB_TOL)
            np.testing.assert_allclose(ts.v.numpy()[:, 1:],
                                       np.asarray(js.v)[:, 1:], **SLAB_TOL)
        np.testing.assert_array_equal(teng.slot_pos.numpy(),
                                      np.asarray(jeng.slot_pos))
    assert teng.counters["prefill_launches"] == sum(
        -(-n // 8) for n in (5, 9, 13, 26))


@pytest.mark.parametrize("shards,group_size", [(2, None), (2, 4), (4, 2)])
def test_seq_shards_needs_matching_group(shards, group_size):
    """seq_shards > 1 needs a SeqGroup of exactly that size (the
    reference's mesh check); sharded serving itself is
    tests/test_torch_dist_serve.py."""
    _, tcfg = _cfgs()
    group = None if group_size is None else SeqGroup(
        None, 0, group_size, torch.device("cpu"))
    with pytest.raises(ValueError, match=f"seq_shards={shards} needs a "
                                         f"SeqGroup of that size"):
        TEngine(t_build(tcfg, "cpu"), TConfig(n_pages=9, seq_shards=shards),
                device="cpu", group=group)
