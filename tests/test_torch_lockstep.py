"""Port parity for the lockstep serving path: the contiguous-cache decode
K5 (its plain version on the CPU), ``attn_decode``, ``Model.decode_step``
and ``ServeEngine`` against the JAX reference.

* ``salo_decode`` against JAX ``salo_decode`` in interpret mode on the
  cases of ``tests/test_decode_kernel.py`` (full cache with S not a
  multiple of the tile, the ring layout, a ragged ``t`` vector,
  per-request positions): within 1e-5 (f32, same algorithm).
* ``Model.decode_step`` logits within 1e-5 of the reference's at every
  step, full cache, ring cache and windowed decode, f32 smoke model with
  the reference's parameters (``params_from_jax``).
* ``ServeEngine.generate``: greedy tokens identical to the reference's.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_smoke
from repro.core import patterns as JP
from repro.kernels.salo_decode import salo_decode as j_salo_decode
from repro.models.model import build_model as j_build
from repro.serve import kv_cache as JKV
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import patterns as TP
from repro_torch.kernels.salo_decode import salo_decode, salo_decode_plain
from repro_torch.models.model import build_model as t_build
from repro_torch.serve import kv_cache as TKV
from repro_torch.serve.engine import ServeConfig, ServeEngine

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)     # f32, same algorithm, another order


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rand(rng, *shapes):
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


# -------------------- K5's plain path vs the Pallas kernel --------------- #
@pytest.mark.parametrize("H,Hkv,hd", [(8, 2, 32), (4, 4, 64), (6, 1, 128)])
def test_full_cache_matches_jax_kernel(H, Hkv, hd):
    """S = 100 is not a multiple of the reference's 32-slot tile; the port
    takes the transposed view of a (B, S, Hkv, hd) cache, as
    ``attn_decode`` does."""
    rng = np.random.default_rng(3)
    B, S = 2, 100
    q, k, v = _rand(rng, (B, H, 1, hd), (B, Hkv, S, hd), (B, Hkv, S, hd))
    jpat = JP.causal_sliding_window(24, n_sinks=3)
    tpat = TP.causal_sliding_window(24, n_sinks=3)
    pos = np.arange(S, dtype=np.int32)
    kt = _t(k.transpose(0, 2, 1, 3)).transpose(1, 2)       # strided view
    vt = _t(v.transpose(0, 2, 1, 3)).transpose(1, 2)
    for t in (0, 30, 99):
        want = j_salo_decode(q, k, v, pos, t, pattern=jpat, block_s=32,
                             interpret=True)
        for positions in (_t(pos), None):          # None: slot = position
            got = salo_decode(_t(q), kt, vt, positions, t, pattern=tpat)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=str(t), **TOL)


def test_ring_layout_matches_jax_kernel():
    """The legacy ring cache, built by each package's own ring_update."""
    rng = np.random.default_rng(4)
    w_, g, B, Hkv, hd, H, n = 16, 2, 2, 2, 32, 4, 50
    q_all, k_all, v_all = _rand(rng, (B, H, n, hd), (B, Hkv, n, hd),
                                (B, Hkv, n, hd))
    jpat = JP.causal_sliding_window(w_, n_sinks=g)
    tpat = TP.causal_sliding_window(w_, n_sinks=g)
    with pytest.warns(DeprecationWarning):
        jc = JKV.ring_init(B, w_, g, Hkv, hd, jnp.float32)
    with pytest.warns(DeprecationWarning):
        tc = TKV.ring_init(B, w_, g, Hkv, hd, torch.float32, "cpu")
    for t in range(n):
        k_t = k_all[:, :, t:t + 1].transpose(0, 2, 1, 3)
        v_t = v_all[:, :, t:t + 1].transpose(0, 2, 1, 3)
        jc = JKV.ring_update(jc, jnp.asarray(k_t), jnp.asarray(v_t), t, w_,
                             g)
        tc = TKV.ring_update(tc, _t(k_t), _t(v_t), t, w_, g)
        if t % 9 != 0:
            continue
        jpos = JKV.ring_positions_mask(jc)
        tpos = TKV.ring_positions_mask(tc)
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        want = j_salo_decode(q_all[:, :, t:t + 1],
                             jc.k.transpose(0, 2, 1, 3),
                             jc.v.transpose(0, 2, 1, 3), jpos, t,
                             pattern=jpat, block_s=8, interpret=True)
        got = salo_decode(_t(q_all[:, :, t:t + 1]), tc.k.transpose(1, 2),
                          tc.v.transpose(1, 2), tpos, t, pattern=tpat)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=str(t), **TOL)


@pytest.mark.parametrize("dilation", [1, 2])
def test_ragged_t_vector_matches_jax_kernel(dilation):
    rng = np.random.default_rng(11)
    B, H, Hkv, hd, S = 4, 4, 2, 32, 64
    q, k, v = _rand(rng, (B, H, 1, hd), (B, Hkv, S, hd), (B, Hkv, S, hd))
    jpat = JP.causal_sliding_window(6, n_sinks=2, dilation=dilation)
    tpat = TP.causal_sliding_window(6, n_sinks=2, dilation=dilation)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    tv = np.asarray([0, 7, 23, 63], np.int32)
    want = j_salo_decode(q, k, v, pos, tv, pattern=jpat, block_s=16,
                         interpret=True)
    got = salo_decode(_t(q), _t(k), _t(v), _t(pos), _t(tv), pattern=tpat)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_per_request_positions_match_jax_kernel():
    rng = np.random.default_rng(5)
    B, H, Hkv, hd, S = 3, 2, 1, 16, 32
    q, k, v = _rand(rng, (B, H, 1, hd), (B, Hkv, S, hd), (B, Hkv, S, hd))
    jpat = JP.causal_sliding_window(8, n_sinks=1)
    tpat = TP.causal_sliding_window(8, n_sinks=1)
    pos = np.stack([rng.permutation(S) for _ in range(B)]).astype(np.int32)
    tv = np.asarray([9, 31, 14], np.int32)
    want = j_salo_decode(q, k, v, pos, tv, pattern=jpat, block_s=8,
                         interpret=True)
    calls = salo_decode_plain.calls
    got = salo_decode(_t(q), _t(k), _t(v), _t(pos), _t(tv), pattern=tpat)
    assert salo_decode_plain.calls == calls + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bad", ["positions_dtype", "positions_shape",
                                 "t_dtype", "cache_dtype"])
def test_salo_decode_checks_operands(bad):
    rng = np.random.default_rng(6)
    q, k, v = (_t(a) for a in _rand(rng, (2, 2, 1, 16), (2, 1, 8, 16),
                                    (2, 1, 8, 16)))
    pos, t = torch.arange(8, dtype=torch.int32), 5
    if bad == "positions_dtype":
        pos = pos.long()
    elif bad == "positions_shape":
        pos = pos[:7]
    elif bad == "t_dtype":
        t = torch.tensor([5, 6])
    else:
        k = k.double()
    with pytest.raises((TypeError, ValueError)):
        salo_decode(q, k, v, pos, t, pattern=TP.causal_sliding_window(4))


# ----------------------- decode_step and the engine ---------------------- #
def _cfgs(**salo):
    jcfg, tcfg = j_smoke("smollm-135m"), t_smoke("smollm-135m")
    if salo:
        jcfg = dataclasses.replace(jcfg, salo=dataclasses.replace(
            jcfg.salo, **salo))
        tcfg = dataclasses.replace(tcfg, salo=dataclasses.replace(
            tcfg.salo, **salo))
    return jcfg, tcfg


def _amplify(params, gain=6.0):
    """Scale every residual branch's output projection, so greedy tokens
    depend on attention (at the plain init the tied embedding dominates
    and decoding repeats the input token)."""
    seg = dict(params["seg0_attn_mlp"])
    seg["attn"] = dict(seg["attn"], wo=seg["attn"]["wo"] * gain)
    seg["mlp"] = dict(seg["mlp"], w_out=seg["mlp"]["w_out"] * gain)
    return dict(params, seg0_attn_mlp=seg)


def _models(jcfg, tcfg, seed):
    jmodel = j_build(jcfg)
    jparams = _amplify(jmodel.init(jax.random.PRNGKey(seed)))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return (jmodel, jparams), (t_build(tcfg, "cpu"), tparams)


SALO_VARIANTS = {"full": {}, "ring": dict(ring_cache=True),
                 "slice": dict(decode_slice=True)}


@pytest.mark.parametrize("variant", list(SALO_VARIANTS))
def test_decode_step_logits_match_jax(variant):
    """30 steps past the 16-slot window (the ring wraps), logits at every
    step within 1e-5; one plain K5 call per layer per step."""
    jcfg, tcfg = _cfgs(**SALO_VARIANTS[variant])
    (jm, jp), (tm, tp) = _models(jcfg, tcfg, 0)
    B, n = 2, 30
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, n))
    jc, tc = jm.init_cache(B, n), tm.init_cache(B, n)
    want_slots = min(n, 18) if variant == "ring" else n
    assert tc["seg0_attn_mlp"]["k"].shape == (jcfg.n_layers, B, want_slots,
                                              jcfg.n_kv_heads, jcfg.hd)
    step = jax.jit(jm.decode_step)
    calls = salo_decode_plain.calls
    for t in range(n):
        jl, jc = step(jp, jc, {"tokens": jnp.asarray(toks[:, t:t + 1])}, t)
        tl, tc = tm.decode_step(tp, tc, {"tokens": _t(toks[:, t:t + 1])}, t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"step {t}", **TOL)
    assert salo_decode_plain.calls - calls == n * jcfg.n_layers
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["seg0_attn_mlp"][name].numpy(),
                                   np.asarray(jc["seg0_attn_mlp"][name]),
                                   **TOL)


@pytest.mark.parametrize("variant", ["full", "ring"])
def test_serve_engine_greedy_tokens_identical(variant):
    """Prompt 20 past the 16-slot window, 12 new tokens: identical greedy
    tokens, and not one repeated token."""
    jcfg, tcfg = _cfgs(**SALO_VARIANTS[variant])
    (jm, jp), (tm, tp) = _models(jcfg, tcfg, 2)
    prompts = np.random.default_rng(3).integers(0, jcfg.vocab_size, (3, 20))
    want = JServeEngine(jm, JServeConfig(max_len=32)).generate(
        jp, jnp.asarray(prompts), 12)
    got = ServeEngine(tm, ServeConfig(max_len=32)).generate(tp, prompts, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(got.numpy())) > 3


def test_serve_engine_temperature_is_seeded():
    _, tcfg = _cfgs()
    tm = t_build(tcfg, "cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 6))
    runs = [ServeEngine(tm, ServeConfig(max_len=16, temperature=1.0,
                                        seed=s)).generate(params, prompts, 8)
            for s in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert ((runs[0] >= 0) & (runs[0] < tcfg.vocab_size)).all()


def test_kv_cache_helpers_match_jax():
    assert TKV.bytes_per_layer(4, 100, 2, 16) == \
        JKV.bytes_per_layer(4, 100, 2, 16)
    assert TKV.bytes_per_layer(4, 100, 2, 16, 4, window=32, n_global=4) == \
        JKV.bytes_per_layer(4, 100, 2, 16, 4, window=32, n_global=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        c = TKV.ring_init(1, 4, 1, 1, 8, torch.float32, "cpu")
    assert (c.positions == -1).all() and c.k.shape == (1, 5, 1, 8)


def test_block_cache_init_raises_for_unported_kinds():
    """Every kind of the reference is ported (whisper's ``xattn`` gives
    its self-attention and cross caches); a kind no package has raises the
    reference's ``ValueError``."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as T

    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="bogus"):
        T.block_cache_init(tcfg, "bogus", 1, 8, torch.float32, "cpu")
    wcfg = get_smoke("whisper-base")
    c = T.block_cache_init(wcfg, "xattn", 1, 8, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in c.items()} == {
        "k": (1, 8, 4, 16), "v": (1, 8, 4, 16), "xk": (1, 32, 4, 16),
        "xv": (1, 32, 4, 16)}


def test_serve_cli_lockstep_cpu(capsys):
    from repro_torch.launch.serve import main

    toks = main(["--smoke", "--device", "cpu", "--engine", "lockstep",
                 "--batch", "2", "--prompt-len", "20", "--new-tokens", "6"])
    assert toks.shape == (2, 6)
    out = capsys.readouterr().out
    assert "engine=lockstep" in out and "sample[1]" in out
    with pytest.raises(SystemExit):           # trace needs the continuous
        main(["--smoke", "--device", "cpu", "--engine", "lockstep",
              "--trace-out", "x.json"])
    with pytest.raises(SystemExit):           # continuous is greedy-only
        main(["--smoke", "--device", "cpu", "--temperature", "0.5"])


def test_serve_cli_int8_page_sparse_cpu(capsys):
    from repro_torch.launch.serve import main

    res = main(["--smoke", "--device", "cpu", "--kv-dtype", "int8",
                "--page-sparsity-threshold", "-3", "--page-stat-decay",
                "0.3", "--batch", "3", "--prompt-len", "24",
                "--new-tokens", "6"])
    assert sorted(len(r) for r in res.values()) == [6, 6, 6]
    out = capsys.readouterr().out
    assert "kv_dtype=int8" in out and "page_thr=-3.0" in out
