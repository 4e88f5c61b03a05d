"""Port parity for the int8 paged slab and page-sparse decode: the port
on the CPU (its plain versions) against the JAX reference.

* ``quant_slab_write``, ``reset_page_scales`` and the dequantizing
  ``gather_view``: BIT-equal int8 payloads, scales and gathered values.
* ``core/quant``: fixed-point and dynamic int8 grids bit-equal, the STE
  gradient, ``quantized_attention`` within 1e-5 (f32).
* ``hybrid_decode_attention`` with ``return_state`` / ``return_slot_m`` /
  ``slice_window``: within 1e-5 (f32, same algorithm, another order).
* ``salo_paged_decode`` with an int8 slab and ``return_page_stats`` /
  ``return_state`` (its plain version) against the JAX Pallas kernel in
  interpret mode: live rows within 1e-5, ``page_m`` equal where either side
  is ``NEG_INF`` and within 1e-5 elsewhere.
* The int8 / page-sparse ``ContinuousEngine`` mirrors every single-device
  test of ``tests/test_serve_quant.py`` against the JAX engine, with the
  reference tests' workloads and seeds: greedy tokens identical, the page
  counters equal, ``page_hist`` within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_smoke
from repro.core import patterns as JP
from repro.core import quant as JQ
from repro.core.attention import hybrid_attention as j_attention
from repro.core.attention import hybrid_decode_attention as j_decode
from repro.core.scheduler import PAD_SENTINEL, ring_view_positions
from repro.kernels.salo_decode import salo_paged_decode as j_paged
from repro.models.layers import salo_pattern as j_pattern
from repro.models.model import build_model as j_build
from repro.serve import paged_cache as JPC
from repro.serve.engine import ContinuousConfig as JConfig
from repro.serve.engine import ContinuousEngine as JEngine
from repro_torch.configs import get_smoke as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import patterns as TP
from repro_torch.core import quant as TQ
from repro_torch.core.attention import hybrid_decode_attention as t_decode
from repro_torch.core.renorm import NEG_INF
from repro_torch.kernels.salo_decode import (salo_paged_decode,
                                             salo_paged_decode_plain)
from repro_torch.models.model import build_model as t_build
from repro_torch.serve import paged_cache as TPC
from repro_torch.serve.engine import ContinuousConfig as TConfig
from repro_torch.serve.engine import ContinuousEngine as TEngine

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)     # f32, same algorithm, another order


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------- slab-level, bit-equal ----------------------- #
def test_quant_slab_write_bit_equal_over_writes():
    """Several writes per page with growing magnitudes (scale growth and
    payload rescale), null-page routes with duplicates, then a page
    recycled (scales reset) and rewritten: int8 payload and scales equal
    bit for bit after every write."""
    rng = np.random.default_rng(0)
    n_pages, page, Hkv, hd = 6, 4, 2, 8
    shape = (n_pages, page, Hkv, hd)
    jk, jv = jnp.zeros(shape, jnp.int8), jnp.zeros(shape, jnp.int8)
    jks, jvs = jnp.zeros(n_pages, jnp.float32), jnp.zeros(n_pages,
                                                          jnp.float32)
    tk, tv = torch.zeros(shape, dtype=torch.int8), torch.zeros(
        shape, dtype=torch.int8)
    tks, tvs = torch.zeros(n_pages), torch.zeros(n_pages)
    # (phys, off) per row of each write: distinct live targets, the null
    # page 0 possibly several times
    writes = [([1, 2, 0, 0], [0, 1, 0, 0]), ([1, 3, 5, 0], [1, 0, 3, 0]),
              ([2, 1, 4, 0], [2, 2, 0, 0]), ([5, 1, 2, 3], [0, 3, 3, 1]),
              ("reset", [1, 5]), ([1, 5, 0, 2], [0, 1, 0, 0]),
              ([1, 4, 3, 0], [1, 1, 2, 0])]
    for i, w in enumerate(writes):
        if w[0] == "reset":
            pages = np.asarray(w[1], np.int32)
            jks = JPC.reset_page_scales(jks, pages)
            jvs = JPC.reset_page_scales(jvs, pages)
            TPC.reset_page_scales(tks, pages)
            TPC.reset_page_scales(tvs, pages)
            continue
        phys, off = (np.asarray(x, np.int32) for x in w)
        gain = 0.5 * (i + 1)
        k_t = (rng.normal(size=(4, Hkv, hd)) * gain).astype(np.float32)
        v_t = (rng.normal(size=(4, Hkv, hd)) * gain).astype(np.float32)
        jk, jv, jks, jvs = JPC.quant_slab_write(
            jk, jv, jks, jvs, jnp.asarray(phys), jnp.asarray(off),
            jnp.asarray(k_t), jnp.asarray(v_t))
        out = TPC.quant_slab_write(tk, tv, tks, tvs, _t(phys), _t(off),
                                   _t(k_t), _t(v_t))
        assert all(a is b for a, b in zip(out, (tk, tv, tks, tvs)))
        for what, a, b in (("k", tk, jk), ("v", tv, jv), ("k_scale", tks,
                                                          jks),
                           ("v_scale", tvs, jvs)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"write {i}: {what}")
    assert float(tks[0]) == 0.0 and not tk[0].any()     # null page pinned
    assert (tks[1:] > 0).all()


def test_reset_page_scales_matches_jax():
    rng = np.random.default_rng(1)
    s = rng.random((3, 9)).astype(np.float32)
    pages = np.asarray([2, 7, 4], np.int32)
    want = np.asarray(JPC.reset_page_scales(jnp.asarray(s), pages))
    got = TPC.reset_page_scales(_t(s.copy()), pages)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantizing_gather_view_bit_equal(dtype):
    rng = np.random.default_rng(2)
    n_pages, page, Hkv, hd = 7, 4, 2, 16
    k8 = rng.integers(-128, 128, (n_pages, page, Hkv, hd)).astype(np.int8)
    v8 = rng.integers(-128, 128, (n_pages, page, Hkv, hd)).astype(np.int8)
    ks = (rng.random(n_pages) * 0.05).astype(np.float32)
    vs = (rng.random(n_pages) * 0.05).astype(np.float32)
    ks[0] = vs[0] = 0.0
    pt = np.asarray([[3, 0, 5], [1, 6, 2]], np.int32)
    jk, jv = JPC.gather_view(jnp.asarray(k8), jnp.asarray(v8),
                             jnp.asarray(pt), jnp.asarray(ks),
                             jnp.asarray(vs), getattr(jnp, dtype))
    tk, tv = TPC.gather_view(_t(k8), _t(v8), _t(pt), _t(ks), _t(vs),
                             getattr(torch, dtype))
    for a, b in ((tk, jk), (tv, jv)):
        b = np.asarray(b.astype(jnp.float32))
        np.testing.assert_array_equal(a.float().numpy(), b)
    assert tk.dtype == getattr(torch, dtype)


def test_slab_init_and_bytes():
    s = TPC.slab_init(2, 5, 4, 3, 16, torch.bfloat16, "cpu", quantized=True)
    assert s.quantized and s.k.dtype == torch.int8
    assert tuple(s.k_scale.shape) == (2, 5) and not s.k_scale.any()
    assert sum(a.numel() * a.element_size() for a in s.tensors()) == \
        TPC.slab_bytes(2, 5, 4, 3, 16, 1, with_scales=True) == \
        JPC.slab_bytes(2, 5, 4, 3, 16, 1, with_scales=True)
    fp = TPC.slab_init(2, 5, 4, 3, 16, torch.float32, "cpu")
    assert not fp.quantized and len(fp.tensors()) == 2


# ------------------------------- core/quant ------------------------------ #
def test_fixed_point_q8_grid_and_ste():
    rng = np.random.default_rng(3)
    # half-way points of the grid round to even in both frameworks
    x = np.concatenate([rng.normal(size=60) * 4,
                        np.asarray([0.03125, 0.09375, -0.15625, 9.0, -9.0])]
                       ).astype(np.float32)
    want = np.asarray(JQ.fixed_point_q8(jnp.asarray(x)))
    xt = _t(x).requires_grad_()
    got = TQ.fixed_point_q8(xt)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    (got * 3.0).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.full_like(x, 3.0))


@pytest.mark.parametrize("axis", [None, (1, 2)])
def test_dynamic_q8_and_dequant_match_jax(axis):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 4, 5)).astype(np.float32)
    x[1] = 0.0                                  # an all-zero group
    jq, js = JQ.dynamic_q8(jnp.asarray(x), axis=axis)
    tq, ts = TQ.dynamic_q8(_t(x), axis=axis)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        TQ.dequant(tq, ts).numpy(), np.asarray(JQ.dequant(jq, js)))
    jb = JQ.dequant(jq, js, jnp.bfloat16)       # promotes to f32, as JAX
    tb = TQ.dequant(tq, ts, torch.bfloat16)
    assert tb.dtype == torch.float32 and jb.dtype == jnp.float32
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_group_q8_roundtrip_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 5, 4, 3, 8)).astype(np.float32)
    jq, js = JQ.group_q8(jnp.asarray(x), 2)
    tq, ts = TQ.group_q8(_t(x), 2)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        TQ.group_dequant(tq, ts).numpy(),
        np.asarray(JQ.group_dequant(jq, js)))


@pytest.mark.parametrize("mode", ["fixed", "dynamic"])
def test_quantized_attention_matches_jax(mode):
    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(size=(2, 4, 40, 16)).astype(np.float32)
               for _ in range(3))
    jpat = JP.causal_sliding_window(12, n_sinks=2)
    tpat = TP.causal_sliding_window(12, n_sinks=2)
    want = JQ.quantized_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jpat, impl="blockwise",
                                  mode=mode, block_q=8, block_k=8)
    got = TQ.quantized_attention(_t(q), _t(k), _t(v), tpat,
                                 impl="blockwise", mode=mode, block_q=8,
                                 block_k=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the fixed grid changes the answer: the quantization is really applied
    plain = j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jpat,
                        impl="blockwise", block_q=8, block_k=8)
    assert np.abs(np.asarray(plain) - got.numpy()).max() > 1e-4


# ------------------ hybrid_decode_attention: new options ----------------- #
def _decode_inputs(seed, B=3, H=6, Hkv=2, S=40, D=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in
            ((B, H, 1, D), (B, Hkv, S, D), (B, Hkv, S, D))]


@pytest.mark.parametrize("slot_m", [False, True])
def test_decode_return_state_matches_jax(slot_m):
    q, k, v = _decode_inputs(7)
    jpat = JP.causal_sliding_window(9, n_sinks=2, dilation=2)
    tpat = TP.causal_sliding_window(9, n_sinks=2, dilation=2)
    pos = np.random.default_rng(8).permutation(40).astype(np.int32)
    pos[:5] = PAD_SENTINEL                      # empty slots
    t = np.asarray([0, 17, 39], np.int32)
    want = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(t), jpat, cache_positions=jnp.asarray(pos),
                    return_state=True, return_slot_m=slot_m)
    got = t_decode(_t(q), _t(k), _t(v), _t(t), tpat,
                   cache_positions=_t(pos), return_state=True,
                   return_slot_m=slot_m)
    assert len(got) == len(want) == 3 + slot_m
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert got[0].dtype == torch.float32


def test_decode_empty_row_state_identity():
    q, k, v = _decode_inputs(9, B=2)
    tpat = TP.causal_sliding_window(4)
    pos = np.full(40, PAD_SENTINEL, np.int32)
    out, m, l = t_decode(_t(q), _t(k), _t(v), 5, tpat,
                         cache_positions=_t(pos), return_state=True)
    assert not out.any() and (m == NEG_INF).all() and not l.any()


def test_decode_return_slot_m_matches_jax():
    q, k, v = _decode_inputs(10)
    jpat = JP.causal_sliding_window(7, n_sinks=1)
    tpat = TP.causal_sliding_window(7, n_sinks=1)
    t = np.asarray([3, 20, 39], np.int32)
    want = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(t), jpat, return_slot_m=True)
    got = t_decode(_t(q), _t(k), _t(v), _t(t), tpat, return_slot_m=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("t,g", [(0, 2), (5, 2), (23, 2), (39, 3), (30, 0)])
def test_decode_slice_window_matches_jax(t, g):
    q, k, v = _decode_inputs(11)
    jpat = JP.causal_sliding_window(8, n_sinks=g)
    tpat = TP.causal_sliding_window(8, n_sinks=g)
    want = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), t, jpat,
                    slice_window=True)
    got = t_decode(_t(q), _t(k), _t(v), t, tpat, slice_window=True)
    full = t_decode(_t(q), _t(k), _t(v), t, tpat)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL)


# ----------------- K4 variants: plain version vs Pallas kernel ----------- #
def _paged_int8_case(seed, *, window, g, dil, page, H, Hkv, hd, ts,
                     pad_row=None):
    """An int8 slab written through quant_slab_write (so payload and scales
    are what the engine keeps), shuffled physical pages, ring positions."""
    rng = np.random.default_rng(seed)
    jpat = JP.causal_sliding_window(window, n_sinks=g, dilation=dil)
    tpat = TP.causal_sliding_window(window, n_sinks=g, dilation=dil)
    lay = JPC.layout_for_pattern(jpat, page)
    B, npp = len(ts), lay.pages_per_req
    n_pages = 1 + B * npp + 2
    shape = (n_pages, page, Hkv, hd)
    k8, v8 = torch.zeros(shape, dtype=torch.int8), torch.zeros(
        shape, dtype=torch.int8)
    ks, vs = torch.zeros(n_pages), torch.zeros(n_pages)
    for p in range(1, n_pages):                 # fill every slot, twice
        for _ in range(2):
            rows = rng.normal(size=(2, page, Hkv, hd)).astype(np.float32)
            TPC.quant_slab_write(k8, v8, ks, vs, _t(np.full(page, p, np.int32)),
                                 _t(np.arange(page, dtype=np.int32)),
                                 _t(rows[0] * (1 + p % 3)), _t(rows[1]))
    q = rng.normal(size=(B, H, 1, hd)).astype(np.float32)
    pt = (1 + rng.permutation(n_pages - 1)[: B * npp]).reshape(B, npp)
    pt = pt.astype(np.int32)
    pos = np.stack([ring_view_positions(t + 1, lay.n_sink, lay.ring_cap, g)
                    for t in ts]).astype(np.int32)
    if pad_row is not None:
        pos[pad_row] = PAD_SENTINEL
    t = np.asarray(ts, np.int32)
    arrs = (q, k8.numpy(), v8.numpy(), pt, pos, t)
    return jpat, tpat, arrs, (ks.numpy(), vs.numpy())


def _live_rows(jpat, pos, t):
    from repro.core.scheduler import STEP_GLOBAL, STEP_WINDOW, causal_step_mask
    return np.asarray(causal_step_mask(jpat, t[:, None], pos,
                                       STEP_WINDOW | STEP_GLOBAL)).any(axis=1)


PAGED_CASES = [
    dict(window=16, g=2, dil=1, page=8, H=6, Hkv=2, hd=32, ts=[3, 30, 77]),
    dict(window=6, g=2, dil=2, page=4, H=2, Hkv=2, hd=16, ts=[0, 9, 41],
         pad_row=1),
]


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("kw", PAGED_CASES)
def test_paged_int8_page_stats_match_jax_kernel(kw, state):
    jpat, tpat, arrs, scales = _paged_int8_case(12, **kw)
    q, k8, v8, pt, pos, t = arrs
    jres = j_paged(q, k8, v8, pt, pos, t, pattern=jpat, interpret=True,
                   return_state=state, k_scale=jnp.asarray(scales[0]),
                   v_scale=jnp.asarray(scales[1]), return_page_stats=True)
    calls = salo_paged_decode_plain.calls
    tres = salo_paged_decode(*(_t(a) for a in arrs), pattern=tpat,
                             return_state=state, k_scale=_t(scales[0]),
                             v_scale=_t(scales[1]), return_page_stats=True)
    assert salo_paged_decode_plain.calls == calls + 1
    assert len(tres) == len(jres) == 2 + 2 * state
    live = _live_rows(jpat, pos, t)
    assert live.sum() == len(t) - (kw.get("pad_row") is not None)
    for a, b in zip(tres[:-1], jres[:-1]):
        np.testing.assert_allclose(a.numpy()[live], np.asarray(b)[live],
                                   **TOL)
    if state:                      # the empty-row identity on both sides
        for a, b in zip(tres[:3], jres[:3]):
            np.testing.assert_array_equal(a.numpy()[~live],
                                          np.asarray(b)[~live])
    pm_t, pm_j = tres[-1].numpy(), np.asarray(jres[-1])
    dead = (pm_t <= NEG_INF / 2) | (pm_j <= NEG_INF / 2)
    np.testing.assert_array_equal(pm_t[dead], pm_j[dead])
    np.testing.assert_allclose(pm_t[~dead], pm_j[~dead], **TOL)
    assert dead.any() and (~dead).any()


def test_paged_fp_return_state_matches_jax_kernel():
    rng = np.random.default_rng(13)
    kw = PAGED_CASES[0]
    jpat, tpat, arrs, _ = _paged_int8_case(13, **kw)
    q, _, _, pt, pos, t = arrs
    shape = (pt.max() + 1, kw["page"], kw["Hkv"], kw["hd"])
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    jres = j_paged(q, k, v, pt, pos, t, pattern=jpat, interpret=True,
                   return_state=True)
    tres = salo_paged_decode(_t(q), _t(k), _t(v), _t(pt), _t(pos), _t(t),
                             pattern=tpat, return_state=True)
    for a, b in zip(tres, jres):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("bad", ["one_scale", "fp_slab", "scale_shape"])
def test_bad_scale_operands_raise(bad):
    _, tpat, arrs, scales = _paged_int8_case(14, **PAGED_CASES[0])
    ops = [_t(a) for a in arrs]
    ks, vs = _t(scales[0]), _t(scales[1])
    if bad == "one_scale":
        kw = dict(k_scale=ks)
    elif bad == "fp_slab":
        ops[1], ops[2] = ops[1].float(), ops[2].float()
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        kw = dict(k_scale=ks[:-1], v_scale=vs[:-1])
    with pytest.raises((ValueError, TypeError)):
        salo_paged_decode(*ops, pattern=tpat, **kw)


# ------------------------- the int8 / sparse engine ---------------------- #
def _cfgs(**salo):
    jcfg, tcfg = j_smoke("smollm-135m"), t_smoke("smollm-135m")
    if salo:
        jcfg = dataclasses.replace(jcfg, salo=dataclasses.replace(
            jcfg.salo, **salo))
        tcfg = dataclasses.replace(tcfg, salo=dataclasses.replace(
            tcfg.salo, **salo))
    return jcfg, tcfg


def _pair(jcfg, tcfg, seed, *, page=8, chunk=8, max_batch=4,
          decode_impl="xla", kv_dtype="compute", thr=None, decay=0.0):
    """The JAX engine and the port's, same config, same parameters (the
    reference tests' plain init from ``PRNGKey(seed)``)."""
    lay = JPC.layout_for_pattern(j_pattern(jcfg, causal=True), page)
    kw = dict(n_pages=1 + max_batch * lay.pages_per_req, page=page,
              chunk=chunk, max_batch=max_batch, kv_dtype=kv_dtype,
              page_sparsity_threshold=thr, page_stat_decay=decay)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    jeng = JEngine(jmodel, JConfig(decode_impl=decode_impl, **kw))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    teng = TEngine(t_build(tcfg, "cpu"), TConfig(**kw), device="cpu")
    return (jeng, jparams), (teng, tparams)


def _prompts(cfg, lens):
    rng = np.random.default_rng(11)
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
            for n in lens]


def _run(eng, params, prompts, n_new):
    rids = [eng.submit(p, n_new) for p in prompts]
    res = eng.run(params)
    return [np.asarray(res[r]) for r in rids]


def _same(j, t, prompts, n_new):
    """Run both engines; tokens identical and every counter equal."""
    (jeng, jp), (teng, tp) = j, t
    jo, to = _run(jeng, jp, prompts, n_new), _run(teng, tp, prompts, n_new)
    for i, (a, b) in enumerate(zip(jo, to)):
        np.testing.assert_array_equal(b, a, err_msg=f"request {i}")
    assert dict(teng.counters) == dict(jeng.counters)
    np.testing.assert_allclose(teng.page_hist, jeng.page_hist, rtol=0,
                               atol=1e-6)
    return to


def test_int8_parity_ring_wraparound():
    jcfg, tcfg = _cfgs(window=8)
    j, t = _pair(jcfg, tcfg, 0, max_batch=2, kv_dtype="int8")
    _same(j, t, _prompts(jcfg, (21, 6)), 40)


def test_int8_parity_dilated():
    jcfg, tcfg = _cfgs(window=4, dilation=2, n_global=2)
    j, t = _pair(jcfg, tcfg, 1, max_batch=2, kv_dtype="int8")
    _same(j, t, _prompts(jcfg, (11, 17)), 10)


def test_int8_parity_page_recycling_waves():
    """6 requests through 2 rows: recycled pages' scales reset to 0 on
    release, in every slab, on both sides."""
    jcfg, tcfg = _cfgs()
    j, t = _pair(jcfg, tcfg, 2, max_batch=2, kv_dtype="int8")
    _same(j, t, _prompts(jcfg, (9, 26, 5, 14, 22, 7)), 8)
    assert len(t[0].batcher.finished) == 6
    for key, js in j[0].slabs.items():          # identical slab state
        ts = t[0].slabs[key]
        for a, b in zip(ts.tensors(), js):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_int8_parity_pallas_interpret():
    """The JAX engine decoding through its Pallas kernel (scales scalar-
    prefetched, in-kernel dequant, interpret mode) against the port."""
    jcfg, tcfg = _cfgs()
    j, t = _pair(jcfg, tcfg, 3, max_batch=2, kv_dtype="int8",
                 decode_impl="pallas_interpret")
    _same(j, t, _prompts(jcfg, (7, 12)), 6)


def test_int8_slab_resident_footprint():
    jcfg, tcfg = _cfgs()
    (jf, _), (tf, _) = _pair(jcfg, tcfg, 0)
    (j8, _), (t8, _) = _pair(jcfg, tcfg, 0, kv_dtype="int8")
    assert tf.slab_resident_bytes() / t8.slab_resident_bytes() >= 3.5
    assert t8.slab_resident_bytes() == j8.slab_resident_bytes()
    assert tf.slab_resident_bytes() == jf.slab_resident_bytes()
    assert t8.registry.value("serve_slab_resident_bytes") == \
        t8.slab_resident_bytes()


def test_keepall_threshold_exact_vs_none():
    """threshold -inf: statistics on, nothing skipped: tokens identical to
    threshold None (and to the JAX engine), every page read."""
    jcfg, tcfg = _cfgs()
    prompts = _prompts(jcfg, (9, 26, 5, 14))
    _, (ref, rp) = _pair(jcfg, tcfg, 4, kv_dtype="int8")
    ref_toks = _run(ref, rp, prompts, 10)
    j, t = _pair(jcfg, tcfg, 4, kv_dtype="int8", thr=float("-inf"),
                 decay=0.5)
    out = _same(j, t, prompts, 10)
    for a, b in zip(out, ref_toks):
        np.testing.assert_array_equal(a, b)
    c = t[0].counters
    assert c["decode_pages_read"] == c["decode_pages_total"] > 0


def test_page_skip_engages_at_parity():
    """window 64, threshold -3, decay 0.3: pages are really skipped
    (0 < read < total) with the JAX engine's tokens, counters and
    history."""
    jcfg, tcfg = _cfgs(window=64)
    j, t = _pair(jcfg, tcfg, 5, kv_dtype="int8", thr=-3.0, decay=0.3)
    _same(j, t, _prompts(jcfg, (24, 17, 9, 30)), 24)
    read = t[0].counters["decode_pages_read"]
    total = t[0].counters["decode_pages_total"]
    assert 0 < read < total, (read, total)


def test_page_skip_zero_decay_never_skips():
    jcfg, tcfg = _cfgs()
    j, t = _pair(jcfg, tcfg, 6, max_batch=2, kv_dtype="int8", thr=-0.1,
                 decay=0.0)
    _same(j, t, _prompts(jcfg, (9, 14)), 8)
    c = t[0].counters
    assert c["decode_pages_read"] == c["decode_pages_total"] > 0


def test_prefill_keepall_counters_and_parity():
    jcfg, tcfg = _cfgs()
    j, t = _pair(jcfg, tcfg, 7, kv_dtype="int8", thr=float("-inf"),
                 decay=0.5)
    _same(j, t, _prompts(jcfg, (21, 30)), 6)
    c = t[0].counters
    assert c["prefill_pages_read"] == c["prefill_pages_total"] > 0


def test_prefill_page_skip_engages():
    """The history driven below threshold between two prefill chunks: the
    second chunk reads only sink and chunk-written pages, with the JAX
    engine's counters, and the request still completes."""
    jcfg, tcfg = _cfgs(window=64)
    (jeng, jp), (teng, tp) = _pair(jcfg, tcfg, 8, thr=-0.1, decay=0.3,
                                   max_batch=1)
    prompt = np.random.default_rng(11).integers(
        0, jcfg.vocab_size, (40,)).astype(np.int32)
    rids = [e.submit(prompt, 4) for e in (jeng, teng)]
    for eng, params in ((jeng, jp), (teng, tp)):
        eng.step(params)
        c = eng.counters
        assert c["prefill_pages_read"] == c["prefill_pages_total"] > 0
        req = next(r for r in eng.batcher.rows if r is not None)
        eng.page_hist[req.row, :] = -1.0
        eng.step(params)
    assert dict(teng.counters) == dict(jeng.counters)
    assert teng.counters["prefill_pages_read"] < \
        teng.counters["prefill_pages_total"]
    jres, tres = jeng.run(jp), teng.run(tp)
    np.testing.assert_array_equal(np.asarray(tres[rids[1]]),
                                  np.asarray(jres[rids[0]]))
    assert len(tres[rids[1]]) == 4


def test_page_stats_fold_span_and_release_hook():
    """The page_stats_fold span is traced per decode step, and a finished
    request's row history is retired."""
    from repro_torch.obs import Observability

    _, tcfg = _cfgs()
    lay = TPC.layout_for_pattern(TP.causal_sliding_window(16, n_sinks=2), 8)
    obs = Observability(tracing=True)
    eng = TEngine(t_build(tcfg, "cpu"),
                  TConfig(n_pages=1 + 2 * lay.pages_per_req, page=8, chunk=8,
                          max_batch=2, kv_dtype="int8",
                          page_sparsity_threshold=-2.0, page_stat_decay=0.5),
                  device="cpu", obs=obs)
    params = eng.model.init(torch.Generator().manual_seed(0))
    for p in _prompts(tcfg, (9, 14)):
        eng.submit(p, 5)
    eng.run(params)
    names = [e.get("name") for e in obs.tracer.events()]
    assert names.count("page_stats_fold") == eng.counters["decode_launches"]
    assert not eng.page_hist.any()             # both rows retired
    for s in eng.slabs.values():               # and their scales reset
        assert not s.k_scale.any() and not s.v_scale.any()
