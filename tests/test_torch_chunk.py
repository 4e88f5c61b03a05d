"""Port parity: plan-driven chunked-prefill attention (``chunk_attention``
and ``hybrid_chunk_attention``) against the JAX reference."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import patterns as JP
from repro.core.attention import hybrid_chunk_attention as j_hca
from repro.core.blockwise import chunk_attention as j_chunk
from repro.core.scheduler import PAD_SENTINEL, build_chunk_plan
from repro.serve.paged_cache import layout_for_pattern
from repro_torch.core import patterns as TP
from repro_torch.core.attention import hybrid_chunk_attention as t_hca
from repro_torch.core.blockwise import chunk_attention as t_chunk

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)     # f32 end to end

# (window, n_global, dilation, c0, clen, page)
CASES = [(16, 2, 1, 0, 11, 8), (16, 2, 1, 37, 16, 8), (6, 2, 2, 19, 9, 4),
         (8, 0, 1, 50, 5, 4)]


def _inputs(case):
    window, g, dil, c0, clen, page = case
    jpat = JP.causal_sliding_window(window, n_sinks=g, dilation=dil)
    tpat = TP.causal_sliding_window(window, n_sinks=g, dilation=dil)
    lay = layout_for_pattern(jpat, page)
    cp = -(-clen // page) * page
    plan = build_chunk_plan(jpat, c0, clen, n_sink=lay.n_sink,
                            ring_cap=lay.ring_cap, block=page, chunk_pad=cp)
    kv, fl = plan.padded_tables(plan.nq, plan.max_steps + 1)
    ctx = lay.n_sink + lay.ring_cap
    pos_q = np.full(cp, PAD_SENTINEL, np.int32)
    pos_q[:clen] = np.arange(c0, c0 + clen)
    pos_k = np.concatenate([plan.view_positions[:ctx], pos_q])
    return jpat, tpat, pos_q, pos_k, kv, fl, ctx + cp, cp


@pytest.mark.parametrize("case", CASES)
def test_chunk_attention_matches_reference(case):
    jpat, tpat, pos_q, pos_k, kv, fl, vp, cp = _inputs(case)
    rng = np.random.default_rng(1)
    B, D = 3, 16
    q = rng.standard_normal((B, cp, D)).astype(np.float32)
    k = rng.standard_normal((B, vp, D)).astype(np.float32)
    v = rng.standard_normal((B, vp, D)).astype(np.float32)
    pq = np.broadcast_to(pos_q, (B, cp)).copy()
    pk = np.broadcast_to(pos_k, (B, vp)).copy()
    ref = np.asarray(j_chunk(q, k, v, pq, pk, kv, fl, jpat))
    out = t_chunk(*[torch.from_numpy(a) for a in (q, k, v, pq, pk, kv, fl)],
                  tpat).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    assert np.abs(out).sum() > 0


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("H,Hkv", [(6, 2), (2, 2)])
def test_hybrid_chunk_attention_gqa_matches_reference(case, H, Hkv):
    jpat, tpat, pos_q, pos_k, kv, fl, vp, cp = _inputs(case)
    rng = np.random.default_rng(3)
    B, D = 2, 8
    q = rng.standard_normal((B, H, cp, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, vp, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, vp, D)).astype(np.float32)
    pq = np.broadcast_to(pos_q, (B, cp)).copy()
    pk = np.broadcast_to(pos_k, (B, vp)).copy()
    ref = np.asarray(j_hca(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(pq), jnp.asarray(pk), jnp.asarray(kv),
                           jnp.asarray(fl), jpat))
    out = t_hca(*[torch.from_numpy(a) for a in (q, k, v, pq, pk, kv, fl)],
                tpat).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
