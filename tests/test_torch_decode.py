"""Port parity: ``salo_paged_decode`` (on the CPU, its plain version)
against the JAX Pallas kernel in interpret mode and the JAX XLA twin."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import patterns as JP
from repro.core.attention import hybrid_decode_attention as j_twin
from repro.core.scheduler import PAD_SENTINEL, ring_view_positions
from repro.kernels.salo_decode import salo_paged_decode as j_paged
from repro.serve.paged_cache import gather_view, layout_for_pattern
from repro_torch.core import patterns as TP
from repro_torch.kernels.salo_decode import (salo_paged_decode,
                                             salo_paged_decode_plain)

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)     # f32 end to end, same algorithm


def _case(seed, *, window, g, dil, page, H, Hkv, hd, ts, pad_row=None):
    """Random slab with shuffled physical pages and per-request ring
    positions (every position <= t written, PAD slots included)."""
    rng = np.random.default_rng(seed)
    jpat = JP.causal_sliding_window(window, n_sinks=g, dilation=dil)
    tpat = TP.causal_sliding_window(window, n_sinks=g, dilation=dil)
    lay = layout_for_pattern(jpat, page)
    B, npp = len(ts), lay.pages_per_req
    n_pages = 1 + B * npp + 3
    k = rng.standard_normal((n_pages, page, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((n_pages, page, Hkv, hd)).astype(np.float32)
    q = rng.standard_normal((B, H, 1, hd)).astype(np.float32)
    pt = (1 + rng.permutation(n_pages - 1)[: B * npp]).reshape(B, npp)
    pt = pt.astype(np.int32)
    pos = np.stack([ring_view_positions(t + 1, lay.n_sink, lay.ring_cap, g)
                    for t in ts]).astype(np.int32)
    if pad_row is not None:
        pos[pad_row] = PAD_SENTINEL
    t = np.asarray(ts, np.int32)
    return jpat, tpat, (q, k, v, pt, pos, t)


def _torch(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _live_rows(pos, t, jpat):
    """Rows that attend at least one slot (the kernel and the twin differ
    only on rows that attend nothing)."""
    from repro.core.scheduler import STEP_GLOBAL, STEP_WINDOW, causal_step_mask
    m = np.asarray(causal_step_mask(jpat, t[:, None], pos,
                                    STEP_WINDOW | STEP_GLOBAL))
    return m.any(axis=1)


CASES = [
    # GQA rep 3, ring wrap (t >> window), sinks
    dict(window=16, g=2, dil=1, page=8, H=6, Hkv=2, hd=32, ts=[3, 30, 77]),
    # dilation, rep 1, page 4
    dict(window=6, g=2, dil=2, page=4, H=2, Hkv=2, hd=16, ts=[0, 9, 41]),
    # no sinks, rep 4
    dict(window=10, g=0, dil=1, page=8, H=4, Hkv=1, hd=8, ts=[5, 64]),
]


@pytest.mark.parametrize("kw", CASES)
def test_paged_decode_matches_jax_kernel_and_twin(kw):
    jpat, tpat, arrs = _case(1, **kw)
    q, k, v, pt, pos, t = arrs
    out = salo_paged_decode(*_torch(arrs), pattern=tpat).numpy()
    ker = np.asarray(j_paged(q, k, v, pt, pos, t, pattern=jpat,
                             interpret=True))
    kr, vr = gather_view(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pt))
    twin = np.asarray(j_twin(jnp.asarray(q), kr.transpose(0, 2, 1, 3),
                             vr.transpose(0, 2, 1, 3), jnp.asarray(t), jpat,
                             cache_positions=jnp.asarray(pos)))
    assert _live_rows(pos, t, jpat).all()
    np.testing.assert_allclose(out, ker, **TOL)
    np.testing.assert_allclose(out, twin, **TOL)


def test_paged_decode_all_pad_row_matches_twin():
    """An all-PAD row attends nothing: the port's plain version and the
    JAX twin both return the mean of V there (the Pallas kernel returns 0,
    so that row is compared against the twin only)."""
    kw = dict(CASES[0], ts=[3, 30, 5])
    jpat, tpat, arrs = _case(2, pad_row=2, **kw)
    q, k, v, pt, pos, t = arrs
    out = salo_paged_decode(*_torch(arrs), pattern=tpat).numpy()
    live = _live_rows(pos, t, jpat)
    assert live.tolist() == [True, True, False]
    kr, vr = gather_view(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pt))
    twin = np.asarray(j_twin(jnp.asarray(q), kr.transpose(0, 2, 1, 3),
                             vr.transpose(0, 2, 1, 3), jnp.asarray(t), jpat,
                             cache_positions=jnp.asarray(pos)))
    np.testing.assert_allclose(out, twin, **TOL)
    ker = np.asarray(j_paged(q, k, v, pt, pos, t, pattern=jpat,
                             interpret=True))
    np.testing.assert_allclose(out[live], ker[live], **TOL)
    np.testing.assert_array_equal(ker[~live], 0.0)


def test_cpu_tensors_take_the_plain_version():
    jpat, tpat, arrs = _case(3, **CASES[0])
    before = salo_paged_decode_plain.calls
    launches = salo_paged_decode.launches
    salo_paged_decode(*_torch(arrs), pattern=tpat)
    assert salo_paged_decode_plain.calls == before + 1
    assert salo_paged_decode.launches == launches


@pytest.mark.parametrize("which", [3, 4, 5])
def test_int64_tables_raise(which):
    _, tpat, arrs = _case(5, **CASES[0])
    ts = _torch(arrs)
    ts[which] = ts[which].long()
    with pytest.raises(TypeError, match="int32"):
        salo_paged_decode(*ts, pattern=tpat)
