"""Port parity: ChunkPlan tables, ring positions, the serving mask and the
paged layout are bit-identical to the JAX reference's."""
import numpy as np
import pytest
import torch

from repro.core import patterns as JP
from repro.core import scheduler as JS
from repro.serve import paged_cache as JPC
from repro_torch.core import patterns as TP
from repro_torch.core import scheduler as TS
from repro_torch.serve import paged_cache as TPC

torch.set_num_threads(2)

# (window, n_global, dilation, c0, clen, page): first chunk, mid prompt,
# ring wrap (c0 far past the window), chunk longer than the ring, dilation,
# no sinks, the full-width smollm geometry (page 16, chunk 128).
PLAN_CASES = [
    (16, 2, 1, 0, 8, 8),
    (16, 2, 1, 8, 8, 8),
    (16, 2, 1, 40, 13, 8),
    (8, 2, 1, 3, 21, 4),
    (4, 2, 2, 11, 5, 8),
    (12, 0, 1, 30, 7, 4),
    (1024, 4, 1, 1152, 128, 16),
]


def _layout(window, g, dil, page):
    pat = JP.causal_sliding_window(window, n_sinks=g, dilation=dil)
    return pat, JPC.layout_for_pattern(pat, page)


@pytest.mark.parametrize("case", PLAN_CASES)
def test_chunk_plan_bit_identical(case):
    """Tolerance: exact (integer tables)."""
    window, g, dil, c0, clen, page = case
    jpat, lay = _layout(window, g, dil, page)
    tpat = TP.causal_sliding_window(window, n_sinks=g, dilation=dil)
    chunk_pad = -(-clen // page) * page + page
    kw = dict(n_sink=lay.n_sink, ring_cap=lay.ring_cap, block=page,
              chunk_pad=chunk_pad)
    jp = JS.build_chunk_plan(jpat, c0, clen, **kw)
    tp = TS.build_chunk_plan(tpat, c0, clen, **kw)
    for name in ("kv_blocks", "flags", "num_steps", "view_positions"):
        a, b = getattr(jp, name), getattr(tp, name)
        assert a.dtype == b.dtype == np.int32, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("chunk_pad", "n_sink", "ring_cap", "view_len", "nq", "nkb",
                 "max_steps"):
        assert getattr(jp, name) == getattr(tp, name), name
    nq, w = jp.nq + 1, jp.max_steps + 3
    for a, b in zip(jp.padded_tables(nq, w), tp.padded_tables(nq, w)):
        np.testing.assert_array_equal(a, b)
    assert jp.stats() == tp.stats()


@pytest.mark.parametrize("n_sink,ring_cap,g", [(8, 16, 2), (0, 12, 0),
                                               (16, 1040, 4), (4, 8, 3)])
def test_ring_view_positions_bit_identical(n_sink, ring_cap, g):
    """Tolerance: exact."""
    for c0 in range(0, 3 * ring_cap + 7, 5):
        np.testing.assert_array_equal(
            JS.ring_view_positions(c0, n_sink, ring_cap, g),
            TS.ring_view_positions(c0, n_sink, ring_cap, g), err_msg=str(c0))


@pytest.mark.parametrize("window,g,dil", [(16, 2, 1), (5, 0, 3), (8, 4, 2)])
def test_causal_step_mask_equal(window, g, dil):
    """Tolerance: exact (boolean mask), PAD_SENTINEL slots included."""
    rng = np.random.default_rng(11)
    pos_i = rng.integers(0, 60, (7, 1)).astype(np.int32)
    pos_j = rng.integers(0, 70, (7, 40)).astype(np.int32)
    pos_j[rng.random((7, 40)) < 0.2] = JS.PAD_SENTINEL
    pos_i[3] = JS.PAD_SENTINEL
    flags = rng.integers(0, 4, (7, 40)).astype(np.int32)
    jm = np.asarray(JS.causal_step_mask(
        JP.causal_sliding_window(window, n_sinks=g, dilation=dil),
        pos_i, pos_j, flags))
    tm = TS.causal_step_mask(
        TP.causal_sliding_window(window, n_sinks=g, dilation=dil),
        torch.from_numpy(pos_i), torch.from_numpy(pos_j),
        torch.from_numpy(flags)).numpy()
    np.testing.assert_array_equal(jm, tm)
    assert jm.any() and not jm.all()


@pytest.mark.parametrize("page,window,g,dil", [(8, 16, 2, 1), (4, 4, 2, 2),
                                               (16, 1024, 4, 1),
                                               (8, 9, 0, 1)])
def test_paged_layout_equal(page, window, g, dil):
    """Tolerance: exact."""
    j = JPC.PagedLayout(page=page, window=window, n_global=g, dilation=dil)
    t = TPC.PagedLayout(page=page, window=window, n_global=g, dilation=dil)
    for name in ("span", "sink_pages", "ring_pages", "n_sink", "ring_cap",
                 "pages_per_req", "slots_per_req"):
        assert getattr(j, name) == getattr(t, name), name
    for total in range(0, 2 * j.slots_per_req + 5, 3):
        assert j.pages_needed(total) == t.pages_needed(total)
    p = np.arange(0, 3 * j.slots_per_req, dtype=np.int32)
    np.testing.assert_array_equal(np.asarray(j.slot(p)),
                                  t.slot(torch.from_numpy(p)).numpy())
    rng = np.random.default_rng(3)
    pt = rng.integers(1, 50, (p.size, j.pages_per_req)).astype(np.int32)
    keep = rng.random(p.size) < 0.7
    jw = j.write_target(pt, p, keep=keep)
    tw = t.write_target(torch.from_numpy(pt), torch.from_numpy(p),
                        keep=torch.from_numpy(keep))
    for a, b in zip(jw, tw):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
