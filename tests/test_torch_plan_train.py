"""Port parity: the training IR (ExecutionPlan, TransposedPlan,
PackedTransposedPlan) and the step mask are bit-identical to the JAX
reference's, for every registered verification target."""
import numpy as np
import pytest
import torch

from repro.analysis.registry import plan_targets
from repro.core import scheduler as JS
from repro_torch.core import patterns as TP
from repro_torch.core import scheduler as TS

torch.set_num_threads(2)
TARGETS = plan_targets()


def _port_pattern(jpat):
    return TP.HybridSparsePattern(**{f: getattr(jpat, f) for f in (
        "window", "dilation", "n_global", "global_rows", "causal", "grid2d",
        "window2d")})


def _plans(target):
    jplan = JS.schedule(target.pattern, target.n).plan(target.block_q,
                                                        target.block_k)
    tplan = TS.schedule(_port_pattern(target.pattern), target.n).plan(
        target.block_q, target.block_k)
    return jplan, tplan


def _same(a, b, name):
    assert a.dtype == b.dtype == np.int32, name
    np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("target", TARGETS, ids=[t.name for t in TARGETS])
def test_plans_bit_identical(target):
    """Tolerance: exact (integer tables)."""
    jplan, tplan = _plans(target)
    for f in ("n_pad", "nq", "nkb", "max_steps", "band_sets"):
        assert getattr(jplan, f) == getattr(tplan, f), f
    for f in ("kv_blocks", "flags", "band_set_ids", "num_steps"):
        _same(getattr(jplan, f), getattr(tplan, f), f)
    _same(jplan.positions_padded(), tplan.positions_padded(), "positions")
    jt, tt = jplan.transposed(), tplan.transposed()
    assert jt.max_steps == tt.max_steps
    for f in ("q_blocks", "flags", "num_steps"):
        _same(getattr(jt, f), getattr(tt, f), f"transposed {f}")
    jp, tp = jplan.transposed_packed(), tplan.transposed_packed()
    assert (jp.width, jp.n_rows) == (tp.width, tp.n_rows)
    for f in ("row_tile", "q_blocks", "flags", "num_steps"):
        _same(getattr(jp, f), getattr(tp, f), f"packed {f}")
    assert jplan.stats() == tplan.stats()


@pytest.mark.parametrize("target", TARGETS, ids=[t.name for t in TARGETS])
def test_step_mask_identical(target):
    """``step_mask`` in torch equals the reference's on every executed
    (query, key) pair of the plan, padding slots and 2-D floors included.
    Tolerance: exact (booleans)."""
    jplan, tplan = _plans(target)
    pos = jplan.positions_padded()
    pq = pos.reshape(jplan.nq, jplan.block_q)
    pk = pos.reshape(jplan.nkb, jplan.block_k)
    for s in range(jplan.max_steps):
        blk, fl = jplan.kv_blocks[:, s], jplan.flags[:, s]
        args = (pq[:, :, None], pk[blk][:, None, :], fl[:, None, None])
        want = np.asarray(jplan.step_mask(*args))
        got = tplan.step_mask(*(torch.from_numpy(np.ascontiguousarray(a))
                                for a in args)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"step {s}")


def test_pack_rows_splits_overlong_rows():
    """A row longer than the width is split into neighbouring rows that
    share one owner tile, in order (the order K3's owner-tile sum keeps)."""
    rows = [[(0, 1), (1, 1), (2, 3), (3, 1), (4, 1)], [], [(5, 2)]]
    for jres, tres in zip(JS.pack_rows(rows, width=2),
                          TS.pack_rows(rows, width=2)):
        np.testing.assert_array_equal(np.asarray(jres), np.asarray(tres))
    row_tile, q_blocks, _, num_steps, width = TS.pack_rows(rows, width=2)
    assert row_tile.tolist() == [0, 0, 0, 2] and width == 2
    assert q_blocks[:3].tolist() == [[0, 1], [2, 3], [4, 0]]
    assert num_steps.tolist() == [2, 2, 1, 1]
