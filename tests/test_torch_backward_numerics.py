"""The 16-bit backward kernels' numerics, emulated on the CPU.

With bf16 or f16 inputs the dQ and dK/dV kernels
(``kernels/csrc/salo_table_backward.cu``) run every product on the tensor
cores. The score product takes q and k as they are. Every operand that the
reference takes in f32 (dout, p, ds) is split into a 16-bit ``hi = rn(x)``
and ``lo = rn(x - hi)``, and the partial products are summed in f32:
``a @ b16 = hi @ b + lo @ b``, and ``p^T @ dout = hi @ hi + hi @ lo +
lo @ hi``. This file replays that arithmetic in plain torch on the inputs
of ``table_dq_scan`` / ``table_dkv_scan``: a product of two 16-bit values is
exact in f32, so an f32 matmul of the parts is the tensor cores' sum.

With f16 inputs the kernels first scale dout, and with it delta, dp and
ds, by an exact power of two that brings the largest |element| in reach
into [0.5, 1): per query row for dQ, per 64-query sub-tile for dK/dV (here
one query block, which is that sub-tile at these block sizes). dQ scales
ds again, per row, by the power of two that brings the largest |ds| so far
into [2^14, 2^15), so that small ds keep their bits. The sums are scaled
back after. bf16, with f32's exponent range, needs no scale.

It holds the split within the tolerances that the card checks read from
``repro_torch.kernels.salo_backward`` (``DKV_TOL`` for dk and dv,
``DQ_OFF_SHARE`` for dq rounded to the inputs' type) against the f32 plain
scans, and shows that one 16-bit rounding of dout, p and ds, as
FlashAttention does, falls outside them: so those tolerances cannot be
loosened to admit it without this file failing. At a train step's small
dout (here 2^-20 of unit scale) it shows that f16 needs the power-of-two
scale. At head dim 256 (the ``_hd256`` cases) the kernels split the
accumulated columns over two blocks of 128, each of which recomputes the
scores and dp over the full head dim: here dq, dk and dv are accumulated
per 128-column chunk from the same ds and p.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.blockwise import (_dot, p_from_stats, plan_tables,
                                        table_attention_scan, table_dkv_scan,
                                        table_dq_scan)
from repro_torch.core.patterns import causal_sliding_window, longformer, vil
from repro_torch.core.scheduler import schedule
from repro_torch.kernels.salo_backward import (DKV_TOL, DQ_OFF_SHARE,
                                               dq_off_share)

torch.set_num_threads(2)

SMALL = 2.0 ** -20     # a train step's dout, relative to unit scale
COLS = 128             # accumulated columns of one block
# (pattern, n, block_q, block_k[, head dim: 64 by default])
CASES = {
    "causal_sinks": (causal_sliding_window(256, n_sinks=4), 1024, 64, 64),
    "vil": (vil((16, 16), (5, 5), n_global=1), 257, 32, 64),
    "longformer": (longformer(48, n_global=2), 300, 64, 32),
    "causal_sinks_hd256": (causal_sliding_window(256, n_sinks=4), 512, 64,
                           64, 256),
    "longformer_hd256": (longformer(48, n_global=1), 200, 64, 32, 256),
}


def _parts(x, dtype):
    """The hi/lo split of an f32 tensor, each part widened back to f32."""
    hi = x.to(dtype).float()
    return hi, (x - hi).to(dtype).float()


def _pow2_exp(x, dims):
    """The exponent e of the largest |x| over ``dims`` (max |x| in
    [2^(e-1), 2^e)), 0 where that is 0, as the kernels' pow2_exp."""
    mx = x.abs().amax(dim=dims)
    return torch.frexp(mx)[1].clamp(-60, 60).float()


def _products(scheme, dtype):
    """``(mm1, mm2)``: mm1(a, b) for f32 a and 16-bit-exact b, mm2(a, b)
    for two f32 operands, under the split or one rounding to ``dtype``."""
    if scheme.startswith("split"):
        def mm1(a, b):
            hi, lo = _parts(a, dtype)
            return hi @ b + lo @ b

        def mm2(a, b):
            ah, al = _parts(a, dtype)
            bh, bl = _parts(b, dtype)
            return ah @ bh + ah @ bl + al @ bh
    else:
        def mm1(a, b):
            return a.to(dtype).float() @ b

        def mm2(a, b):
            return a.to(dtype).float() @ b.to(dtype).float()
    return mm1, mm2


def _by_cols(mm, a, b):
    """mm(a, b) with b's columns (the accumulated hd) taken 128 at a
    time, as the hd-256 kernels' blocks do, concatenated."""
    dc = min(b.shape[-1], COLS)
    return torch.cat([mm(a, b[..., z:z + dc])
                      for z in range(0, b.shape[-1], dc)], -1)


def _emulated(scheme, dtype, dout, delta, m, l, q, k, v, pos_q, pos_k, t,
              sched, scale):
    """dq, dk, dv as the kernels compute them, walking the same tables as
    table_dq_scan / table_dkv_scan. All f32. ``scheme``: "split" (the
    kernels: scaled in f16), "split_unscaled" (the split without the
    power-of-two scale) or "round" (one 16-bit rounding of each f32
    operand, unscaled)."""
    mm1, mm2 = _products(scheme, dtype)
    B, nQ, D = q.shape
    nq, bq = pos_q.shape
    nkb, bk = pos_k.shape
    q_r = q.float().reshape(B, nq, bq, D)
    do_r = dout.reshape(B, nq, bq, D)
    m_r, l_r = m.reshape(B, nq, bq), l.reshape(B, nq, bq)
    dl_r = delta.reshape(B, nq, bq)
    k_r = k.float().reshape(B, nkb, bk, D)
    v_r = v.float().reshape(B, nkb, bk, D)
    # the exponents of the scale: per query row (dQ), per query block (dK/dV)
    scaled = scheme == "split" and dtype == torch.float16
    e_row = _pow2_exp(do_r, (-1,)) if scaled else torch.zeros(B, nq, bq)
    e_blk = _pow2_exp(do_r, (-2, -1)) if scaled else torch.zeros(B, nq)

    def p_ds(qb, kb, vb, dob, mask, mb, lb, dlb):
        p = p_from_stats(_dot(qb, kb) * scale, mask, mb, lb)
        return p, p * (mm1(dob, vb.transpose(-1, -2)) - dlb[..., None])

    dq = torch.zeros((B, nq, bq, D))
    dt = torch.full((B, nq, bq), 75.0)      # f16: dq's rows carry 2^dt
    for s in range(t.kv_blocks.shape[1]):
        blk, fl = t.kv_blocks[:, s], t.flags[:, s]
        k_b, v_b = k_r.index_select(1, blk), v_r.index_select(1, blk)
        mask = sched.step_mask(pos_q[:, :, None],
                               pos_k.index_select(0, blk)[:, None, :],
                               fl[:, None, None])[None]
        _, ds = p_ds(q_r, k_b, v_b, do_r * torch.exp2(-e_row)[..., None],
                     mask, m_r, l_r, dl_r * torch.exp2(-e_row))
        if scaled:
            # per row, the running minimum of 15 - e(max |ds|) over the
            # step's key tiles (the kernel's 64-key sub-tiles here)
            mx = ds.abs().amax(-1)
            new = torch.where(mx > 0, torch.minimum(
                dt, 15 - _pow2_exp(ds, (-1,))), dt)
            dq = dq * torch.exp2(new - dt)[..., None]
            dt = new
            ds = ds * torch.exp2(dt)[..., None]
        dq = dq + _by_cols(mm1, ds, k_b) * scale
    if scaled:
        dq = dq * torch.exp2(-dt)[..., None]
    dq = dq * torch.exp2(e_row)[..., None]

    R = t.q_blocks.shape[0]
    k_t = k_r.index_select(1, t.row_tile)
    v_t = v_r.index_select(1, t.row_tile)
    pos_kt = pos_k.index_select(0, t.row_tile)
    dk_r = torch.zeros((B, R, bk, D))
    dv_r = torch.zeros_like(dk_r)
    for s in range(t.q_blocks.shape[1]):
        qb, fl = t.q_blocks[:, s], t.pk_flags[:, s]
        e = e_blk.index_select(1, qb)[..., None, None]          # (B,R,1,1)
        q_b = q_r.index_select(1, qb)
        do_b = do_r.index_select(1, qb) * torch.exp2(-e)
        mask = sched.step_mask(pos_q.index_select(0, qb)[:, :, None],
                               pos_kt[:, None, :], fl[:, None, None])[None]
        p, ds = p_ds(q_b, k_t, v_t, do_b, mask, m_r.index_select(1, qb),
                     l_r.index_select(1, qb),
                     dl_r.index_select(1, qb) * torch.exp2(-e[..., 0]))
        dv_r = dv_r + _by_cols(mm2, p.transpose(-1, -2), do_b) * torch.exp2(e)
        dk_r = dk_r + (_by_cols(mm1, ds.transpose(-1, -2), q_b) * scale
                       * torch.exp2(e))
    zt = torch.zeros((B, nkb, bk, D))
    return (dq.reshape(B, nQ, D),
            zt.index_add(1, t.row_tile, dk_r).reshape(B, nkb * bk, D),
            zt.index_add(1, t.row_tile, dv_r).reshape(B, nkb * bk, D))


def _run(case, dtype, scheme, dscale=1.0):
    pat, n, bq, bk, *hd = CASES[case]
    hd = hd[0] if hd else 64
    sched = schedule(pat, n)
    plan = sched.plan(bq, bk)
    t = plan_tables(plan, torch.device("cpu"))
    pos_q = t.pos.reshape(plan.nq, bq)
    pos_k = t.pos.reshape(plan.nkb, bk)
    rng = np.random.default_rng(n)
    shape = (2, plan.n_pad, hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
               .to(dtype) for _ in range(3))
    dout = torch.from_numpy(rng.standard_normal(shape,
                                                dtype=np.float32)) * dscale
    scale = hd ** -0.5
    out, m, l = table_attention_scan(q, k, v, pos_q, pos_k, t.kv_blocks,
                                     t.flags, sched, scale)
    delta = (dout * out.float()).sum(-1)
    args = (dout, delta, m, l, q, k, v, pos_q, pos_k)
    ref = (table_dq_scan(*args, t.kv_blocks, t.flags, sched, scale),
           *table_dkv_scan(*args, t.row_tile, t.q_blocks, t.pk_flags, sched,
                           scale))
    got = _emulated(scheme, dtype, *args, t, sched, scale)
    return got, ref


def _excess(a, b, tol):
    """max |a - b| / (tol * (1 + |b|)): above 1 fails allclose(tol, tol)."""
    return float(((a - b).abs() / (tol * (1 + b.abs()))).max())


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_split_operands_stay_within_tolerance(case, dtype):
    (dq, dk, dv), (rdq, rdk, rdv) = _run(case, dtype, "split")
    tol = DKV_TOL[dtype]
    for a, b in ((dk, rdk), (dv, rdv), (dq, rdq)):
        torch.testing.assert_close(a, b, atol=tol, rtol=tol)
    # the kernel returns dq in the inputs' type: the card's checks hold
    torch.testing.assert_close(dq.to(dtype).float(), rdq, atol=2e-2,
                               rtol=2e-2)
    assert dq_off_share(dq.to(dtype), rdq) <= DQ_OFF_SHARE


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_one_rounding_misses_tolerance(case, dtype):
    (dq, dk, dv), (rdq, rdk, rdv) = _run(case, dtype, "round")
    tol = DKV_TOL[dtype]
    assert min(_excess(dk, rdk, tol), _excess(dv, rdv, tol)) > 2.0
    assert dq_off_share(dq.to(dtype), rdq) > 10 * DQ_OFF_SHARE


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_small_dout_split_stays_within_tolerance(case, dtype):
    """dout at 2^-20 of unit scale, compared relative to it."""
    (dq, dk, dv), (rdq, rdk, rdv) = _run(case, dtype, "split", SMALL)
    tol = DKV_TOL[dtype]
    for a, b in ((dk, rdk), (dv, rdv), (dq, rdq)):
        torch.testing.assert_close(a / SMALL, b / SMALL, atol=tol, rtol=tol)
    assert dq_off_share(dq.to(dtype), rdq) <= DQ_OFF_SHARE


@pytest.mark.parametrize("case", list(CASES))
def test_small_dout_needs_the_scale_in_f16(case):
    """Without the power-of-two scale, f16's hi and lo of such a dout (and
    of ds) keep a few bits or none: dk/dv fall far outside tolerance."""
    (_, dk, dv), (_, rdk, rdv) = _run(case, torch.float16, "split_unscaled",
                                      SMALL)
    tol = DKV_TOL[torch.float16]
    assert min(_excess(dk / SMALL, rdk / SMALL, tol),
               _excess(dv / SMALL, rdv / SMALL, tol)) > 2.0
