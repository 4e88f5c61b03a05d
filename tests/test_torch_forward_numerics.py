"""The 16-bit forward kernel's numerics, emulated on the CPU.

With bf16 or f16 inputs the forward kernel K1
(``kernels/csrc/salo_table_attention.cu``, ``table_attention_mma_kernel``)
runs both products on the tensor cores and walks each step's KV tile in
64-key sub-tiles. This file replays its arithmetic in plain torch on the
inputs of ``table_attention_scan`` (a product of two 16-bit values is exact
in f32, so an f32 matmul of the widened operands is the tensor cores' sum,
in another order):

- the running max per 64-key sub-tile, taken on the raw scores q.k of the
  surviving pairs and scaled once: m stays in natural units (scale > 0, so
  the max of the scaled scores is the scaled max);
- ``p = exp2(fma(s, scale * log2(e), -shift * log2(e)))`` and the
  correction ``exp2((m_prev - shift) * log2(e))``, with the reference's
  guarded shift (``m <= NEG_INF/2 -> 0``) and correction (0 after an empty
  prefix);
- l sums the f32 p, while the PV product takes p rounded to V's type;
- at head dim 256 the kernel splits out's columns over two blocks (128
  each), which recompute the same scores from Q reread from shared
  memory: here acc is accumulated per 128-column chunk from the same p.

It holds that emulation against ``salo_table_attention_plain`` within the
tolerances the card checks use (``salo_attention.OUT_TOL`` for out,
``STATS_TOL`` for m and l) at the training pattern (causal window with
sinks, 256-wide blocks, padded rows) and head dims 64, 128 and 256, and shows
that summing the rounded p into l, as FlashAttention does, falls outside
l's tolerance: so that tolerance cannot admit it without this file failing.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import renorm
from repro_torch.core.blockwise import plan_tables
from repro_torch.core.patterns import causal_sliding_window, vil
from repro_torch.core.scheduler import schedule
from repro_torch.kernels.salo_attention import (OUT_TOL, STATS_TOL,
                                                salo_table_attention_plain)

torch.set_num_threads(2)

SUB = 64                                  # keys of the kernel's sub-tiles
COLS = 128                                # out columns a block accumulates
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
NEG_INF = renorm.NEG_INF
# (pattern, n, block_q, block_k): the training pattern at a small n with
# padded rows, and a 2-D pattern whose 32-key tiles fill half a sub-tile
CASES = {
    "train": (causal_sliding_window(256, n_sinks=4), 1000, 256, 256),
    "vil_32": (vil((12, 12), (5, 3), n_global=1), 145, 64, 32),
}


def _fma(a, b, c):
    """a * b + c rounded once to f32 (the kernel's fmaf): the f32 product
    is exact in f64."""
    return (a.double() * b.double() + c.double()).float()


def _emulated(q, k, v, pos_q, pos_k, t, sched, scale, *, l_rounded=False):
    """(out, m, l) as the 16-bit kernel computes them. ``l_rounded``: l
    sums p rounded to V's type instead of the f32 p."""
    B, nQ, D = q.shape
    nq, bq = pos_q.shape
    nkb, bk = pos_k.shape
    ks = min(SUB, bk)
    q_r = q.float().reshape(B, nq, bq, D)
    k_r = k.float().reshape(B, nkb, bk, D)
    v_r = v.float().reshape(B, nkb, bk, D)
    scale2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    m = torch.full((B, nq, bq), NEG_INF)
    l = torch.zeros((B, nq, bq))
    dc = min(D, COLS)
    acc = [torch.zeros((B, nq, bq, dc)) for _ in range(D // dc)]
    for s in range(t.kv_blocks.shape[1]):
        blk, fl = t.kv_blocks[:, s], t.flags[:, s]
        k_b, v_b = k_r.index_select(1, blk), v_r.index_select(1, blk)
        pk_b = pos_k.index_select(0, blk)
        for j0 in range(0, bk, ks):
            keys = slice(j0, j0 + ks)
            mask = sched.step_mask(pos_q[:, :, None],
                                   pk_b[:, None, keys],
                                   fl[:, None, None])[None]
            sc = q_r @ k_b[:, :, keys].transpose(-1, -2)      # raw scores
            mx = torch.where(mask, sc, NEG_INF).amax(-1)
            mt = torch.where(mx == NEG_INF, NEG_INF, mx * scale)
            m_new = torch.maximum(m, mt)
            shift = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
            corr = torch.where(m <= NEG_INF / 2, 0.0,
                               torch.exp2((m - shift) * LOG2E))
            p = torch.where(mask, torch.exp2(_fma(sc, scale2, -(
                shift * LOG2E)[..., None])), 0.0)
            p16 = p.to(v.dtype).float()
            l = l * corr + (p16 if l_rounded else p).sum(-1)
            acc = [a * corr[..., None] + p16 @ v_b[:, :, keys, z * dc:(z + 1) * dc]
                   for z, a in enumerate(acc)]
            m = m_new
    out = torch.cat(acc, -1) / torch.where(l == 0.0, 1.0, l)[..., None]
    return (out.to(q.dtype).reshape(B, nQ, D), m.reshape(B, nQ),
            l.reshape(B, nQ))


def _run(case, hd, dtype, **kw):
    pat, n, bq, bk = CASES[case]
    sched = schedule(pat, n)
    plan = sched.plan(bq, bk)
    t = plan_tables(plan, torch.device("cpu"))
    pos_q = t.pos.reshape(plan.nq, bq)
    pos_k = t.pos.reshape(plan.nkb, bk)
    rng = np.random.default_rng(n + hd)
    shape = (2, plan.n_pad, hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
               .to(dtype) for _ in range(3))
    scale = hd ** -0.5
    ref = salo_table_attention_plain(q, k, v, pos_q, pos_k, t.kv_blocks,
                                     t.flags, sched=sched, scale=scale)
    got = _emulated(q, k, v, pos_q, pos_k, t, sched, scale, **kw)
    return got, ref, t.pos >= sched.n


def _excess(a, b, tol):
    """max |a - b| / (tol * (1 + |b|)): above 1 fails allclose(tol, tol)."""
    return float(((a - b).abs() / (tol * (1 + b.abs()))).max())


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_emulated_kernel_matches_plain(case, hd, dtype):
    (out, m, l), (ro, rm, rl), pad = _run(case, hd, dtype)
    torch.testing.assert_close(out.float(), ro.float(), atol=OUT_TOL[dtype],
                               rtol=OUT_TOL[dtype])
    for a, b in ((m, rm), (l, rl)):
        torch.testing.assert_close(a, b, atol=STATS_TOL, rtol=STATS_TOL)
    # rows that attend nothing (padding) give exactly (0, NEG_INF, 0)
    if case == "train":
        assert bool(pad.any())
    assert bool((m[:, pad] == NEG_INF).all() and (l[:, pad] == 0).all()
                and (out[:, pad] == 0).all())


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_summing_rounded_p_misses_l_tolerance(case, hd, dtype):
    (_, _, l), (_, _, rl), _ = _run(case, hd, dtype, l_rounded=True)
    assert _excess(l, rl, STATS_TOL) > 2.0
