"""The split-KV decode kernels' numerics, emulated on the CPU.

The decode kernels K4 (paged slab) and K5 (contiguous caches) share one
body (``kernels/csrc/salo_decode_body.cuh``) that splits each request's
slots over ``n_split`` blocks, as :func:`plan_splits` decides, and merges
the blocks' partials. This file replays that arithmetic in plain torch (a
product of two 16-bit values is exact in f32, so an f32 matmul of the
widened operands is the kernel's sum, in another order):

- each split walks its slots in tiles of ``TS`` slots (the body's
  ``Tile<KV, HD>::TS``) with the online softmax: the split-local running
  max, the guarded shift (``m <= NEG_INF/2 -> 0``) and correction, l summed
  over the f32 p, and the PV product over p rounded to V's type;
- the partials ``(acc, m, l)`` are merged in ascending split order with the
  guarded renorm merge: ``c = exp(m_s - M)`` (0 for a dead split),
  ``acc = sum c acc_s``, ``l = sum c l_s``, ``out = acc / (l or 1)``.

It holds that emulation against the JAX Pallas kernels in interpret mode
and against the port's plain versions, on the live rows, within 1e-5 (f32)
and 2e-2 (bf16, f16): the tolerances the card checks use
(``chip_smoke.TOL``, ``tests/test_torch_cuda.py``). The cases: ragged
``t`` past the ring wrap, rows whose live slots lie in one split (the
others dead), an all-PAD row (the ``(0, NEG_INF, 0)`` identity), the int8
slab, page statistics, ``return_state`` and ``n_split = 1``. The planner's
rules are tested too.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import patterns as JP
from repro.core.scheduler import PAD_SENTINEL, ring_view_positions
from repro.kernels.salo_decode import salo_decode as j_decode
from repro.kernels.salo_decode import salo_paged_decode as j_paged
from repro_torch.core import patterns as TP
from repro_torch.core.renorm import NEG_INF
from repro_torch.core.scheduler import (STEP_GLOBAL, STEP_WINDOW,
                                        causal_step_mask)
from repro_torch.kernels.salo_decode import (plan_splits, salo_decode_plain,
                                             salo_paged_decode_plain)
from repro_torch.serve import paged_cache as TPC

torch.set_num_threads(2)

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.float16: jnp.float16}
N_SM = 132                                # an H100's SMs
ROWS = 4                                  # kRows of the kernel body


def tile_slots(hd: int, kv_itemsize: int) -> int:
    """``Tile<KV, HD>::TS`` of the kernel body: slots per shared tile."""
    return min(128, 16384 // (hd * kv_itemsize))


def emulate(q, k, v, pos, t, pat, scale, n_split, split_len, tile):
    """The kernel's (out f32, m, l) on per-request caches. q: (B, H, 1, hd)
    in T; k, v: (B, Hkv, S, hd) in T (dequantized); pos: (B, S); t: (B,)."""
    B, H, _, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Hkv, H // Hkv, hd)
    kf, vf = k.float(), v.float()
    mask = causal_step_mask(pat, t[:, None], pos, STEP_WINDOW | STEP_GLOBAL)
    parts = []
    for sp in range(n_split):
        acc = torch.zeros(qg.shape)
        m = torch.full(qg.shape[:-1], NEG_INF)
        l = torch.zeros(qg.shape[:-1])
        hi = min((sp + 1) * split_len, S)
        for c0 in range(sp * split_len, hi, tile):
            c1 = min(c0 + tile, hi)
            mk = mask[:, None, None, c0:c1]
            sc = torch.where(mk, (qg @ kf[:, :, c0:c1].transpose(-1, -2))
                             * scale, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            shift = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
            p = torch.where(mk, torch.exp(sc - shift[..., None]), 0.0)
            corr = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - shift))
            l = l * corr + p.sum(-1)
            acc = (acc * corr[..., None]
                   + p.to(q.dtype).float() @ vf[:, :, c0:c1])
            m = m_new
        parts.append((acc, m, l))
    M = torch.stack([m_s for _, m_s, _ in parts]).amax(0)
    acc = torch.zeros(qg.shape)
    l = torch.zeros(qg.shape[:-1])
    for acc_s, m_s, l_s in parts:             # ascending split order
        c = torch.where(m_s <= NEG_INF / 2, 0.0, torch.exp(m_s - M))
        acc = acc + c[..., None] * acc_s
        l = l + c * l_s
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    return (out.reshape(B, H, 1, hd), M.reshape(B, H, 1),
            l.reshape(B, H, 1))


def page_maxima(q, k, pos, t, pat, scale, page):
    """(B, npp): the max masked score of every row against every page."""
    B, H, _, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Hkv, H // Hkv, hd)
    mask = causal_step_mask(pat, t[:, None], pos, STEP_WINDOW | STEP_GLOBAL)
    sc = torch.where(mask[:, None, None], (qg @ k.float().transpose(-1, -2))
                     * scale, NEG_INF)
    return sc.amax(dim=(1, 2)).reshape(B, S // page, page).amax(-1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol, rows):
    np.testing.assert_allclose(np.asarray(got, np.float32)[rows],
                               np.asarray(want, np.float32)[rows],
                               rtol=tol, atol=tol)


# ------------------------------ K4: paged -------------------------------- #
# window 40 + 2 sinks on 8-slot pages: 48 slots a request, three 16-slot
# splits at N_SM. t = 3 keeps every live slot in split 0 (the others are
# dead); t = 77 and 50 lie past the ring wrap.
PAGED = dict(window=40, g=2, page=8, H=6, Hkv=2, hd=64, ts=[3, 77, 9, 50])
VARIANTS = {
    "fp": dict(),
    "int8_stats": dict(int8=True, stats=True),
    "state_stats": dict(state=True, stats=True),
    "pad_state": dict(state=True, pad_row=2),
    "one_split": dict(n_sm=1, stats=True),
}


def _paged_case(variant, dtype):
    kw = dict(PAGED, **VARIANTS[variant])
    rng = np.random.default_rng(list(VARIANTS).index(variant))
    jpat = JP.causal_sliding_window(kw["window"], n_sinks=kw["g"])
    tpat = TP.causal_sliding_window(kw["window"], n_sinks=kw["g"])
    lay = TPC.layout_for_pattern(tpat, kw["page"])
    ts, page, H, Hkv, hd = kw["ts"], kw["page"], kw["H"], kw["Hkv"], kw["hd"]
    B, npp = len(ts), lay.pages_per_req
    n_pages = 1 + B * npp
    shape = (n_pages, page, Hkv, hd)
    q = _t(rng.normal(size=(B, H, 1, hd)).astype(np.float32)).to(dtype)
    scales = (None, None)
    if kw.get("int8"):
        k = torch.zeros(shape, dtype=torch.int8)
        v = torch.zeros(shape, dtype=torch.int8)
        ks, vs = torch.zeros(n_pages), torch.zeros(n_pages)
        for p in range(1, n_pages):
            rows = rng.normal(size=(2, page, Hkv, hd)).astype(np.float32)
            TPC.quant_slab_write(k, v, ks, vs, _t(np.full(page, p, np.int32)),
                                 _t(np.arange(page, dtype=np.int32)),
                                 _t(rows[0] * (1 + p % 3)), _t(rows[1]))
        scales = (ks, vs)
    else:
        k, v = (_t(rng.normal(size=shape).astype(np.float32)).to(dtype)
                for _ in range(2))
    pt = _t((1 + rng.permutation(n_pages - 1)).reshape(B, npp)
            .astype(np.int32))
    pos = np.stack([ring_view_positions(x + 1, lay.n_sink, lay.ring_cap,
                                        kw["g"]) for x in ts])
    if "pad_row" in kw:
        pos[kw["pad_row"]] = PAD_SENTINEL
    pos = _t(pos.astype(np.int32))
    t = _t(np.asarray(ts, np.int32))
    return kw, jpat, tpat, (q, k, v, pt, pos, t), scales


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_emulated_paged_split_matches_jax_kernel_and_plain(variant, dtype):
    kw, jpat, tpat, ops, (ks, vs) = _paged_case(variant, dtype)
    q, k, v, pt, pos, t = ops
    B, H, _, hd = q.shape
    page, Hkv, S = kw["page"], kw["Hkv"], pos.shape[1]
    state, stats = kw.get("state", False), kw.get("stats", False)
    units = B * Hkv * -(-(H // Hkv) // ROWS)
    n_split, length = plan_splits(S, units, kw.get("n_sm", N_SM), page)
    assert n_split == (1 if variant == "one_split" else 3), n_split
    scale = hd ** -0.5
    k_req, v_req = TPC.gather_view(k, v, pt, *((ks, vs, dtype)
                                               if ks is not None else ()))
    k_req, v_req = k_req.transpose(1, 2), v_req.transpose(1, 2)
    tile = tile_slots(hd, k.element_size())
    out, m, l = emulate(q, k_req, v_req, pos, t, tpat, scale, n_split,
                        length, tile)
    got = [out if state else out.to(dtype)]
    if state:
        got += [m, l]
    if stats:
        got.append(page_maxima(q, k_req, pos, t, tpat, scale, page))

    var = dict(return_state=state, return_page_stats=stats)
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(JDT[dtype])
                  for x in (q, k, v))
    if ks is not None:
        jk, jv = jnp.asarray(k.numpy()), jnp.asarray(v.numpy())
        var_j = dict(var, k_scale=jnp.asarray(ks.numpy()),
                     v_scale=jnp.asarray(vs.numpy()))
    else:
        var_j = var
    jres = j_paged(jq, jk, jv, pt.numpy(), pos.numpy(), t.numpy(),
                   pattern=jpat, interpret=True, **var_j)
    pres = salo_paged_decode_plain(q, k, v, pt, pos, t, pattern=tpat,
                                   scale=scale, k_scale=ks, v_scale=vs, **var)
    jres = jres if isinstance(jres, tuple) else (jres,)
    pres = pres if isinstance(pres, tuple) else (pres,)
    assert len(got) == len(jres) == len(pres)

    mask = causal_step_mask(tpat, t[:, None], pos, STEP_WINDOW | STEP_GLOBAL)
    live = mask.any(dim=1).numpy()
    assert live.sum() == B - ("pad_row" in kw)
    tol = TOL[dtype]
    n_rows = 3 if state else 1
    for a, jb, pb in zip(got[:n_rows], jres, pres):
        a = a.float().numpy()
        _close(a, np.asarray(jb.astype(jnp.float32)), tol, live)
        _close(a, pb.float().numpy(), tol, live)
    if state:                     # the empty-row identity, exactly
        for a, jb in zip(got[:3], jres):
            np.testing.assert_array_equal(
                a.numpy()[~live], np.asarray(jb.astype(jnp.float32))[~live])
        assert (got[1].numpy()[~live] == NEG_INF).all()
    elif (~live).any():
        assert (out.numpy()[~live] == 0).all()
    if stats:
        pm = got[-1].numpy()
        for ref in (np.asarray(jres[-1]), pres[-1].numpy()):
            dead = (pm <= NEG_INF / 2) | (ref <= NEG_INF / 2)
            np.testing.assert_array_equal(pm[dead], ref[dead])
            np.testing.assert_allclose(pm[~dead], ref[~dead], rtol=tol,
                                       atol=tol)
        assert dead.any() and (~dead).any()


# --------------------------- K5: contiguous ------------------------------ #
CONTIG = {
    # slot = position, lockstep scalar t, S not a multiple of 16
    "full": dict(window=24, g=3, dil=1, S=77, ts=60),
    # ring layout (window 16 + 2 sinks), dilation 2, PAD ring slots, a
    # ragged t vector past the wrap; the first row's live slots sit in
    # split 0
    "ring": dict(window=16, g=2, dil=2, S=18, ts=[5, 40, 123]),
}


def _contig_case(name, dtype):
    c = CONTIG[name]
    rng = np.random.default_rng(7)
    B, H, Hkv, hd, S = 3, 8, 2, 64, c["S"]
    jpat = JP.causal_sliding_window(c["window"], n_sinks=c["g"],
                                    dilation=c["dil"])
    tpat = TP.causal_sliding_window(c["window"], n_sinks=c["g"],
                                    dilation=c["dil"])
    q = _t(rng.normal(size=(B, H, 1, hd)).astype(np.float32)).to(dtype)
    k, v = (_t(rng.normal(size=(B, Hkv, S, hd)).astype(np.float32))
            .to(dtype) for _ in range(2))
    if name == "full":
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        t = np.full(B, c["ts"], np.int32)
    else:
        w, g = c["window"], c["g"]
        t = np.asarray(c["ts"], np.int32)
        j = np.arange(S)
        pos = np.stack([np.where(j < g, j, x - np.mod(x - j, w)) for x in t])
        pos = np.where((j >= g) & (pos < g), PAD_SENTINEL, pos)
        pos[0] = np.where(j < 3, j, PAD_SENTINEL)       # live in split 0 only
    return jpat, tpat, q, k, v, _t(pos.astype(np.int32)), _t(t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("name", list(CONTIG))
@pytest.mark.parametrize("n_sm", [N_SM, 1])
def test_emulated_contiguous_split_matches_jax_kernel_and_plain(name, dtype,
                                                                n_sm):
    jpat, tpat, q, k, v, pos, t = _contig_case(name, dtype)
    B, H, _, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    n_split, length = plan_splits(S, B * Hkv * 1, n_sm)
    assert (n_split > 1) == (n_sm == N_SM)
    scale = hd ** -0.5
    out, _, _ = emulate(q, k, v, pos, t, tpat, scale, n_split, length,
                        tile_slots(hd, k.element_size()))
    out = out.to(dtype).float().numpy()
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(JDT[dtype])
                  for x in (q, k, v))
    jout = j_decode(jq, jk, jv, pos.numpy(), t.numpy(), pattern=jpat,
                    block_s=16, interpret=True)
    pout = salo_decode_plain(q, k, v, pos, t, pattern=tpat, scale=scale)
    live = causal_step_mask(tpat, t[:, None], pos,
                            STEP_WINDOW | STEP_GLOBAL).any(dim=1).numpy()
    assert live.all()
    tol = TOL[dtype]
    _close(out, np.asarray(jout.astype(jnp.float32)), tol, live)
    _close(out, pout.float().numpy(), tol, live)


# ------------------------------ the planner ------------------------------ #
@pytest.mark.parametrize("S,units,n_sm,page", [
    (1040, 24, 132, 16), (1040, 3, 132, 16), (1120, 24, 132, 1),
    (516, 24, 132, 1), (40, 4, 132, 8), (1040, 512, 132, 16),
    (10, 1, 132, 1), (32768, 3, 132, 16), (1040, 3, 132, 12),
    (77, 6, 132, 1), (4096, 64, 132, 32)])
def test_plan_splits_rules(S, units, n_sm, page):
    n, length = plan_splits(S, units, n_sm, page)
    assert 1 <= n <= 64
    assert length % 16 == 0 and length % page == 0
    assert (n - 1) * length < S <= n * length     # every split non-empty
    assert plan_splits(S, units, n_sm, page) == (n, length)
    # about two blocks per SM where the slots allow it, never far above
    assert n * units <= max(units, 2 * n_sm + units)


def test_plan_splits_reads_shapes_only():
    """The plan is a function of shapes and the SM count: no t, no
    positions, so a launch's grid is the same at every step."""
    assert list(inspect.signature(plan_splits).parameters) == [
        "S", "units", "n_sm", "page"]
    assert plan_splits(1040, 24, 132, 16) == (11, 96)     # the serve shapes
    assert plan_splits(1040, 3, 132, 16) == (33, 32)      # one request
    assert plan_splits(1120, 24, 132) == (10, 112)        # the lockstep cache
    assert plan_splits(64, 600, 132, 16)[0] == 1          # a full card
    with pytest.raises(ValueError):
        plan_splits(0, 1, 132)
