"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips (with the reason) on a machine without a
CUDA device. On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.configs.base import SALOConfig
from repro_torch.core.patterns import causal_sliding_window, longformer, vil
from repro_torch.core.scheduler import (PAD_SENTINEL, STEP_GLOBAL,
                                        STEP_WINDOW, causal_step_mask,
                                        ring_view_positions)
from repro_torch.kernels.salo_decode import (salo_paged_decode,
                                             salo_paged_decode_plain)
from repro_torch.models.layers import salo_pattern
from repro_torch.models.model import build_model
from repro_torch.serve.engine import ContinuousConfig, ContinuousEngine
from repro_torch.serve.paged_cache import layout_for_pattern

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda

# f32: same algorithm, other summation order; 16-bit: the kernel rounds p
# to the 16-bit type before the PV product, the plain version does not.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-2}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("hd,H,Hkv,page,dil", [(64, 9, 3, 16, 1),
                                               (128, 4, 4, 8, 2),
                                               (256, 8, 2, 4, 1),
                                               (128, 12, 2, 16, 3),
                                               (128, 56, 8, 16, 1)])
def test_paged_decode_kernel_matches_plain(dtype, hd, H, Hkv, page, dil):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(hd + page)
    pat = causal_sliding_window(40, n_sinks=3, dilation=dil)
    lay = layout_for_pattern(pat, page)
    ts = [0, 2, 37, 90, 301, 15]
    B, npp = len(ts), lay.pages_per_req
    n_pages = 1 + B * npp
    k = torch.randn((n_pages, page, Hkv, hd), generator=g,
                    device="cuda").to(dtype)
    v = torch.randn((n_pages, page, Hkv, hd), generator=g,
                    device="cuda").to(dtype)
    q = torch.randn((B, H, 1, hd), generator=g, device="cuda").to(dtype)
    pt = (torch.randperm(n_pages - 1, generator=g, device="cuda") + 1)
    pt = pt.reshape(B, npp).to(torch.int32)
    pos = np.stack([ring_view_positions(t + 1, lay.n_sink, lay.ring_cap,
                                        lay.n_global) for t in ts])
    pos[-1] = PAD_SENTINEL                       # one row attends nothing
    pos = torch.from_numpy(pos.astype(np.int32)).cuda()
    t = torch.tensor(ts, dtype=torch.int32, device="cuda")
    before = salo_paged_decode.launches
    out = salo_paged_decode(q, k, v, pt, pos, t, pattern=pat)
    ref = salo_paged_decode_plain(q, k, v, pt, pos, t, pattern=pat)
    torch.cuda.synchronize()
    assert salo_paged_decode.launches == before + 1
    live = causal_step_mask(pat, t[:, None], pos,
                            STEP_WINDOW | STEP_GLOBAL).any(dim=1)
    assert live.tolist() == [True] * (B - 1) + [False]
    tol = TOL[dtype]
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               atol=tol, rtol=tol)
    assert bool((out[~live] == 0).all())


def test_engine_tokens_cuda_equal_cpu():
    """The engine on the card (kernel) and on the CPU (plain version) give
    the same greedy tokens for an f32 model with hd 64."""
    _need_cuda()
    cfg = dataclasses.replace(get_smoke("smollm-135m"), d_model=192,
                              n_heads=3, n_kv_heads=1, d_ff=256,
                              salo=SALOConfig(window=16, n_global=2))
    lay = layout_for_pattern(salo_pattern(cfg), 8)
    ccfg = ContinuousConfig(n_pages=1 + 4 * lay.pages_per_req, page=8,
                            chunk=8, max_batch=4)
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (5, 9, 13, 26)]
    outs = {}
    for dev in ("cuda", "cpu"):
        p = {k: ([{a: {b: t.to(dev) for b, t in d.items()}
                   for a, d in layer.items()} for layer in v]
                 if isinstance(v, list) else
                 {b: t.to(dev) for b, t in v.items()})
             for k, v in params.items()}
        eng = ContinuousEngine(build_model(cfg, dev), ccfg, device=dev)
        rids = [eng.submit(x, 8) for x in prompts]
        res = eng.run(p)
        outs[dev] = [res[r].tolist() for r in rids]
    assert outs["cuda"] == outs["cpu"]


# ------------------- K4 variants: int8, page stats, state ---------------- #
def _int8_slab(g, n_pages, page, Hkv, hd):
    """An int8 slab filled through quant_slab_write on the card (twice
    per slot: scale growth and payload rescale included)."""
    from repro_torch.serve.paged_cache import quant_slab_write

    k8 = torch.zeros((n_pages, page, Hkv, hd), dtype=torch.int8,
                     device="cuda")
    v8 = torch.zeros_like(k8)
    ks = torch.zeros(n_pages, device="cuda")
    vs = torch.zeros_like(ks)
    phys = torch.arange(1, n_pages, device="cuda", dtype=torch.int32)
    phys = phys.repeat_interleave(page)
    off = torch.arange(page, device="cuda", dtype=torch.int32).repeat(
        n_pages - 1)
    for gain in (0.5, 2.0):
        rows = torch.randn((2, phys.numel(), Hkv, hd), generator=g,
                           device="cuda") * gain
        quant_slab_write(k8, v8, ks, vs, phys, off, rows[0], rows[1])
    return k8, v8, ks, vs


def _paged_ops(g, pat, lay, ts, q_dtype, H, Hkv, hd, pad_last=True):
    B, npp = len(ts), lay.pages_per_req
    n_pages = 1 + B * npp
    q = torch.randn((B, H, 1, hd), generator=g, device="cuda").to(q_dtype)
    pt = (torch.randperm(n_pages - 1, generator=g, device="cuda") + 1)
    pt = pt.reshape(B, npp).to(torch.int32)
    pos = np.stack([ring_view_positions(t + 1, lay.n_sink, lay.ring_cap,
                                        lay.n_global) for t in ts])
    if pad_last:
        pos[-1] = PAD_SENTINEL                   # one row attends nothing
    pos = torch.from_numpy(pos.astype(np.int32)).cuda()
    t = torch.tensor(ts, dtype=torch.int32, device="cuda")
    live = causal_step_mask(pat, t[:, None], pos,
                            STEP_WINDOW | STEP_GLOBAL).any(dim=1)
    return n_pages, q, pt, pos, t, live


def _check_page_m(pm, ref, tol):
    dead = (pm <= -1e29) | (ref <= -1e29)
    assert torch.equal(pm[dead], ref[dead])
    torch.testing.assert_close(pm[~dead], ref[~dead], atol=tol, rtol=tol)
    assert bool(dead.any()) and bool((~dead).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("hd,H,Hkv,page,dil", [(64, 9, 3, 16, 1),
                                               (128, 4, 4, 8, 2),
                                               (256, 6, 1, 32, 1)])
def test_paged_decode_int8_page_stats_match_plain(dtype, hd, H, Hkv, page,
                                                  dil):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(hd + page + 7)
    pat = causal_sliding_window(40, n_sinks=3, dilation=dil)
    lay = layout_for_pattern(pat, page)
    ts = [0, 2, 37, 90, 301, 15]
    n_pages, q, pt, pos, t, live = _paged_ops(g, pat, lay, ts, dtype, H,
                                              Hkv, hd)
    k8, v8, ks, vs = _int8_slab(g, n_pages, page, Hkv, hd)
    kw = dict(pattern=pat, k_scale=ks, v_scale=vs, return_page_stats=True)
    before = salo_paged_decode.launches
    out, pm = salo_paged_decode(q, k8, v8, pt, pos, t, **kw)
    ref, rpm = salo_paged_decode_plain(q, k8, v8, pt, pos, t, **kw)
    torch.cuda.synchronize()
    assert salo_paged_decode.launches == before + 1
    assert out.dtype == dtype and tuple(pm.shape) == tuple(pt.shape)
    tol = TOL[dtype]
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               atol=tol, rtol=tol)
    assert bool((out[~live] == 0).all())
    _check_page_m(pm, rpm, 1e-4)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_decode_return_state_matches_plain(quant):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(3 + quant)
    H, Hkv, hd, page = 9, 3, 64, 16
    pat = causal_sliding_window(64, n_sinks=4)
    lay = layout_for_pattern(pat, page)
    n_pages, q, pt, pos, t, live = _paged_ops(
        g, pat, lay, [5, 70, 200, 33], torch.float32, H, Hkv, hd)
    if quant:
        k, v, ks, vs = _int8_slab(g, n_pages, page, Hkv, hd)
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        k, v = (torch.randn((n_pages, page, Hkv, hd), generator=g,
                            device="cuda") for _ in range(2))
        kw = {}
    for stats in (False, True):
        res = salo_paged_decode(q, k, v, pt, pos, t, pattern=pat,
                                return_state=True, return_page_stats=stats,
                                **kw)
        ref = salo_paged_decode_plain(q, k, v, pt, pos, t, pattern=pat,
                                      return_state=True,
                                      return_page_stats=stats, **kw)
        assert len(res) == len(ref) == 3 + stats
        out, m, l = res[:3]
        assert out.dtype == m.dtype == l.dtype == torch.float32
        for a, b in zip(res[:3], ref[:3]):
            torch.testing.assert_close(a[live], b[live], atol=1e-5,
                                       rtol=1e-5)
            assert torch.equal(a[~live], b[~live])    # (0, NEG_INF, 0)
        if stats:
            _check_page_m(res[3], ref[3], 1e-5)


# --------------------- K5: contiguous-cache decode ----------------------- #
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("hd,H,Hkv,S", [(64, 9, 3, 300), (128, 4, 4, 77),
                                        (256, 8, 2, 513), (128, 56, 8, 288)])
def test_contiguous_decode_kernel_matches_plain(dtype, hd, H, Hkv, S):
    """The lockstep cache (B, S, Hkv, hd) read through its transposed view
    (no copy), S not a multiple of the 16-slot split grain; positions None,
    shared (S,) or per-request (B, S); t a scalar or a vector."""
    _need_cuda()
    from repro_torch.kernels.salo_decode import salo_decode, salo_decode_plain

    g = torch.Generator(device="cuda").manual_seed(hd + S)
    B = 4
    pat = causal_sliding_window(100, n_sinks=3, dilation=1 + (hd == 128))
    cache = torch.randn((2, B, S, Hkv, hd), generator=g,
                        device="cuda").to(dtype)
    k, v = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    assert not k.is_contiguous()
    q = torch.randn((B, H, 1, hd), generator=g, device="cuda").to(dtype)
    perm = torch.stack([torch.randperm(S, generator=g, device="cuda")
                        for _ in range(B)]).to(torch.int32)
    tv = torch.tensor([0, 50, S // 2, S - 1], dtype=torch.int32,
                      device="cuda")
    cases = [(None, S - 1), (torch.arange(S, dtype=torch.int32,
                                          device="cuda"), tv), (perm, tv)]
    tol = TOL[dtype]
    for positions, t in cases:
        before = salo_decode.launches
        out = salo_decode(q, k, v, positions, t, pattern=pat)
        ref = salo_decode_plain(q, k, v, positions, t, pattern=pat)
        torch.cuda.synchronize()
        assert salo_decode.launches == before + 1
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)


def test_contiguous_decode_ring_layout_and_empty_rows():
    """Ring positions with PAD slots (dilation 2), and rows whose slots are
    all PAD give 0."""
    _need_cuda()
    from repro_torch.kernels.salo_decode import salo_decode, salo_decode_plain

    g = torch.Generator(device="cuda").manual_seed(11)
    B, H, Hkv, hd, w, gs = 3, 6, 2, 64, 24, 2
    pat = causal_sliding_window(w, n_sinks=gs, dilation=2)
    S = w + gs
    k, v = (torch.randn((B, Hkv, S, hd), generator=g, device="cuda")
            for _ in range(2))
    q = torch.randn((B, H, 1, hd), generator=g, device="cuda")
    t = 40
    j = np.arange(S)
    pos = np.where(j < gs, j, t - np.mod(t - j, w))
    pos = np.where((j >= gs) & (pos < gs), PAD_SENTINEL, pos)
    pos = np.stack([pos, pos, np.full(S, PAD_SENTINEL)]).astype(np.int32)
    pos = torch.from_numpy(pos).cuda()
    out = salo_decode(q, k, v, pos, t, pattern=pat)
    ref = salo_decode_plain(q, k, v, pos, t, pattern=pat)
    torch.cuda.synchronize()
    torch.testing.assert_close(out[:2], ref[:2], atol=1e-5, rtol=1e-5)
    assert bool((out[2] == 0).all())


# ------------------- split-KV: determinism, counters, grids ------------- #
def _serve_paged_ops(g, ts, dtype, hd=64, H=9, Hkv=3, int8=False):
    """The serve shapes (window 1024 + 4 sinks, page 16: 65 pages a
    request) for the requests at positions ``ts``."""
    pat = causal_sliding_window(1024, n_sinks=4)
    lay = layout_for_pattern(pat, 16)
    n_pages, q, pt, pos, t, live = _paged_ops(g, pat, lay, ts, dtype, H,
                                              Hkv, hd, pad_last=False)
    if int8:
        k, v, ks, vs = _int8_slab(g, n_pages, 16, Hkv, hd)
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        k, v = (torch.randn((n_pages, 16, Hkv, hd), generator=g,
                            device="cuda").to(dtype) for _ in range(2))
        kw = {}
    return pat, (q, k, v, pt, pos, t), kw, live


@pytest.mark.parametrize("variant", ["k4_fp", "k4_int8_stats",
                                     "k4_f32_state", "k5"])
def test_decode_kernels_bitwise_deterministic(variant):
    """20 calls give bitwise-equal outputs (the split merge does not depend
    on which block finishes last), one launch each."""
    _need_cuda()
    from repro_torch.kernels.salo_decode import salo_decode, split_plan

    g = torch.Generator(device="cuda").manual_seed(21)
    ts = [5, 300, 1027, 1500, 2047, 3000]
    if variant == "k5":
        S = 1120
        pat = causal_sliding_window(1024, n_sinks=4)
        cache = torch.randn((2, 6, S, 3, 64), generator=g,
                            device="cuda").to(torch.bfloat16)
        q = torch.randn((6, 9, 1, 64), generator=g,
                        device="cuda").to(torch.bfloat16)
        args = (q, cache[0].transpose(1, 2), cache[1].transpose(1, 2), None,
                S - 1)
        fn, kw = salo_decode, dict(pattern=pat)
        assert split_plan(q.device, 6, 9, 3, S)[0] > 1
    else:
        dtype = torch.float32 if variant == "k4_f32_state" else \
            torch.bfloat16
        pat, args, kw, _ = _serve_paged_ops(g, ts, dtype,
                                            int8=variant == "k4_int8_stats")
        kw = dict(kw, pattern=pat,
                  return_state=variant == "k4_f32_state",
                  return_page_stats=variant != "k4_fp")
        fn = salo_paged_decode
        assert split_plan(args[0].device, 6, 9, 3, args[3].shape[1] * 16,
                          16)[0] > 1
    first = fn(*args, **kw)
    first = first if isinstance(first, tuple) else (first,)
    for _ in range(20):
        before = fn.launches
        res = fn(*args, **kw)
        assert fn.launches == before + 1
        res = res if isinstance(res, tuple) else (res,)
        assert all(torch.equal(a, b) for a, b in zip(res, first))


def test_decode_counters_reset_between_grids():
    """A call with a larger grid, then a smaller one, then the larger one
    again: every call agrees with the plain version, and the ticket
    counters are all 0 after each (the kernel resets them)."""
    _need_cuda()
    from repro_torch.kernels import salo_decode as SD

    g = torch.Generator(device="cuda").manual_seed(22)
    calls = [[5, 300, 1027, 1500, 2047, 3000, 700, 64], [3000, 1100],
             [5, 300, 1027, 1500, 2047, 3000, 700, 64]]
    for ts in calls:
        pat, ops, kw, live = _serve_paged_ops(g, ts, torch.bfloat16)
        out = salo_paged_decode(*ops, pattern=pat)
        ref = salo_paged_decode_plain(*ops, pattern=pat)
        torch.cuda.synchronize()
        torch.testing.assert_close(out[live].float(), ref[live].float(),
                                   atol=2e-2, rtol=2e-2)
        counters = SD._COUNTERS[ops[0].device.index]
        assert counters.numel() >= len(ts) * 3
        assert int(counters.abs().sum()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,H,Hkv", [(64, 9, 3), (256, 8, 1)])
def test_single_request_many_splits(dtype, hd, H, Hkv):
    """B = 1 at the serve layout (1040 slots): the split carries the grid
    (many splits of whole pages). fp at t = 3000 (every ring slot live),
    and int8 + page stats + state at t = 600 (the later splits dead) agree
    with the plain version."""
    _need_cuda()
    from repro_torch.kernels.salo_decode import split_plan

    g = torch.Generator(device="cuda").manual_seed(hd)
    for int8 in (False, True):
        pat, ops, kw, live = _serve_paged_ops(g, [600 if int8 else 3000],
                                              dtype, hd=hd, H=H, Hkv=Hkv,
                                              int8=int8)
        n_split, length = split_plan(ops[0].device, 1, H, Hkv,
                                     ops[4].shape[1], 16)
        assert n_split >= 16 and length % 16 == 0
        var = dict(kw, pattern=pat, return_state=int8,
                   return_page_stats=int8)
        before = salo_paged_decode.launches
        res = salo_paged_decode(*ops, **var)
        ref = salo_paged_decode_plain(*ops, **var)
        torch.cuda.synchronize()
        assert salo_paged_decode.launches == before + 1
        res = res if isinstance(res, tuple) else (res,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        tol = TOL[dtype]
        for a, b in zip(res[:3 if int8 else 1], ref):
            torch.testing.assert_close(a.float(), b.float(), atol=tol,
                                       rtol=tol)
        if int8:
            _check_page_m(res[-1], ref[-1], tol)


def _smoke_hd64(**salo):
    return dataclasses.replace(get_smoke("smollm-135m"), d_model=192,
                               n_heads=3, n_kv_heads=1, d_ff=256,
                               salo=SALOConfig(**salo))


def _params_on(params, dev):
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x.to(dev), params)


def test_int8_page_sparse_engine_cuda_equals_cpu():
    """int8 slab + page skipping (window 64, threshold -3, decay 0.3):
    greedy tokens and page counters equal on the card and on the CPU, and
    pages are really skipped."""
    _need_cuda()
    cfg = _smoke_hd64(window=64, n_global=2)
    lay = layout_for_pattern(salo_pattern(cfg), 8)
    ccfg = ContinuousConfig(n_pages=1 + 4 * lay.pages_per_req, page=8,
                            chunk=8, max_batch=4, kv_dtype="int8",
                            page_sparsity_threshold=-3.0,
                            page_stat_decay=0.3)
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(5))
    for layer in params["seg0_attn_mlp"]:
        layer["attn"]["wo"] *= 6.0
        layer["mlp"]["w_out"] *= 6.0
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (24, 17, 9, 30)]
    outs, counters = {}, {}
    for dev in ("cuda", "cpu"):
        eng = ContinuousEngine(build_model(cfg, dev), ccfg, device=dev)
        rids = [eng.submit(x, 24) for x in prompts]
        res = eng.run(_params_on(params, dev))
        outs[dev] = [res[r].tolist() for r in rids]
        counters[dev] = dict(eng.counters)
    assert outs["cuda"] == outs["cpu"]
    assert counters["cuda"] == counters["cpu"]
    c = counters["cuda"]
    assert 0 < c["decode_pages_read"] < c["decode_pages_total"]


# ------------------- fault tolerance: snapshots on the card -------------- #
@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_engine_snapshot_restores_on_cuda(tmp_path, kv):
    """A CUDA engine's snapshot, written to disk after 4 steps and
    restored into a fresh CUDA engine: every slab tensor and the slot map
    stay on the card, and the tokens and counters equal the uninterrupted
    CUDA run's. The snapshot taken before the further steps is unchanged
    by them (its tensors are clones)."""
    from repro_torch.ft import restore, save

    _need_cuda()
    cfg = _smoke_hd64(window=64, n_global=2)
    lay = layout_for_pattern(salo_pattern(cfg), 8)
    extra = (dict(kv_dtype="int8", page_sparsity_threshold=-3.0,
                  page_stat_decay=0.3) if kv == "int8" else {})
    ccfg = ContinuousConfig(n_pages=1 + 4 * lay.pages_per_req, page=8,
                            chunk=8, max_batch=4, **extra)
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(6))
    for layer in params["seg0_attn_mlp"]:
        layer["attn"]["wo"] *= 6.0
        layer["mlp"]["w_out"] *= 6.0
    params = _params_on(params, "cuda")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (24, 17, 9, 50)]
    model = build_model(cfg, "cuda")

    def fresh():
        eng = ContinuousEngine(model, ccfg, device="cuda")
        return eng, [eng.submit(x, 16) for x in prompts]

    eng, rids = fresh()
    for _ in range(4):
        eng.step(params)
    snap = eng.state_dict()
    frozen = [a.clone() for s in snap["slabs"].values() for a in s.tensors()]
    save(tmp_path, snap, 4)
    res = eng.run(params)
    assert all(torch.equal(a, b) for a, b in zip(
        [a for s in snap["slabs"].values() for a in s.tensors()], frozen))

    eng2, _ = fresh()
    eng2.load_state(restore(tmp_path, eng2.state_dict()))
    tensors = [a for s in eng2.slabs.values() for a in s.tensors()]
    assert all(a.is_cuda for a in tensors) and eng2.slot_pos.is_cuda
    res2 = eng2.run(params)
    assert [res2[r].tolist() for r in rids] == [res[r].tolist()
                                                for r in rids]
    assert dict(eng2.counters) == dict(eng.counters)


def test_restore_gives_cuda_leaves_of_the_like_dtype(tmp_path):
    from repro_torch.ft import restore, save

    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(1)
    tree = {"bf16": torch.randn(8, 3, generator=g, device="cuda").bfloat16(),
            "f32": torch.randn(5, generator=g, device="cuda"),
            "i8": torch.ones(4, dtype=torch.int8, device="cuda"),
            "step": 3}
    save(tmp_path, tree, 1)
    got = restore(tmp_path, tree)
    for k in ("bf16", "f32", "i8"):
        assert got[k].is_cuda and got[k].dtype == tree[k].dtype
        assert torch.equal(got[k], tree[k])
    assert got["step"] == 3 and isinstance(got["step"], int)


@pytest.mark.parametrize("ring", [False, True])
def test_lockstep_engine_cuda_equals_cpu(ring):
    _need_cuda()
    from repro_torch.kernels.salo_decode import salo_decode, salo_decode_plain
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = _smoke_hd64(window=16, n_global=2, ring_cache=ring)
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(1))
    for layer in params["seg0_attn_mlp"]:
        layer["attn"]["wo"] *= 6.0
        layer["mlp"]["w_out"] *= 6.0
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 21))
    outs = {}
    for dev in ("cuda", "cpu"):
        launches, calls = salo_decode.launches, salo_decode_plain.calls
        eng = ServeEngine(build_model(cfg, dev), ServeConfig(max_len=33))
        outs[dev] = eng.generate(_params_on(params, dev), prompts,
                                 12).cpu().tolist()
        steps = (21 + 12) * cfg.n_layers
        if dev == "cuda":
            assert salo_decode.launches - launches == steps
            assert salo_decode_plain.calls == calls
        else:
            assert salo_decode_plain.calls - calls == steps
    assert outs["cuda"] == outs["cpu"]


# ------------------- training kernels K1, K2, K3 ------------------------ #
def _train_case(pat, n, bh, hd, bq, bk, dtype, seed):
    from repro_torch.core.blockwise import plan_tables
    from repro_torch.core.scheduler import schedule

    sched = schedule(pat, n)
    plan = sched.plan(bq, bk)
    t = plan_tables(plan, torch.device("cuda", 0))
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((bh, plan.n_pad, hd), generator=g,
                           device="cuda").to(dtype) for _ in range(3))
    dout = torch.randn((bh, plan.n_pad, hd), generator=g, device="cuda")
    pos_q = t.pos.reshape(plan.nq, bq)
    pos_k = t.pos.reshape(plan.nkb, bk)
    return sched, plan, t, (q, k, v, dout, pos_q, pos_k)


# The forward's out within salo_attention.OUT_TOL (f32 1e-5; 16-bit 8e-3,
# two bf16 ulps at 0.5: out is returned in the 16-bit type and the forward
# rounds p to it relative to another running max), m and l within
# STATS_TOL (1e-5). f32 gradients: same algorithm, other summation order
# (1e-4). 16-bit dq 2e-2: it is returned in the 16-bit type; beyond that it
# must equal the plain f32 dq rounded to its type on all but
# KB.DQ_OFF_SHARE of its elements. dk/dv (f32 outputs) within KB.DKV_TOL:
# the 16-bit kernels split every f32 operand into 16-bit hi + lo
# (tests/test_torch_backward_numerics.py shows the split inside and one
# 16-bit rounding outside these).
GTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}
TRAIN_PATTERNS = {
    "causal_sinks": causal_sliding_window(100, n_sinks=4),
    "dilated_sinks": causal_sliding_window(24, n_sinks=3, dilation=2),
    "vil": vil((12, 12), (5, 3), n_global=1),
    "longformer": longformer(48, n_global=2),
    # gemma-7b's and longformer-4k's patterns, at their own n
    "gemma_7b": causal_sliding_window(1024, n_sinks=4),
    "longformer_4k": longformer(512, n_global=1),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("pname,n,hd,bq,bk", [
    ("causal_sinks", 512, 64, 256, 256), ("causal_sinks", 300, 128, 64, 32),
    ("dilated_sinks", 200, 64, 32, 32), ("vil", 145, 128, 32, 64),
    ("longformer", 333, 64, 128, 64),
    # hd 256: the column split over blocks (16-bit), the staged hd chunks
    # (f32); 32-key tiles leave rows of the ring empty
    ("causal_sinks", 512, 256, 256, 256), ("dilated_sinks", 200, 256, 32, 32),
    ("vil", 145, 256, 32, 64), ("longformer", 333, 256, 128, 64)])
def test_training_kernels_match_plain(dtype, pname, n, hd, bq, bk):
    _need_cuda()
    from repro_torch.kernels import salo_attention as KA
    from repro_torch.kernels import salo_backward as KB

    sched, plan, t, (q, k, v, dout, pq, pk) = _train_case(
        TRAIN_PATTERNS[pname], n, 3, hd, bq, bk, dtype, seed=n + hd)
    kw = dict(sched=sched, scale=hd ** -0.5)
    launches = [f.launches for f in (KA.salo_table_attention,
                                     KB.salo_table_backward_dq,
                                     KB.salo_table_backward_dkv)]
    out, m, l = KA.salo_table_attention(q, k, v, pq, pk, t.kv_blocks,
                                        t.flags, **kw)
    ro, rm, rl = KA.salo_table_attention_plain(q, k, v, pq, pk, t.kv_blocks,
                                               t.flags, **kw)
    delta = (dout * ro.float()).sum(-1)
    bwd = (dout, delta, rm, rl, q, k, v, pq, pk)
    dq = KB.salo_table_backward_dq(*bwd, t.kv_blocks, t.flags, **kw)
    rdq = KB.salo_table_backward_dq_plain(*bwd, t.kv_blocks, t.flags, **kw)
    dkv_t = (t.row_tile, t.q_blocks, t.pk_flags)
    dk, dv = KB.salo_table_backward_dkv(*bwd, *dkv_t, **kw)
    rdk, rdv = KB.salo_table_backward_dkv_plain(*bwd, *dkv_t, **kw)
    torch.cuda.synchronize()
    assert [f.launches for f in (KA.salo_table_attention,
                                 KB.salo_table_backward_dq,
                                 KB.salo_table_backward_dkv)] == \
        [x + d for x, d in zip(launches, (1, 1, 2))]   # K3: walk + sum
    tol, gtol, ktol = KA.OUT_TOL[dtype], GTOL[dtype], KB.DKV_TOL[dtype]
    stol = KA.STATS_TOL
    for a, b, tl in ((out, ro, tol), (m, rm, stol), (l, rl, stol),
                     (dq, rdq, gtol), (dk, rdk, ktol), (dv, rdv, ktol)):
        torch.testing.assert_close(a.float(), b.float(), atol=tl, rtol=tl)
    if dtype != torch.float32:
        assert KB.dq_off_share(dq, rdq) <= KB.DQ_OFF_SHARE
    pad = t.pos >= sched.n
    assert bool((m[:, pad] == -1e30).all() and (l[:, pad] == 0).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("pname,n,hd,bq,bk", [
    ("causal_sinks", 512, 64, 256, 256), ("vil", 145, 128, 32, 64),
    ("causal_sinks", 512, 256, 256, 256)])
def test_backward_kernels_keep_precision_at_small_dout(dtype, pname, n, hd,
                                                       bq, bk):
    """dout at 2^-20 of unit scale, as a train step's (the gradient of a
    mean over many tokens): below f16's normal range, where the kernels'
    power-of-two scale keeps the split's bits. Compared relative to that
    scale."""
    _need_cuda()
    from repro_torch.kernels import salo_attention as KA
    from repro_torch.kernels import salo_backward as KB

    small = 2.0 ** -20
    sched, plan, t, (q, k, v, dout, pq, pk) = _train_case(
        TRAIN_PATTERNS[pname], n, 3, hd, bq, bk, dtype, seed=n + hd)
    dout = dout * small
    kw = dict(sched=sched, scale=hd ** -0.5)
    ro, rm, rl = KA.salo_table_attention_plain(q, k, v, pq, pk, t.kv_blocks,
                                               t.flags, **kw)
    delta = (dout * ro.float()).sum(-1)
    bwd = (dout, delta, rm, rl, q, k, v, pq, pk)
    dkv_t = (t.row_tile, t.q_blocks, t.pk_flags)
    dq = KB.salo_table_backward_dq(*bwd, t.kv_blocks, t.flags, **kw)
    rdq = KB.salo_table_backward_dq_plain(*bwd, t.kv_blocks, t.flags, **kw)
    dk, dv = KB.salo_table_backward_dkv(*bwd, *dkv_t, **kw)
    rdk, rdv = KB.salo_table_backward_dkv_plain(*bwd, *dkv_t, **kw)
    torch.cuda.synchronize()
    ktol = KB.DKV_TOL[dtype]
    for a, b in ((dk, rdk), (dv, rdv)):
        torch.testing.assert_close(a / small, b / small, atol=ktol, rtol=ktol)
    assert KB.dq_off_share(dq, rdq) <= KB.DQ_OFF_SHARE


@pytest.mark.parametrize("pat,n,bh,hd,bq,bk", [
    (causal_sliding_window(64, n_sinks=4, dilation=2), 1024, 8, 64, 32, 32),
    (causal_sliding_window(200, n_sinks=4), 2048, 4, 128, 64, 128),
    (causal_sliding_window(64, n_sinks=4, dilation=2), 1024, 4, 256, 32, 32)])
def test_dkv_bitwise_deterministic(pat, n, bh, hd, bq, bk):
    _need_cuda()
    from repro_torch.kernels import salo_backward as KB

    sched, plan, t, (q, k, v, dout, pq, pk) = _train_case(
        pat, n, bh, hd, bq, bk, torch.bfloat16, seed=1)
    pkd = plan.transposed_packed()
    assert pkd.n_rows > len(set(pkd.row_tile.tolist()))   # a split row
    m = torch.randn(q.shape[:2], device="cuda")
    l = torch.rand(q.shape[:2], device="cuda") + 0.5
    delta = torch.randn(q.shape[:2], device="cuda")
    args = (dout, delta, m, l, q, k, v, pq, pk, t.row_tile, t.q_blocks,
            t.pk_flags)
    kw = dict(sched=sched, scale=0.125)
    dk1, dv1 = KB.salo_table_backward_dkv(*args, **kw)
    dk2, dv2 = KB.salo_table_backward_dkv(*args, **kw)
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_backward_padding_query_blocks_give_exact_zeros(dtype):
    """n 129 on 32-row query blocks: blocks 5-7 hold only padding rows, and
    their dq, and the dk/dv of every padding key, are exact zeros."""
    _need_cuda()
    from repro_torch.kernels import salo_attention as KA
    from repro_torch.kernels import salo_backward as KB

    sched, plan, t, (q, k, v, dout, pq, pk) = _train_case(
        causal_sliding_window(100, n_sinks=4), 129, 3, 64, 32, 128, dtype,
        seed=5)
    pad = t.pos >= sched.n
    assert bool(pad.reshape(plan.nq, 32).all(dim=1)[5:].all())
    kw = dict(sched=sched, scale=0.125)
    _, m, l = KA.salo_table_attention(q, k, v, pq, pk, t.kv_blocks, t.flags,
                                      **kw)
    delta = torch.randn(q.shape[:2], device="cuda")
    bwd = (dout, delta, m, l, q, k, v, pq, pk)
    dq = KB.salo_table_backward_dq(*bwd, t.kv_blocks, t.flags, **kw)
    dk, dv = KB.salo_table_backward_dkv(*bwd, t.row_tile, t.q_blocks,
                                        t.pk_flags, **kw)
    torch.cuda.synchronize()
    for x in (dq, dk, dv):
        assert bool(torch.isfinite(x).all())
        assert bool((x[:, pad] == 0).all())
    assert bool((dq[:, ~pad] != 0).any() and (dv[:, ~pad] != 0).any())


@pytest.mark.parametrize("rows_q", [True, False])
@pytest.mark.parametrize("pname,n", [("causal_sinks", 700),
                                     ("dilated_sinks", 500), ("vil", 145),
                                     ("longformer", 333), ("gemma_7b", 4096),
                                     ("longformer_4k", 4096)])
def test_mask_2x16_matches_step_mask(pname, n, rows_q):
    """The 16-bit backward kernels' mask evaluator (``mask_2x16`` in
    ``csrc/salo_mma.cuh``: the pattern's branches hoisted, whole-grid
    answers from position ranges) against ``step_mask`` pair by pair, on
    the working positions (padding included) in the kernels' fragment
    layout: a thread's 2 rows g, g + 8 and 16 columns 8j + 2t + (0, 1) of
    a 64-wide sub-tile, rows near and far from the columns, every flag."""
    _need_cuda()
    import ctypes

    from repro_torch.core.blockwise import plan_tables
    from repro_torch.core.scheduler import schedule
    from repro_torch.kernels import _build
    from repro_torch.kernels.salo_attention import MaskSpec, mask_spec

    sched = schedule(TRAIN_PATTERNS[pname], n)
    pos = plan_tables(sched.plan(32, 32), torch.device("cpu")).pos.numpy()
    ext = np.concatenate([pos, np.full(128, PAD_SENTINEL, pos.dtype)])
    rng = np.random.default_rng(n)
    units = 20000
    s0 = rng.integers(0, len(pos), units)
    t = rng.integers(0, 4, units)
    cols = (s0[:, None] + 8 * (np.arange(16) // 2)[None]
            + 2 * t[:, None] + (np.arange(16) % 2)[None])
    near = s0 + rng.integers(-96, 97, units) + rng.integers(0, 8, units)
    far = rng.integers(0, len(pos), units)
    r0 = np.clip(np.where(rng.random(units) < 0.7, near, far), 0,
                 len(pos) - 1)
    rows = r0[:, None] + np.array([0, 8])[None]
    dev = torch.device("cuda", 0)

    def on_dev(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)

    rp, cp = on_dev(ext[rows]), on_dev(ext[cols])
    fl = on_dev(rng.integers(0, 4, units))
    fast = torch.empty(units, dtype=torch.int32, device=dev)
    ref = torch.empty_like(fast)
    fn = _build.load("salo_table_backward").salo_mask_2x16_check
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ctypes.POINTER(MaskSpec), vp, vp, vp, vp, vp, ci, ci, vp]
    fn.restype = ci
    spec = mask_spec(sched)
    err = fn(ctypes.byref(spec), rp.data_ptr(), cp.data_ptr(), fl.data_ptr(),
             fast.data_ptr(), ref.data_ptr(), units, int(rows_q),
             torch.cuda.current_stream(dev).cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    assert torch.equal(fast, ref)
    # grids with no pair in and with some came up; with all 32 in where the
    # window spans a sub-tile's 64 columns and is undilated
    assert bool((ref == 0).any() and ((ref != 0) & (ref != -1)).any())
    assert bool((ref == -1).any()) == (pname in ("causal_sinks", "gemma_7b",
                                                 "longformer_4k"))


def test_training_kernel_wrappers_raise_on_unsupported():
    _need_cuda()
    from repro_torch.kernels import salo_attention as KA

    pat = causal_sliding_window(64, n_sinks=2)
    sched, plan, t, (q, k, v, dout, pq, pk) = _train_case(
        pat, 256, 2, 64, 64, 64, torch.float32, seed=0)
    kw = dict(sched=sched, scale=0.125)
    tabs = (pq, pk, t.kv_blocks, t.flags)
    with pytest.raises(TypeError):                       # dtype
        KA.salo_table_attention(q.double(), k.double(), v.double(), *tabs,
                                **kw)
    with pytest.raises(ValueError, match="contiguous"):  # layout
        qt = q.transpose(0, 1).contiguous().transpose(0, 1)
        KA.salo_table_attention(qt, k, v, *tabs, **kw)
    with pytest.raises(ValueError, match="head_dim"):    # hd
        KA.salo_table_attention(q[..., :32].contiguous(),
                                k[..., :32].contiguous(),
                                v[..., :32].contiguous(), *tabs, **kw)
    _, plan16, t16, ops16 = _train_case(pat, 256, 2, 64, 16, 16,
                                        torch.float32, seed=0)
    with pytest.raises(ValueError, match="block"):       # block size
        KA.salo_table_attention(*ops16[:3], *ops16[4:], t16.kv_blocks,
                                t16.flags, **kw)


def test_attention_op_cuda_equals_cpu():
    """The op end to end (forward + autograd backward through K1, K2, K3)
    on the card equals its plain versions on the CPU, f32, GQA."""
    _need_cuda()
    from repro_torch.core.attention import hybrid_attention

    pat = causal_sliding_window(48, n_sinks=4)
    rng = np.random.default_rng(0)
    x = [rng.normal(size=s).astype(np.float32) for s in
         ((2, 4, 200, 64), (2, 2, 200, 64), (2, 2, 200, 64),
          (2, 4, 200, 64))]
    res = {}
    for dev in ("cuda", "cpu"):
        q, k, v = (torch.tensor(a, device=dev, requires_grad=True)
                   for a in x[:3])
        out = hybrid_attention(q, k, v, pat, block_q=64, block_k=32)
        (out * torch.tensor(x[3], device=dev)).sum().backward()
        res[dev] = [y.detach().cpu() for y in (out, q.grad, k.grad, v.grad)]
    for a, b in zip(res["cuda"], res["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


# --------------- runtime plans: K1 and K2 on device tables --------------- #
# (pattern, n, hd, block_q, block_k, keep): keep below the plan's max_steps
# and at or above its always-kept count, so rows keep a content-chosen
# subset of their tiles that need not be consecutive
DYN_CASES = [
    ("causal_sinks", causal_sliding_window(200, n_sinks=4), 1024, 64, 64, 32,
     6),
    ("dilated_sinks", causal_sliding_window(64, n_sinks=3, dilation=2), 512,
     128, 32, 32, 4),
    ("longformer", longformer(48, n_global=2), 333, 64, 32, 32, 4),
    ("vil", vil((16, 16), (5, 5), n_global=1), 257, 128, 32, 32, 4),
    ("causal_sinks_hd256", causal_sliding_window(100, n_sinks=4), 512, 256,
     64, 64, 4),
    ("longformer_hd256", longformer(48, n_global=2), 333, 256, 32, 32, 4),
]


def _dyn_tables(plan, q, k, keep):
    from repro_torch.core import dynamic as DY
    from repro_torch.core.plan_contract import validate_tables

    cfg = DY.DynamicConfig(keep=keep)
    window = DY._resolve_window(cfg, plan.block_q, plan.block_k)
    kvt, flg = DY._selected(q, k, plan, cfg, window, keep,
                            q.shape[-1] ** -0.5)
    validate_tables(kvt, flg, nkb=plan.nkb)
    return kvt, flg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pname,pat,n,hd,bq,bk,keep", DYN_CASES,
                         ids=[c[0] for c in DYN_CASES])
def test_training_kernels_on_device_tables_match_plain(dtype, pname, pat, n,
                                                       hd, bq, bk, keep):
    """K1 and K2 on step tables selected on the card (width keep, a
    content-chosen tile subset per row) against their plain versions on
    the same tables."""
    _need_cuda()
    from repro_torch.kernels import salo_attention as KA
    from repro_torch.kernels import salo_backward as KB

    sched, plan, t, (q, k, v, dout, pq, pk) = _train_case(
        pat, n, 3, hd, bq, bk, dtype, seed=n + hd + keep)
    assert keep < plan.max_steps
    kvt, flg = _dyn_tables(plan, q, k, keep)
    assert kvt.shape == (plan.nq, keep)
    assert int((flg != 0).sum()) < int((plan.flags != 0).sum())
    kw = dict(sched=sched, scale=hd ** -0.5)
    out, m, l = KA.salo_table_attention(q, k, v, pq, pk, kvt, flg, **kw)
    ro, rm, rl = KA.salo_table_attention_plain(q, k, v, pq, pk, kvt, flg,
                                               **kw)
    delta = (dout * ro.float()).sum(-1)
    bwd = (dout, delta, rm, rl, q, k, v, pq, pk)
    dq = KB.salo_table_backward_dq(*bwd, kvt, flg, **kw)
    rdq = KB.salo_table_backward_dq_plain(*bwd, kvt, flg, **kw)
    torch.cuda.synchronize()
    tol, gtol, stol = KA.OUT_TOL[dtype], GTOL[dtype], KA.STATS_TOL
    for a, b, tl in ((out, ro, tol), (m, rm, stol), (l, rl, stol),
                     (dq, rdq, gtol)):
        torch.testing.assert_close(a.float(), b.float(), atol=tl, rtol=tl)
    if dtype != torch.float32:
        assert KB.dq_off_share(dq, rdq) <= KB.DQ_OFF_SHARE
    pad = t.pos >= sched.n
    assert bool((m[:, pad] == -1e30).all() and (l[:, pad] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_dkv_bitwise_deterministic(dtype):
    """The scatter dK/dV (query blocks of one step share tiles) gives
    bitwise-equal results over repeated calls on the card."""
    _need_cuda()
    from repro_torch.core.blockwise import table_dkv_scatter_scan

    pname, pat, n, hd, bq, bk, keep = DYN_CASES[0]
    sched, plan, t, (q, k, v, dout, pq, pk) = _train_case(
        pat, n, 8, hd, bq, bk, dtype, seed=3)
    kvt, flg = _dyn_tables(plan, q, k, keep)
    m = torch.randn(q.shape[:2], device="cuda")
    l = torch.rand(q.shape[:2], device="cuda") + 0.5
    delta = torch.randn(q.shape[:2], device="cuda")
    args = (dout, delta, m, l, q, k, v, pq, pk, kvt, flg, sched, 0.125)
    first = table_dkv_scatter_scan(*args)
    for _ in range(3):
        again = table_dkv_scatter_scan(*args)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("pname,pat,n,hd,bq,bk,keep", DYN_CASES[:4],
                         ids=[c[0] for c in DYN_CASES[:4]])
def test_dynamic_op_cuda_equals_cpu(pname, pat, n, hd, bq, bk, keep):
    """hybrid_attention(plan="dynamic") end to end, f32, GQA: the tables
    built on the card equal the CPU's, out and the three gradients within
    1e-4, and a fwd + bwd on the card launches K1 once, K2 once, K3
    never."""
    _need_cuda()
    from repro_torch.core import dynamic as DY
    from repro_torch.core.attention import hybrid_attention
    from repro_torch.kernels import salo_attention as KA
    from repro_torch.kernels import salo_backward as KB

    rng = np.random.default_rng(n)
    x = [rng.normal(size=s).astype(np.float32) for s in
         ((2, 4, n, hd), (2, 2, n, hd), (2, 2, n, hd), (2, 4, n, hd))]
    res, tabs = {}, {}
    for dev in ("cuda", "cpu"):
        q, k, v = (torch.tensor(a, device=dev, requires_grad=True)
                   for a in x[:3])
        fns = (KA.salo_table_attention, KB.salo_table_backward_dq,
               KB.salo_table_backward_dkv)
        before = [f.launches for f in fns]
        out = hybrid_attention(q, k, v, pat, block_q=bq, block_k=bk,
                               plan="dynamic", dynamic_keep=keep)
        (out * torch.tensor(x[3], device=dev)).sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 0]
        res[dev] = [y.detach().cpu() for y in (out, q.grad, k.grad, v.grad)]
        kf = k.detach()[:, :, None].expand(2, 2, 2, n, hd).reshape(8, n, hd)
        tabs[dev] = [y.cpu() for y in DY.dynamic_tables(
            q.detach().reshape(8, n, hd), kf, pat,
            DY.DynamicConfig(keep=keep), block_q=bq, block_k=bk)[1:3]]
    assert all(torch.equal(a, b) for a, b in zip(tabs["cuda"], tabs["cpu"]))
    for a, b in zip(res["cuda"], res["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_dots_train_step_cuda_equals_cpu():
    """Two train steps of a 2-layer f32 model under remat="dots" on the
    card (K1-K3, selective checkpointing) equal the CPU's within 1e-4."""
    _need_cuda()
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import Schedule
    from repro_torch.train.trainer import TrainConfig, make_train_step
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(
        get_smoke("smollm-135m"), d_model=192, n_heads=3, n_kv_heads=1,
        d_ff=256, remat="dots",
        salo=SALOConfig(window=16, n_global=2, block_q=32, block_k=32))
    tcfg = TrainConfig(optimizer=adamw.AdamWConfig(lr=3e-3),
                       schedule=Schedule(warmup_steps=1, total_steps=2))
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    ds = SyntheticLM(cfg, DataConfig(128, 2, seed=0))
    hist = {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda a: a.to(dev), params)
        step = make_train_step(build_model(cfg, dev), tcfg)
        opt = adamw.init(tcfg.optimizer, p)
        hist[dev] = []
        for i in range(2):
            p, opt, met, _ = step(p, opt, ds.batch(i))
            hist[dev].append((float(met["loss"]), float(met["grad_norm"])))
    np.testing.assert_allclose(np.array(hist["cuda"]), np.array(hist["cpu"]),
                               rtol=1e-4, atol=1e-4)


# ------------- the recurrent families: recurrentgemma, mamba2 ------------ #
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_contiguous_decode_hd256_one_kv_head(dtype):
    """K5 at recurrentgemma-9b's decode layout: 16 query heads on one KV
    head of hd 256 (4 row groups of the kernel's 4 rows), a full cache
    past the window with sinks, scalar and per-request t."""
    _need_cuda()
    from repro_torch.kernels.salo_decode import salo_decode, salo_decode_plain

    g = torch.Generator(device="cuda").manual_seed(256)
    B, H, Hkv, hd, S = 4, 16, 1, 256, 700
    pat = causal_sliding_window(512, n_sinks=4)
    cache = torch.randn((2, B, S, Hkv, hd), generator=g,
                        device="cuda").to(dtype)
    k, v = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    q = torch.randn((B, H, 1, hd), generator=g, device="cuda").to(dtype)
    tv = torch.tensor([3, 300, 600, S - 1], dtype=torch.int32,
                      device="cuda")
    for t in (S - 1, tv):
        out = salo_decode(q, k, v, None, t, pattern=pat)
        ref = salo_decode_plain(q, k, v, None, t, pattern=pat)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                                   rtol=TOL[dtype])
        assert torch.equal(out, salo_decode(q, k, v, None, t, pattern=pat))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_training_kernels_match_plain_one_kv_head(dtype):
    """K1, K2, K3 at recurrentgemma-9b's attention layout (B*H = 16 copies
    of one KV head, hd 256, window with 4 sinks, block 256) at a narrowed
    n, against their plain versions."""
    _need_cuda()
    from repro_torch.kernels import salo_attention as KA
    from repro_torch.kernels import salo_backward as KB

    pat = causal_sliding_window(512, n_sinks=4)
    sched, plan, t, (q, k, v, dout, pq, pk) = _train_case(
        pat, 1100, 16, 256, 256, 256, dtype, seed=16)
    k = k[:1].expand_as(k).contiguous()        # the GQA expand's copies
    v = v[:1].expand_as(v).contiguous()
    kw = dict(sched=sched, scale=256 ** -0.5)
    out, m, l = KA.salo_table_attention(q, k, v, pq, pk, t.kv_blocks,
                                        t.flags, **kw)
    ro, rm, rl = KA.salo_table_attention_plain(q, k, v, pq, pk, t.kv_blocks,
                                               t.flags, **kw)
    delta = (dout * ro.float()).sum(-1)
    bwd = (dout, delta, rm, rl, q, k, v, pq, pk)
    dq = KB.salo_table_backward_dq(*bwd, t.kv_blocks, t.flags, **kw)
    rdq = KB.salo_table_backward_dq_plain(*bwd, t.kv_blocks, t.flags, **kw)
    dkv_t = (t.row_tile, t.q_blocks, t.pk_flags)
    dk, dv = KB.salo_table_backward_dkv(*bwd, *dkv_t, **kw)
    rdk, rdv = KB.salo_table_backward_dkv_plain(*bwd, *dkv_t, **kw)
    torch.cuda.synchronize()
    tol, gtol, ktol = KA.OUT_TOL[dtype], GTOL[dtype], KB.DKV_TOL[dtype]
    stol = KA.STATS_TOL
    for a, b, tl in ((out, ro, tol), (m, rm, stol), (l, rl, stol),
                     (dq, rdq, gtol), (dk, rdk, ktol), (dv, rdv, ktol)):
        torch.testing.assert_close(a.float(), b.float(), atol=tl, rtol=tl)


def test_attention_op_one_kv_head_cuda_equals_cpu():
    """The op with one KV head under 16 query heads of hd 256, f32: the
    16 copies' dK/dV sum back to the one head through autograd of the
    expand, on the card as on the CPU."""
    _need_cuda()
    from repro_torch.core.attention import hybrid_attention

    pat = causal_sliding_window(64, n_sinks=4)
    rng = np.random.default_rng(3)
    x = [rng.normal(size=s).astype(np.float32) for s in
         ((1, 16, 160, 256), (1, 1, 160, 256), (1, 1, 160, 256),
          (1, 16, 160, 256))]
    res = {}
    for dev in ("cuda", "cpu"):
        q, k, v = (torch.tensor(a, device=dev, requires_grad=True)
                   for a in x[:3])
        out = hybrid_attention(q, k, v, pat, block_q=32, block_k=32)
        (out * torch.tensor(x[3], device=dev)).sum().backward()
        res[dev] = [y.detach().cpu() for y in (out, q.grad, k.grad, v.grad)]
    assert res["cuda"][2].shape == (1, 1, 160, 256)
    for a, b in zip(res["cuda"], res["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def _recurrent_cfg(arch):
    """recurrentgemma narrowed to widths its kernels take (one KV head of
    hd 256 under 2 query heads, local window 32 + 4 sinks, 32-wide
    blocks); mamba2 at its smoke widths."""
    from repro_torch.configs.base import RecurrentConfig

    if arch == "mamba2-370m":
        return get_smoke(arch)
    return dataclasses.replace(
        get_smoke(arch), d_model=256, n_heads=2, n_kv_heads=1, head_dim=256,
        d_ff=512, recurrent=RecurrentConfig(local_window=32),
        salo=SALOConfig(window=32, n_global=4, block_q=32, block_k=32))


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-370m"])
def test_recurrent_models_cuda_equal_cpu(arch):
    """The recurrent models, f32: two train steps (recurrentgemma's local
    attention through K1, K2, K3; loss and grad norm within 1e-4) and the
    lockstep engine's greedy tokens past the local window (through K5),
    equal on the card and on the CPU."""
    _need_cuda()
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import Schedule
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.train.trainer import TrainConfig, make_train_step
    from repro_torch.tree import tree_flatten_with_path

    cfg = _recurrent_cfg(arch)
    tcfg = TrainConfig(optimizer=adamw.AdamWConfig(lr=3e-3),
                       schedule=Schedule(warmup_steps=1, total_steps=2))
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(2))
    for path, leaf in tree_flatten_with_path(params)[0]:
        if path[-1] in ("w_out", "wo"):    # tokens that use every block
            leaf.mul_(6.0)
    ds = SyntheticLM(cfg, DataConfig(128, 2, seed=2))
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 40))
    hist, toks = {}, {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, dev)
        toks[dev] = ServeEngine(model, ServeConfig(max_len=48)).generate(
            _params_on(params, dev), prompts, 8).cpu().tolist()
        p = _params_on(params, dev)
        step = make_train_step(model, tcfg)
        opt = adamw.init(tcfg.optimizer, p)
        hist[dev] = []
        for i in range(2):
            p, opt, met, _ = step(p, opt, ds.batch(i))
            hist[dev].append((float(met["loss"]), float(met["grad_norm"])))
    np.testing.assert_allclose(np.array(hist["cuda"]), np.array(hist["cpu"]),
                               rtol=1e-4, atol=1e-4)
    assert toks["cuda"] == toks["cpu"]


def _moe_cfg(arch):
    """The MoE smoke config at widths the kernels take: d 256, hd 128 at
    the arch's published rep (arctic 7 query heads on one KV head, kimi
    8), every MoE field of the published config but the experts' width
    (64)."""
    from repro_torch.configs import get_config

    H = {"arctic-480b": 7, "kimi-k2-1t-a32b": 8}[arch]
    return dataclasses.replace(
        get_smoke(arch), d_model=256, n_heads=H, n_kv_heads=1, head_dim=128,
        d_ff=512, moe=dataclasses.replace(get_config(arch).moe,
                                          d_ff_expert=64))


@pytest.mark.parametrize("arch", ["arctic-480b", "kimi-k2-1t-a32b"])
def test_moe_models_cuda_equal_cpu(arch):
    """The MoE models, f32, with the published routing: two train steps
    (loss, grad norm and the aux metrics within 1e-4) and the lockstep
    and continuous engines' greedy tokens, equal on the card and on the
    CPU."""
    _need_cuda()
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import Schedule
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.train.trainer import TrainConfig, make_train_step
    from repro_torch.tree import tree_flatten_with_path

    cfg = _moe_cfg(arch)
    tcfg = TrainConfig(optimizer=adamw.AdamWConfig(lr=3e-3),
                       schedule=Schedule(warmup_steps=1, total_steps=2))
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(2))
    for path, leaf in tree_flatten_with_path(params)[0]:
        if path[-1] in ("w_out", "wo"):    # tokens that use every block
            leaf.mul_(6.0)
    ds = SyntheticLM(cfg, DataConfig(128, 2, seed=2))
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 40))
    lay = layout_for_pattern(salo_pattern(cfg), 8)
    ccfg = ContinuousConfig(n_pages=1 + 4 * lay.pages_per_req, page=8,
                            chunk=8, max_batch=4)
    hist, toks = {}, {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, dev)
        toks[dev] = ServeEngine(model, ServeConfig(max_len=48)).generate(
            _params_on(params, dev), prompts, 8).cpu().tolist()
        eng = ContinuousEngine(model, ccfg, device=dev)
        rids = [eng.submit(x, 8) for x in prompts]
        res = eng.run(_params_on(params, dev))
        toks[dev] += [res[r].tolist() for r in rids]
        p = _params_on(params, dev)
        step = make_train_step(model, tcfg)
        opt = adamw.init(tcfg.optimizer, p)
        hist[dev] = []
        for i in range(2):
            p, opt, met, _ = step(p, opt, ds.batch(i))
            hist[dev].append([float(met[k]) for k in (
                "loss", "grad_norm", "load_balance", "router_z",
                "dropped_frac")])
    np.testing.assert_allclose(np.array(hist["cuda"]), np.array(hist["cpu"]),
                               rtol=1e-4, atol=1e-4)
    assert toks["cuda"] == toks["cpu"]


# ------------ the last two families: qwen2-vl-2b, whisper-base ----------- #
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_training_kernels_match_plain_whisper_encoder(dtype):
    """K1, K2, K3 at whisper-base's encoder attention (chip_smoke case
    (m)): bidirectional window 512 with 4 global tokens and global rows,
    n 1500 (padded to 1536), hd 64, block 256, 8 flat heads; dK/dV
    bitwise over two calls, padded rows (0, NEG_INF, 0)."""
    _need_cuda()
    from repro_torch.kernels import salo_attention as KA
    from repro_torch.kernels import salo_backward as KB

    sched, plan, t, (q, k, v, dout, pq, pk) = _train_case(
        longformer(512, n_global=4), 1500, 8, 64, 256, 256, dtype, seed=15)
    assert plan.n_pad == 1536
    kw = dict(sched=sched, scale=64 ** -0.5)
    out, m, l = KA.salo_table_attention(q, k, v, pq, pk, t.kv_blocks,
                                        t.flags, **kw)
    ro, rm, rl = KA.salo_table_attention_plain(q, k, v, pq, pk, t.kv_blocks,
                                               t.flags, **kw)
    delta = (dout * ro.float()).sum(-1)
    bwd = (dout, delta, rm, rl, q, k, v, pq, pk)
    dq = KB.salo_table_backward_dq(*bwd, t.kv_blocks, t.flags, **kw)
    rdq = KB.salo_table_backward_dq_plain(*bwd, t.kv_blocks, t.flags, **kw)
    dkv_t = (t.row_tile, t.q_blocks, t.pk_flags)
    dk, dv = KB.salo_table_backward_dkv(*bwd, *dkv_t, **kw)
    dk2, dv2 = KB.salo_table_backward_dkv(*bwd, *dkv_t, **kw)
    rdk, rdv = KB.salo_table_backward_dkv_plain(*bwd, *dkv_t, **kw)
    torch.cuda.synchronize()
    tol, gtol, ktol = KA.OUT_TOL[dtype], GTOL[dtype], KB.DKV_TOL[dtype]
    stol = KA.STATS_TOL
    for a, b, tl in ((out, ro, tol), (m, rm, stol), (l, rl, stol),
                     (dq, rdq, gtol), (dk, rdk, ktol), (dv, rdv, ktol)):
        torch.testing.assert_close(a.float(), b.float(), atol=tl, rtol=tl)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    if dtype != torch.float32:
        assert KB.dq_off_share(dq, rdq) <= KB.DQ_OFF_SHARE
    pad = t.pos >= sched.n
    assert bool((m[:, pad] == -1e30).all() and (l[:, pad] == 0).all()
                and (out[:, pad] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,hd,window", [(12, 2, 128, 1024),
                                             (8, 8, 64, 512)])
def test_contiguous_decode_qwen2_vl_and_whisper_heads(dtype, H, Hkv, hd,
                                                      window):
    """K5 at qwen2-vl-2b's decode heads (12 on 2 KV heads of hd 128, rep
    6: row groups of 4 and 2) and whisper-base's (8 on 8 of hd 64, rep
    1), B 8, the lockstep phases' 288 slots (chip_smoke cases (m), (n)):
    within the plain version's tolerance, bitwise over repeated calls,
    scalar and per-request t."""
    _need_cuda()
    from repro_torch.kernels.salo_decode import salo_decode, salo_decode_plain

    g = torch.Generator(device="cuda").manual_seed(H + hd)
    B, S = 8, 288
    pat = causal_sliding_window(window, n_sinks=4)
    cache = torch.randn((2, B, S, Hkv, hd), generator=g,
                        device="cuda").to(dtype)
    k, v = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    q = torch.randn((B, H, 1, hd), generator=g, device="cuda").to(dtype)
    tv = torch.tensor([0, 3, 40, 100, 200, 255, 280, S - 1],
                      dtype=torch.int32, device="cuda")
    for t in (S - 1, tv):
        out = salo_decode(q, k, v, None, t, pattern=pat)
        ref = salo_decode_plain(q, k, v, None, t, pattern=pat)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                                   rtol=TOL[dtype])
        for _ in range(5):
            assert torch.equal(out, salo_decode(q, k, v, None, t,
                                                pattern=pat))


def _family_cfg(arch):
    """qwen2-vl narrowed to d 256 at its published hd 128, rep 6 and M-RoPE
    sections; whisper to d 128 at its hd 64, rep 1 and 1500 audio frames
    (chip_smoke's narrowed checks)."""
    from repro_torch.configs import get_config

    full = get_config(arch)
    if arch == "qwen2-vl-2b":
        return dataclasses.replace(
            get_smoke(arch), d_model=256, n_heads=6, n_kv_heads=1,
            head_dim=128, d_ff=512, mrope_sections=full.mrope_sections)
    return dataclasses.replace(get_smoke(arch), d_model=128, n_heads=2,
                               n_kv_heads=2, d_ff=256,
                               n_audio_frames=full.n_audio_frames)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "whisper-base"])
def test_family_models_cuda_equal_cpu(arch):
    """The VLM (vision extras, M-RoPE positions) and the encoder-decoder
    (the encoder's 1500 frames through K1-K3), f32: two train steps (loss
    and grad norm within 1e-4) and the lockstep engine's greedy tokens
    (whisper's cross caches filled from the encoder on each device),
    equal on the card and on the CPU."""
    _need_cuda()
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import Schedule
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.train.trainer import TrainConfig, make_train_step
    from repro_torch.tree import tree_flatten_with_path

    cfg = _family_cfg(arch)
    tcfg = TrainConfig(optimizer=adamw.AdamWConfig(lr=3e-3),
                       schedule=Schedule(warmup_steps=1, total_steps=2))
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(2))
    for path, leaf in tree_flatten_with_path(params)[0]:
        if path[-1] in ("w_out", "wo") and "xattn" not in path:
            leaf.mul_(6.0)                 # tokens that use every block
    ds = SyntheticLM(cfg, DataConfig(128, 2, seed=2))
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 40))
    audio = torch.randn((2, cfg.n_audio_frames, cfg.d_model),
                        generator=torch.Generator().manual_seed(3))
    hist, toks = {}, {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, dev)
        p = _params_on(params, dev)
        eng = ServeEngine(model, ServeConfig(max_len=48))
        if cfg.encoder_decoder:
            enc = model._encode(p, {"audio_embeds": audio.to(dev)})
            init_cache = model.init_cache

            def filled(B, L, enc=enc, p=p, init_cache=init_cache):
                c = init_cache(B, L)
                for i, layer in enumerate(p["seg0_xattn"]):
                    for w, key in (("wk", "xk"), ("wv", "xv")):
                        c["seg0_xattn"][key][i].copy_(
                            (enc @ layer["xattn"][w]).reshape(
                                B, cfg.n_audio_frames, cfg.n_kv_heads,
                                cfg.hd))
                return c
            model.init_cache = filled
        with torch.no_grad():
            toks[dev] = eng.generate(p, prompts, 8).cpu().tolist()
        step = make_train_step(model, tcfg)
        opt = adamw.init(tcfg.optimizer, p)
        hist[dev] = []
        for i in range(2):
            p, opt, met, _ = step(p, opt, ds.batch(i))
            hist[dev].append((float(met["loss"]), float(met["grad_norm"])))
    np.testing.assert_allclose(np.array(hist["cuda"]), np.array(hist["cpu"]),
                               rtol=1e-4, atol=1e-4)
    assert toks["cuda"] == toks["cpu"]


# ------------------------- sequence-parallel serving ----------------------- #
def test_paged_decode_state_per_shard_and_merge():
    """K4 with return_state on each shard's own slab (the serve shapes at 2
    shards: 8 rows, 9/3 heads of hd 64, bf16, 33 pages of 16 a shard): the
    live rows against the plain version (OUT_TOL / STATS_TOL), the rows
    the shard holds no slot of give exactly (0, NEG_INF, 0), and the two
    shards' partials merged (StackedGroup) equal unsharded K4 within
    OUT_TOL."""
    _need_cuda()
    from repro_torch.dist.group import StackedGroup
    from repro_torch.dist.sharded_plan import masked_psum_merge
    from repro_torch.kernels.salo_attention import OUT_TOL, STATS_TOL

    S, page, B, H, Hkv, hd = 2, 16, 8, 9, 3, 64
    g = torch.Generator(device="cuda").manual_seed(5)
    pat = causal_sliding_window(1024, n_sinks=4)
    lay = layout_for_pattern(pat, page, shards=S)
    npp, pps = lay.pages_per_req, lay.pages_per_shard
    n_pages = 1 + B * npp
    k = torch.randn((n_pages, page, Hkv, hd), generator=g,
                    device="cuda").bfloat16()
    v = torch.randn((n_pages, page, Hkv, hd), generator=g,
                    device="cuda").bfloat16()
    q = torch.randn((B, H, 1, hd), generator=g, device="cuda").bfloat16()
    pt = (torch.randperm(n_pages - 1, generator=g, device="cuda") + 1)
    pt = pt.reshape(B, npp).to(torch.int32)
    ts = [5, 300, 700, 1027, 1028, 1500, 2047, 3000]
    pos = torch.from_numpy(np.stack([
        ring_view_positions(t + 1, lay.n_sink, lay.ring_cap, lay.n_global)
        for t in ts]).astype(np.int32)).cuda()
    t = torch.tensor(ts, dtype=torch.int32, device="cuda")
    parts = []
    for r in range(S):
        idx = pt[:, r * pps:(r + 1) * pps].reshape(-1).long()
        kr, vr = torch.cat([k[:1], k[idx]]), torch.cat([v[:1], v[idx]])
        ptr = torch.arange(1, 1 + B * pps, dtype=torch.int32,
                           device="cuda").reshape(B, pps)
        posr = pos[:, r * pps * page:(r + 1) * pps * page].contiguous()
        res = salo_paged_decode(q, kr, vr, ptr, posr, t, pattern=pat,
                                return_state=True)
        ref = salo_paged_decode_plain(q, kr, vr, ptr, posr, t, pattern=pat,
                                      return_state=True)
        live = causal_step_mask(pat, t[:, None], posr,
                                STEP_WINDOW | STEP_GLOBAL).any(dim=1)
        assert int((~live).sum()) == (2 if r == 1 else 0)
        for a, b, tol in zip(res, ref, (OUT_TOL[torch.bfloat16], STATS_TOL,
                                        STATS_TOL)):
            torch.testing.assert_close(a[live], b[live], atol=tol, rtol=tol)
            assert torch.equal(a[~live], b[~live])      # (0, NEG_INF, 0)
        parts.append(res)
    merged = masked_psum_merge(*(torch.stack([p[i] for p in parts])
                                 for i in range(3)), StackedGroup(S))[0]
    whole = salo_paged_decode(q, k, v, pt, pos, t, pattern=pat)
    tol = OUT_TOL[torch.bfloat16]
    torch.testing.assert_close(merged.bfloat16().float(), whole.float(),
                               atol=tol, rtol=tol)


def _sharded_rank_tokens(group, cfg, params, prompts, n_new, extra):
    lay = layout_for_pattern(salo_pattern(cfg), 8, shards=group.size)
    eng = ContinuousEngine(
        build_model(cfg, str(group.device)),
        ContinuousConfig(n_pages=1 + 4 * lay.pages_per_shard, page=8,
                         chunk=8, max_batch=4, seq_shards=group.size,
                         **extra),
        device=str(group.device), group=group)
    rids = [eng.submit(p, n_new) for p in prompts]
    res = eng.run(_params_on(params, str(group.device)))
    return [res[r].tolist() for r in rids], dict(eng.counters)


@pytest.mark.parametrize("extra", [
    {}, dict(kv_dtype="int8", page_sparsity_threshold=-3.0,
             page_stat_decay=0.3)])
def test_sharded_engine_gloo_on_one_card_equals_unsharded(extra):
    """2 gloo ranks sharing cuda:0 (K4 in return_state mode on each, the
    merge over gloo's all_reduce of CUDA tensors), a narrowed f32 model
    with window 24 (4 pages a request: no shard padding): greedy tokens
    and every counter equal to the unsharded engine's on the card."""
    _need_cuda()
    from repro_torch.dist.group import run_ranks

    cfg = dataclasses.replace(get_smoke("smollm-135m"), d_model=192,
                              n_heads=3, n_kv_heads=1, d_ff=256,
                              salo=SALOConfig(window=24, n_global=2))
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(4))
    for layer in params["seg0_attn_mlp"]:
        layer["attn"]["wo"].mul_(6.0)
        layer["mlp"]["w_out"].mul_(6.0)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (5, 9, 13, 26)]
    lay = layout_for_pattern(salo_pattern(cfg), 8)
    eng = ContinuousEngine(build_model(cfg, "cuda"), ContinuousConfig(
        n_pages=1 + 4 * lay.pages_per_req, page=8, chunk=8, max_batch=4,
        **extra), device="cuda")
    rids = [eng.submit(p, 16) for p in prompts]
    res = eng.run(_params_on(params, "cuda"))
    want = ([res[r].tolist() for r in rids], dict(eng.counters))
    out = run_ranks(_sharded_rank_tokens, 2, backend="gloo", device="cuda:0",
                    timeout_s=120.0, args=(cfg, params, prompts, 16, extra))
    for got in out:
        assert got == want


# ------------------------- sequence-parallel training -------------------- #
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pname,n,S,r", [("lf", 1024, 2, 0), ("lf", 1024, 4, 2),
                                        ("csw", 1024, 2, 1)])
def test_training_kernels_on_view_tables_match_plain(dtype, pname, n, S, r):
    """K1, K2 and K3 on one shard's view tables (q on its local blocks,
    K/V on its [local | halo | global] view, 64-blocks, hd 64): against
    their plain versions within the train-kernels tolerances, dK/dV
    bitwise over two calls. Bidirectional (halos on both sides, a global
    row) and causal with sinks."""
    _need_cuda()
    from repro_torch.core.scheduler import schedule
    from repro_torch.dist.sharded_plan import shard_plan, shard_tables
    from repro_torch.kernels import salo_attention as KA
    from repro_torch.kernels import salo_backward as KB

    pat = (longformer(256, n_global=2) if pname == "lf"
           else causal_sliding_window(200, n_sinks=4))
    sched = schedule(pat, n)
    sp = shard_plan(sched.plan(64, 64, S * 64), S)
    assert sum(sp.halo_counts) > 0 and sp.n_gt == 1
    t = shard_tables(sp, torch.device("cuda"))
    pq, pk, kvb, flg = t.pos_q[r], t.pos_k[r], t.tables[r], t.flags[r]
    dkv_t = (t.row_tile[r], t.q_blocks[r], t.pk_flags[r])
    g = torch.Generator(device="cuda").manual_seed(r)
    BH, D = 6, 64
    q = torch.randn((BH, sp.nq_l * 64, D), generator=g, device="cuda")
    k, v = (torch.randn((BH, sp.view_tiles * 64, D), generator=g,
                        device="cuda") for _ in range(2))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    dout = torch.randn(q.shape, generator=g, device="cuda")
    kw = dict(sched=sched, scale=D ** -0.5)
    out, m, l = KA.salo_table_attention(q, k, v, pq, pk, kvb, flg, **kw)
    ro, rm, rl = KA.salo_table_attention_plain(q, k, v, pq, pk, kvb, flg,
                                               **kw)
    tol = KA.OUT_TOL[dtype]
    torch.testing.assert_close(out.float(), ro.float(), atol=tol, rtol=tol)
    for a, b in ((m, rm), (l, rl)):
        torch.testing.assert_close(a, b, atol=KA.STATS_TOL,
                                   rtol=KA.STATS_TOL)
    delta = (dout * ro.float()).sum(-1)
    bwd = (dout, delta, rm, rl, q, k, v, pq, pk)
    dq = KB.salo_table_backward_dq(*bwd, kvb, flg, **kw)
    rdq = KB.salo_table_backward_dq_plain(*bwd, kvb, flg, **kw)
    gtol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(dq.float(), rdq, atol=gtol, rtol=gtol)
    if dtype != torch.float32:
        assert KB.dq_off_share(dq, rdq) <= KB.DQ_OFF_SHARE
    dk, dv = KB.salo_table_backward_dkv(*bwd, *dkv_t, **kw)
    dk2, dv2 = KB.salo_table_backward_dkv(*bwd, *dkv_t, **kw)
    rdk, rdv = KB.salo_table_backward_dkv_plain(*bwd, *dkv_t, **kw)
    ktol = KB.DKV_TOL[dtype]
    torch.testing.assert_close(dk, rdk, atol=ktol, rtol=ktol)
    torch.testing.assert_close(dv, rdv, atol=ktol, rtol=ktol)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_training_kernels_on_recurrentgemma_shard_view_match_plain(dtype):
    """Case (t-k): shard 1 of 2 of recurrentgemma-9b's train attention
    (window 2048 + 4 sinks over n 4096, so the window spans the whole
    previous shard; 128-blocks; 16 query heads on one KV head, expanded;
    hd 256, the column split): K1, K2 and K3 on the view tables against
    their plain versions within the train-kernels tolerances, dK/dV
    bitwise over two calls."""
    _need_cuda()
    from repro_torch.core.scheduler import schedule
    from repro_torch.dist.sharded_plan import shard_plan, shard_tables
    from repro_torch.kernels import salo_attention as KA
    from repro_torch.kernels import salo_backward as KB

    sched = schedule(causal_sliding_window(2048, n_sinks=4), 4096)
    sp = shard_plan(sched.plan(128, 128, 2 * 128), 2)
    assert (sp.nkb_l, sp.halo_counts, sp.n_gt) == (16, (15, 1), 1)
    t = shard_tables(sp, torch.device("cuda"))
    pq, pk, kvb, flg = t.pos_q[1], t.pos_k[1], t.tables[1], t.flags[1]
    dkv_t = (t.row_tile[1], t.q_blocks[1], t.pk_flags[1])
    g = torch.Generator(device="cuda").manual_seed(7)
    D = 256
    q = torch.randn((16, sp.nq_l * 128, D), generator=g, device="cuda")
    kv1 = [torch.randn((1, sp.view_tiles * 128, D), generator=g,
                       device="cuda") for _ in range(2)]
    q = q.to(dtype)
    k, v = (x.to(dtype).expand(16, -1, -1).contiguous() for x in kv1)
    dout = torch.randn(q.shape, generator=g, device="cuda")
    kw = dict(sched=sched, scale=D ** -0.5)
    out, m, l = KA.salo_table_attention(q, k, v, pq, pk, kvb, flg, **kw)
    ro, rm, rl = KA.salo_table_attention_plain(q, k, v, pq, pk, kvb, flg,
                                               **kw)
    tol = KA.OUT_TOL[dtype]
    torch.testing.assert_close(out.float(), ro.float(), atol=tol, rtol=tol)
    for a, b in ((m, rm), (l, rl)):
        torch.testing.assert_close(a, b, atol=KA.STATS_TOL,
                                   rtol=KA.STATS_TOL)
    delta = (dout * ro.float()).sum(-1)
    bwd = (dout, delta, rm, rl, q, k, v, pq, pk)
    dq = KB.salo_table_backward_dq(*bwd, kvb, flg, **kw)
    rdq = KB.salo_table_backward_dq_plain(*bwd, kvb, flg, **kw)
    gtol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(dq.float(), rdq, atol=gtol, rtol=gtol)
    if dtype != torch.float32:
        assert KB.dq_off_share(dq, rdq) <= KB.DQ_OFF_SHARE
    dk, dv = KB.salo_table_backward_dkv(*bwd, *dkv_t, **kw)
    dk2, dv2 = KB.salo_table_backward_dkv(*bwd, *dkv_t, **kw)
    rdk, rdv = KB.salo_table_backward_dkv_plain(*bwd, *dkv_t, **kw)
    ktol = KB.DKV_TOL[dtype]
    torch.testing.assert_close(dk, rdk, atol=ktol, rtol=ktol)
    torch.testing.assert_close(dv, rdv, atol=ktol, rtol=ktol)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def _sharded_op_rank(group, pname, n, dtype, seed):
    """One rank of the gloo sharded-attention test: its slice through
    sharded_attention, fwd and the three gradients, and the K1-K3 launch
    counts of that call."""
    from repro_torch.dist.sharded_plan import sharded_attention
    from repro_torch.kernels import salo_attention as KA
    from repro_torch.kernels import salo_backward as KB

    pat = (longformer(256, n_global=2) if pname == "lf"
           else causal_sliding_window(200, n_sinks=4))
    g = torch.Generator(device=group.device).manual_seed(seed)
    full = [torch.randn((6, n, 64), generator=g, device=group.device)
            .to(dtype) for _ in range(4)]
    m = n // group.size
    sl = slice(group.index * m, (group.index + 1) * m)
    q, k, v = (x[:, sl].contiguous().requires_grad_() for x in full[:3])
    before = (KA.salo_table_attention.launches,
              KB.salo_table_backward_dq.launches,
              KB.salo_table_backward_dkv.launches,
              KA.salo_table_attention_plain.calls)
    out = sharded_attention(q, k, v, pat, group, block_q=64, block_k=64)
    grads = torch.autograd.grad(out, (q, k, v), full[3][:, sl].contiguous())
    after = (KA.salo_table_attention.launches,
             KB.salo_table_backward_dq.launches,
             KB.salo_table_backward_dkv.launches,
             KA.salo_table_attention_plain.calls)
    return ([x.detach().float().cpu() for x in (out, *grads)],
            [a - b for a, b in zip(after, before)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pname", ["lf", "csw"])
def test_sharded_attention_gloo_on_one_card_matches_unsharded(dtype, pname):
    """2 gloo ranks sharing cuda:0 (the halo ppermute staged through host
    tensors, gloo's send/recv taking host memory only): each rank's slice
    of sharded_attention's output and gradients equals unsharded
    salo_attention's on the whole sequence (f32 1e-4; bf16 the train
    phases' OUT_TOL / 2e-2), with 1 K1, 1 K2 and 1 K3 call (2 kernels) a
    rank and no plain call."""
    _need_cuda()
    from repro_torch.dist.group import run_ranks
    from repro_torch.kernels import salo_attention as KA
    from repro_torch.kernels.ops import salo_attention

    n, seed = 1024, 5
    pat = (longformer(256, n_global=2) if pname == "lf"
           else causal_sliding_window(200, n_sinks=4))
    g = torch.Generator(device="cuda").manual_seed(seed)
    full = [torch.randn((6, n, 64), generator=g, device="cuda").to(dtype)
            for _ in range(4)]
    q, k, v = (x.detach().requires_grad_() for x in full[:3])
    ref = salo_attention(q, k, v, pat, 64, 64)
    want = [ref] + list(torch.autograd.grad(ref, (q, k, v), full[3]))
    res = run_ranks(_sharded_op_rank, 2, backend="gloo", device="cuda:0",
                    timeout_s=120.0, args=(pname, n, dtype, seed))
    otol = KA.OUT_TOL[dtype]
    gtol = 1e-4 if dtype == torch.float32 else 2e-2
    for r, (got, launches) in enumerate(res):
        assert launches == [1, 1, 2, 0], launches
        sl = slice(r * n // 2, (r + 1) * n // 2)
        for i, (a, b) in enumerate(zip(got, want)):
            tl = otol if i == 0 else gtol
            torch.testing.assert_close(a, b[:, sl].float().cpu(), atol=tl,
                                       rtol=tl)


def test_gloo_ppermute_on_one_card():
    """What tools/gloo_p2p_probe.py found, held: gloo's send/recv take host
    memory only (a CUDA tensor's pointer fails with "writev: Bad
    address"), so SeqGroup.ppermute on a gloo group on the card stages
    through host tensors; 2 ranks on cuda:0 swap f32 and bf16 buffers and
    get the peer's values back on the card."""
    _need_cuda()
    from repro_torch.dist.group import run_ranks

    res = run_ranks(_ppermute_rank, 2, backend="gloo", device="cuda:0",
                    timeout_s=120.0)
    for r in res:
        assert r["host_p2p"] is True
        assert r["torch.float32"] == (True, "cuda:0")
        assert r["torch.bfloat16"] == (True, "cuda:0")


def _ppermute_rank(group):
    out = {"host_p2p": group.host_p2p}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.full((3, 5), float(group.index + 1), dtype=dt,
                       device=group.device)
        y = group.ppermute(x, [(0, 1), (1, 0)])
        out[str(dt)] = (bool((y == 2 - group.index).all()), str(y.device))
    return out


# --------------- expert-parallel MoE training (model group) ------------- #
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_training_kernels_match_plain_arctic_rank_heads(dtype):
    """K1, K2, K3 at one model rank's heads of arctic-480b's train
    attention at 2 ranks (chip_smoke case (ep)): batch 1 x 28 of its 56
    query heads (on 4 of its 8 KV heads, expanded), n 4096, hd 128,
    window 1024 + 4 sinks, block 256; dK/dV bitwise over two calls."""
    _need_cuda()
    from repro_torch.kernels import salo_attention as KA
    from repro_torch.kernels import salo_backward as KB

    sched, plan, t, (q, k, v, dout, pq, pk) = _train_case(
        causal_sliding_window(1024, n_sinks=4), 4096, 28, 128, 256, 256,
        dtype, seed=27)
    kw = dict(sched=sched, scale=128 ** -0.5)
    out, m, l = KA.salo_table_attention(q, k, v, pq, pk, t.kv_blocks,
                                        t.flags, **kw)
    ro, rm, rl = KA.salo_table_attention_plain(q, k, v, pq, pk, t.kv_blocks,
                                               t.flags, **kw)
    delta = (dout * ro.float()).sum(-1)
    bwd = (dout, delta, rm, rl, q, k, v, pq, pk)
    dq = KB.salo_table_backward_dq(*bwd, t.kv_blocks, t.flags, **kw)
    rdq = KB.salo_table_backward_dq_plain(*bwd, t.kv_blocks, t.flags, **kw)
    dkv_t = (t.row_tile, t.q_blocks, t.pk_flags)
    dk, dv = KB.salo_table_backward_dkv(*bwd, *dkv_t, **kw)
    dk2, dv2 = KB.salo_table_backward_dkv(*bwd, *dkv_t, **kw)
    rdk, rdv = KB.salo_table_backward_dkv_plain(*bwd, *dkv_t, **kw)
    torch.cuda.synchronize()
    tol, gtol, ktol = KA.OUT_TOL[dtype], GTOL[dtype], KB.DKV_TOL[dtype]
    stol = KA.STATS_TOL
    for a, b, tl in ((out, ro, tol), (m, rm, stol), (l, rl, stol),
                     (dq, rdq, gtol), (dk, rdk, ktol), (dv, rdv, ktol)):
        torch.testing.assert_close(a.float(), b.float(), atol=tl, rtol=tl)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    if dtype != torch.float32:
        assert KB.dq_off_share(dq, rdq) <= KB.DQ_OFF_SHARE


def _moe_ep_rank(mesh, arch, params, x, cot):
    """One model rank's ``moe_apply(model=)`` on cuda:0 from its slices of
    the whole MoE parameters: y and the gathered gradients (CPU)."""
    from repro_torch.dist.group import Mesh2D
    from repro_torch.dist.sharding import mesh_placements
    from repro_torch.models import moe as M
    from repro_torch.train.trainer import gather_params, shard_params
    from repro_torch.tree import tree_leaves, tree_map

    mg, dev = mesh.model, mesh.model.device
    cfg = get_smoke(arch)
    whole = tree_map(lambda t: t.to(dev), params)
    pl = mesh_placements(whole, cfg, model=mg.size,
                         prefix=("seg", "0", "moe"))
    leaves = tree_map(lambda t: t.detach().requires_grad_(),
                      shard_params(whole, pl, Mesh2D(None, mg)))
    xx = x.to(dev).requires_grad_()
    y, aux = M.moe_apply(leaves, xx, cfg, model=mg)
    loss = (y * cot.to(dev)).sum() + aux["load_balance"] + aux["router_z"]
    g = torch.autograd.grad(loss, tree_leaves(leaves) + [xx])
    it = iter(g[:-1])
    gp = gather_params(tree_map(lambda _: next(it), leaves), pl,
                       Mesh2D(None, mg))
    return (y.detach().cpu(), float(aux["dropped_frac"]),
            [t.cpu() for t in tree_leaves(gp)], g[-1].cpu())


@pytest.mark.parametrize("arch", ["arctic-480b", "kimi-k2-1t-a32b"])
def test_moe_apply_model_group_gloo_on_one_card_matches_cpu(arch):
    """2 gloo ranks sharing cuda:0, each with half the experts and its
    router columns: y (bitwise equal on both ranks), the dropped share and
    the gathered gradients equal the port's single-device ``moe_apply`` on
    the CPU within 1e-4 (f32; TF32 off)."""
    _need_cuda()
    from repro_torch.dist.group import run_ranks
    from repro_torch.models import moe as M
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_smoke(arch)
    params = M.moe_init(torch.Generator().manual_seed(4), cfg, "cpu")
    rng = np.random.default_rng(4)
    x, cot = (torch.from_numpy(rng.normal(size=(4, 128, cfg.d_model))
                               .astype(np.float32)) for _ in range(2))
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    xx = x.clone().requires_grad_()
    y, aux = M.moe_apply(leaves, xx, cfg)
    loss = (y * cot).sum() + aux["load_balance"] + aux["router_z"]
    want = torch.autograd.grad(loss, tree_leaves(leaves) + [xx])
    res = run_ranks(_moe_ep_rank, 2, backend="gloo", device="cuda:0",
                    timeout_s=120.0, model=2, args=(arch, params, x, cot))
    for got_y, dropped, got_gp, got_gx in res:
        torch.testing.assert_close(got_y, y.detach(), atol=1e-4, rtol=1e-4)
        assert torch.equal(got_y, res[0][0])
        assert dropped == float(aux["dropped_frac"])
        for a, b in zip(got_gp + [got_gx], want):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


# ------------------- the FSDP fallback (data group) --------------------- #
def _gather_weight_rank(group, whole, cots):
    """One rank of the FSDP gather test: ``DataGroup.gather_weight`` of its
    f32 slice of ``whole`` along each dim, and of a bf16 slice; returns
    the gathered weights and the f32 gradients of ``sum(w * c_r)`` that
    reach ``grad_to``."""
    from repro_torch.dist.group import DataGroup

    data = DataGroup.of(group)
    w_all, cot = whole.to(data.device), cots[data.index].to(data.device)
    out = []
    for dim, dt in ((0, torch.float32), (1, torch.float32),
                    (1, torch.bfloat16)):
        shard = data.shard(w_all, dim).to(dt)
        slot = torch.zeros((), device=data.device,
                           requires_grad=True).expand(shard.shape)
        w = data.gather_weight(shard, dim, slot)
        (g,) = torch.autograd.grad((w * cot.to(dt)).sum(), (slot,))
        out += [w.detach().cpu(), g.cpu()]
    return out


def test_fsdp_gather_weight_gloo_on_one_card_matches_cpu():
    """2 gloo ranks sharing cuda:0 (gloo's all_gather and reduce_scatter
    take CUDA tensors: tools/gloo_reduce_scatter_probe.py) give what 2
    gloo CPU ranks give, bit for bit: the whole weight forward, and the
    slice of the f32 sum of the ranks' gradients backward (f32 for the
    bf16 slice too)."""
    _need_cuda()
    from repro_torch.dist.group import run_ranks

    rng = np.random.default_rng(8)
    whole = torch.from_numpy(rng.normal(size=(64, 96)).astype(np.float32))
    cots = [torch.from_numpy(rng.normal(size=(64, 96)).astype(np.float32))
            for _ in range(2)]
    want = run_ranks(_gather_weight_rank, 2, backend="gloo", device="cpu",
                     timeout_s=120.0, args=(whole, cots))
    got = run_ranks(_gather_weight_rank, 2, backend="gloo", device="cuda:0",
                    timeout_s=120.0, args=(whole, cots))
    for a, b in zip(got, want):
        assert a[-1].dtype == torch.float32
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)


# --------------- tensor-parallel RG-LRU (model group) ------------------ #
def _rglru_tp_rank(mesh, params, x, cot):
    """One model rank's ``rglru_apply(model=)`` from its slices of the
    whole RG-LRU parameters, on its group's device: the output and the
    gathered gradients (the whole leaves' shares summed, as the trainer
    sums them), on the CPU."""
    from repro_torch.dist.group import Mesh2D
    from repro_torch.dist.sharding import mesh_placements
    from repro_torch.models import rglru as RG
    from repro_torch.train.trainer import (gather_params, shard_params,
                                           sum_model_shares_)
    from repro_torch.tree import tree_leaves, tree_map

    mg, dev = mesh.model, mesh.model.device
    on = Mesh2D(None, mg)
    cfg = get_smoke("recurrentgemma-9b")
    whole = tree_map(lambda t: t.to(dev), params)
    pl = mesh_placements(whole, cfg, model=mg.size,
                         prefix=("seg0_rec_mlp", "0", "rec"))
    leaves = tree_map(lambda t: t.detach().requires_grad_(),
                      shard_params(whole, pl, on))
    xx = x.to(dev).requires_grad_()
    y = RG.rglru_apply(leaves, xx, cfg, mg)
    g = torch.autograd.grad((y * cot.to(dev)).sum(),
                            tree_leaves(leaves) + [xx])
    it = iter(g[:-1])
    gp = sum_model_shares_(tree_map(lambda _: next(it), leaves), pl, mg)
    return (y.detach().cpu(),
            [t.cpu() for t in tree_leaves(gather_params(gp, pl, on))],
            g[-1].cpu())


def test_rglru_model_group_gloo_on_one_card_matches_cpu():
    """2 gloo ranks sharing cuda:0, each with half of d_rnn (its gates'
    f32 input gathered, the gradient reduce-scattered; the whole gate and
    conv leaves' shares summed): the output (bitwise equal on both ranks)
    and the gathered gradients equal the port's single-device
    ``rglru_apply`` on the CPU within 1e-4 (f32; TF32 off)."""
    _need_cuda()
    from repro_torch.dist.group import run_ranks
    from repro_torch.models import rglru as RG
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_smoke("recurrentgemma-9b")
    params = RG.rglru_init(torch.Generator().manual_seed(5), cfg, "cpu")
    rng = np.random.default_rng(5)
    x, cot = (torch.from_numpy(rng.normal(size=(2, 64, cfg.d_model))
                               .astype(np.float32)) for _ in range(2))
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    xx = x.clone().requires_grad_()
    y = RG.rglru_apply(leaves, xx, cfg)
    want = torch.autograd.grad((y * cot).sum(), tree_leaves(leaves) + [xx])
    res = run_ranks(_rglru_tp_rank, 2, backend="gloo", device="cuda:0",
                    timeout_s=120.0, model=2, args=(params, x, cot))
    for got_y, got_gp, got_gx in res:
        torch.testing.assert_close(got_y, y.detach(), atol=1e-4, rtol=1e-4)
        assert torch.equal(got_y, res[0][0])
        for a, b in zip(got_gp + [got_gx], want):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_smem_exports_match_the_mirror():
    """Every instantiation's shared memory, as its ``.cu`` file exports it
    (the decode kernels' and the owner sum's static bytes as compiled),
    equals ``analysis.smem_budget``'s mirror, and the card's opt-in limit
    is the one the budget holds the launches to."""
    _need_cuda()
    from repro_torch.analysis import smem_budget as S

    props = torch.cuda.get_device_properties(0)
    optin = getattr(props, "shared_memory_per_block_optin", S.OPTIN_LIMIT)
    assert optin >= S.OPTIN_LIMIT
    for x in S.instantiations():
        assert S.exported(x) == x.total, x.name()
