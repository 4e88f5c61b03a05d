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
                                               (128, 12, 2, 16, 3)])
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
                                        (256, 8, 2, 513)])
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
            p, opt, met = step(p, opt, ds.batch(i))
            hist[dev].append((float(met["loss"]), float(met["grad_norm"])))
    np.testing.assert_allclose(np.array(hist["cuda"]), np.array(hist["cpu"]),
                               rtol=1e-4, atol=1e-4)
