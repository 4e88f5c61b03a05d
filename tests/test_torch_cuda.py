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
from repro_torch.core.patterns import causal_sliding_window
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
