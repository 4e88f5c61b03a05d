"""Port parity for serving and the command lines of the MoE family
(arctic-480b, kimi-k2-1t-a32b) at their ``SMOKE`` shapes, against the JAX
reference on the CPU: the lockstep ``decode_step``, both engines' greedy
tokens, and the train and serve CLIs with ``--smoke --device cpu``.

Inputs are f32 and made from a seed (the JAX init, handed to the port as
numpy through ``params_from_jax``). Every residual branch's output
projection is amplified, so greedy tokens depend on the blocks (at the
plain init the embedding dominates). Tolerances: ``decode_step`` logits
1e-5 (abs and rel), greedy tokens and engine counters exact. Both engines
feed the MoE the reference's token count: a decode step all its rows,
inactive ones included, a prefill chunk its padded length.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_smoke
from repro.models.layers import salo_pattern as j_pattern
from repro.models.model import build_model as j_build
from repro.serve.engine import ContinuousConfig as JConfig
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.models.model import build_model as t_build
from repro_torch.serve.engine import ContinuousConfig as TConfig
from repro_torch.serve.engine import ContinuousEngine as TEngine
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.paged_cache import layout_for_pattern

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("arctic-480b", "kimi-k2-1t-a32b")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _amplify(params, gain=6.0):
    """Scale every residual branch's output projection (``wo``, the dense
    MLP's and the experts' ``w_out``; the shared expert's too)."""
    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return tree * gain if name in ("wo", "w_out") else tree
    return {k: walk(v) if k.startswith("seg") else v
            for k, v in params.items()}


def _models(arch, seed=0):
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    jmodel = j_build(jcfg)
    jparams = _amplify(jmodel.init(jax.random.PRNGKey(seed)))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, (jmodel, jparams), (t_build(tcfg, "cpu"), tparams)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_logits_match_jax(arch):
    """16 lockstep decode steps (past the smoke window of 16 at the last
    one): logits within 1e-5 at every step."""
    jcfg, tcfg, (jm, jp), (tm, tp) = _models(arch)
    B, n = 2, 16
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, n))
    jc, tc = jm.init_cache(B, n), tm.init_cache(B, n)
    step = jax.jit(jm.decode_step)
    for t in range(n):
        jl, jc = step(jp, jc, {"tokens": jnp.asarray(toks[:, t:t + 1])}, t)
        tl, tc = tm.decode_step(tp, tc, {"tokens": _t(toks[:, t:t + 1])}, t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"step {t}", **TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("groups,chunk", [(None, 8), ("1", 32)])
def test_continuous_engine_greedy_tokens_identical(arch, groups, chunk,
                                                   monkeypatch):
    """Ragged prompts past the window on the continuous engine (4 rows,
    page 8): greedy tokens and counters identical to the JAX engine's,
    with chunk 8 and the configs' 16 dispatch groups, and with chunk 32
    under ``REPRO_MOE_GROUPS=1``, where a prefill chunk's 32 padded rows
    route as one group and its padding competes for the capacity."""
    if groups is not None:
        monkeypatch.setenv("REPRO_MOE_GROUPS", groups)
    jcfg, tcfg, (jm, jp), (tm, tp) = _models(arch)
    page, R = 8, 4
    lay = layout_for_pattern(j_pattern(jcfg, causal=True), page)
    kw = dict(n_pages=1 + R * lay.pages_per_req, page=page, chunk=chunk,
              max_batch=R)
    jeng = JEngine(jm, JConfig(**kw))
    teng = TEngine(tm, TConfig(**kw), device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 9, 13, 26)]
    jr = [jeng.submit(p, 8) for p in prompts]
    tr = [teng.submit(p, 8) for p in prompts]
    jo, to = jeng.run(jp), teng.run(tp)
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(to[b], jo[a])
    assert len({int(x) for r in tr for x in to[r]}) > 4
    assert dict(jeng.counters) == dict(teng.counters)


@pytest.mark.parametrize("arch", ARCHS)
def test_lockstep_engine_greedy_tokens_identical(arch):
    """Batch 2, prompt 20 (past the window), 12 new tokens on the lockstep
    engines: identical greedy tokens."""
    jcfg, tcfg, (jm, jp), (tm, tp) = _models(arch)
    prompts = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 20))
    want = JServeEngine(jm, JServeConfig(max_len=32)).generate(
        jp, jnp.asarray(prompts), 12)
    got = ServeEngine(tm, ServeConfig(max_len=32)).generate(tp, prompts, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ================================ CLIs ================================= #
@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_loss_falls_and_logs_aux(arch, capsys):
    from repro_torch.launch.train import main

    final = main(["--arch", arch, "--smoke", "--device", "cpu",
                  "--steps", "20", "--seq", "64", "--batch", "4", "--lr",
                  "5e-3", "--data-branch", "2", "--data-docs", "4"])
    out = capsys.readouterr().out
    first = float(out.split("step     0 loss")[1].split()[0])
    assert final < first - 0.5, out
    assert " lb " in out and " z " in out and " dropped " in out, out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("engine", ["continuous", "lockstep"])
def test_serve_cli(arch, engine, capsys):
    from repro_torch.launch.serve import main

    res = main(["--arch", arch, "--smoke", "--device", "cpu", "--engine",
                engine, "--batch", "2", "--prompt-len", "20",
                "--new-tokens", "6"])
    if engine == "lockstep":
        assert res.shape == (2, 6)
    else:
        assert sorted(len(v) for v in res.values()) == [6, 6]
    assert f"engine={engine}" in capsys.readouterr().out
