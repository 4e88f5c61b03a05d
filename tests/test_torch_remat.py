"""Port parity: ``remat="dots"`` (selective checkpointing that saves the
projections' products) against the JAX reference's
``dots_with_no_batch_dims_saveable`` policy, on the CPU, at the smollm
smoke config in f32 with reference parameters converted by
``params_from_jax``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke as j_smoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models.model import build_model as j_build
from repro_torch.configs import get_smoke as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.kernels import salo_attention as TKA
from repro_torch.kernels import salo_backward as TKB
from repro_torch.kernels.ops import LAUNCH_CONTRACT
from repro_torch.models.model import build_model as t_build
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)
SEQ, BATCH = 64, 4


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(j_smoke("smollm-135m"), remat="dots")
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    ds = JSyntheticLM(jcfg, JDataConfig(SEQ, BATCH, seed=0, branch=2,
                                        n_docs=4))
    return jcfg, jmodel, jparams, np_params, ds.batch(0)


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


class _CountMM(TorchDispatchMode):
    """Counts the unbatched products (``aten.mm``) dispatched inside."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


def _port_loss_grads(np_params, batch, remat, count=False):
    """The port's loss and parameter grads under ``remat``; with
    ``count``, also the backward's ``aten.mm`` count."""
    cfg = dataclasses.replace(t_smoke("smollm-135m"), remat=remat)
    params = params_from_jax(np_params, device="cpu")
    for leaf in tree_leaves(params):
        leaf.requires_grad_()
    loss, _ = t_build(cfg, "cpu").loss(params, _tbatch(batch))
    mode = _CountMM()
    if count:
        with mode:
            loss.backward()
    else:
        loss.backward()
    return (float(loss.detach()), [x.grad for x in tree_leaves(params)],
            mode.mm)


def test_dots_loss_and_grads_match_jax(setup):
    """Loss within 1e-6 and every parameter's gradient within 1e-4 of the
    reference's model under remat="dots"."""
    jcfg, jmodel, jparams, np_params, batch = setup
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(jparams, batch)
    loss, grads, _ = _port_loss_grads(np_params, batch, "dots")
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-6)
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jgrads),
                                       device="cpu"))
    assert len(grads) == len(want) > 10
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("other", ["full", "none"])
def test_dots_equals_full_and_none(setup, other):
    """The policy changes what is stored, not what is computed."""
    _, _, _, np_params, batch = setup
    loss_d, grads_d, _ = _port_loss_grads(np_params, batch, "dots")
    loss_o, grads_o, _ = _port_loss_grads(np_params, batch, other)
    np.testing.assert_allclose(loss_d, loss_o, rtol=1e-6)
    for a, b in zip(grads_d, grads_o):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_dots_backward_recomputes_no_projection(setup):
    """The backward's ``aten.mm`` count under dots equals no remat's (no
    projection is recomputed) and is below full remat's (which replays
    every projection of every layer)."""
    _, _, _, np_params, batch = setup
    n = {r: _port_loss_grads(np_params, batch, r, count=True)[2]
         for r in ("none", "full", "dots")}
    assert n["dots"] == n["none"] < n["full"], n


def test_dots_replays_the_attention_forward(setup):
    """The attention forward is launched outside the dispatcher, so under
    dots it replays in the backward as under full: a grad is three
    attention calls a layer besides the forward's one (1 forward replay +
    dQ + dK/dV, ``LAUNCH_CONTRACT``)."""
    jcfg, _, _, np_params, batch = setup
    fns = (TKA.salo_table_attention_plain, TKB.salo_table_backward_dq_plain,
           TKB.salo_table_backward_dkv_plain)
    before = [f.calls for f in fns]
    _port_loss_grads(np_params, batch, "dots")
    calls = [f.calls - b for f, b in zip(fns, before)]
    layers = jcfg.n_layers
    assert calls == [2 * layers, layers, layers], calls
    assert sum(calls) - layers == LAUNCH_CONTRACT["grad"] * layers


def test_train_cli_runs_with_dots(monkeypatch, capsys):
    """The train CLI (``--smoke --device cpu``) with a remat="dots"
    config: finite losses that fall."""
    from repro_torch.launch import train as T

    smoke = T.get_smoke
    monkeypatch.setattr(T, "get_smoke", lambda arch: dataclasses.replace(
        smoke(arch), remat="dots"))
    final = T.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                    "--steps", "12", "--seq", "64", "--batch", "4", "--lr",
                    "5e-3", "--data-branch", "2", "--data-docs", "4",
                    "--log-every", "1"])
    out = capsys.readouterr().out
    first = float(out.split("step     0 loss")[1].split()[0])
    assert np.isfinite(final) and final < first, out
