"""Port parity for the MoE family: the MoE FFN (``models/moe.py``) and the
arctic-480b and kimi-k2-1t-a32b models at their ``SMOKE`` shapes, against
the JAX reference on the CPU.

Inputs are f32, made from a seed (the JAX init, handed to the port as numpy
through ``params_from_jax``; tokens and activations from numpy). The
reference's MoE runs no Pallas kernel; attention runs as in
``tests/test_torch_archs.py``. Tolerances: ``moe_apply`` outputs 1e-5
(abs and rel), its aux terms 1e-6 (rel; ``dropped_frac`` exact), logits
1e-5, loss with the aux losses 1e-6 (rel), every gradient 1e-4 (the
reference's own gradient bar). Routing must be exactly the reference's:
the same experts, the same slots, the same dropped entries.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as j_config
from repro.configs import get_smoke as j_smoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.ft import checkpoint as j_ck
from repro.models import moe as JMOE
from repro.models.model import build_model as j_build
from repro.optim import adamw as j_adamw
from repro_torch import configs as TC
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_smoke as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.ft import checkpoint as t_ck
from repro_torch.models import moe as TMOE
from repro_torch.models.model import build_model as t_build
from repro_torch.optim import adamw as t_adamw
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("arctic-480b", "kimi-k2-1t-a32b")
SEQ, BATCH = 64, 2


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_model(arch, seed=0):
    jmodel = j_build(j_smoke(arch))
    return jmodel, jmodel.init(jax.random.PRNGKey(seed))


def _models(arch, seed=0):
    """(JAX config, port config, (JAX model, params), (port model, params
    converted from the JAX ones, fresh tensors every call))."""
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    jmodel, jparams = _jax_model(arch, seed)
    tparams = params_from_jax(_np(jparams), "cpu")
    return jcfg, tcfg, (jmodel, jparams), (t_build(tcfg, "cpu"), tparams)


def _moe_params(arch):
    """The last layer's MoE parameters of the smoke model, as (JAX,
    port)."""
    jcfg, tcfg, (jm, jp), (_, tp) = _models(arch)
    key = f"seg{len(jm.program) - 1}_{jm.program[-1][0]}"
    return (jcfg, tcfg, jax.tree.map(lambda a: a[-1], jp[key]["moe"]),
            tp[key][-1]["moe"])


# ============================== configs ================================ #
def test_registry_lists_the_moe_archs():
    assert set(ARCHS) <= set(TC.ARCHS)
    a, k = t_config("arctic-480b"), t_config("kimi-k2-1t-a32b")
    assert (a.n_layers, a.d_model, a.n_heads, a.n_kv_heads, a.hd,
            a.moe.n_experts, a.moe.top_k, a.moe.d_ff_expert,
            a.moe.dense_residual) == (35, 7168, 56, 8, 128, 128, 2, 4864,
                                      True)
    assert (k.n_layers, k.d_model, k.n_heads, k.n_kv_heads, k.hd,
            k.vocab_size, k.moe.n_experts, k.moe.top_k, k.moe.d_ff_expert,
            k.moe.n_shared_experts, k.moe.first_k_dense) == (
        61, 7168, 64, 8, 128, 163840, 384, 8, 2048, 1, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_programs_equal_reference(arch):
    """CONFIG and SMOKE equal the reference's field for field, the
    programs are the reference's, and the port's init holds as many
    parameters as the reference's."""
    for jget, tget in ((j_config, t_config), (j_smoke, t_smoke)):
        assert dataclasses.asdict(tget(arch)) == \
            dataclasses.asdict(jget(arch))
        assert t_build(tget(arch), "cpu").program == \
            j_build(jget(arch)).program
    n_j = sum(x.size for x in jax.tree.leaves(_jax_model(arch)[1]))
    tp = t_build(t_smoke(arch), "cpu").init(torch.Generator().manual_seed(0))
    assert sum(x.numel() for x in tree_leaves(tp)) == n_j


def test_expert_stacks_are_drawn_in_the_param_dtype():
    """The expert stacks come out in the param dtype with the router in
    f32, each expert a draw of its own."""
    cfg = dataclasses.replace(t_smoke("kimi-k2-1t-a32b"),
                              param_dtype="bfloat16")
    p = TMOE.moe_init(torch.Generator().manual_seed(0), cfg, "cpu")
    assert p["router"].dtype == torch.float32
    for name in ("w_in", "w_gate", "w_out"):
        assert p[name].dtype == torch.bfloat16
        assert p[name].shape[0] == cfg.moe.n_experts
        assert not torch.equal(p[name][0], p[name][1])
    assert p["shared"]["w_in"].shape == (cfg.d_model, cfg.moe.d_ff_expert)


# ============================ the MoE FFN ============================== #
def _skew(jp, tp, x, expert=0, gain=0.1, shift=0.5):
    """Inputs shifted by ``shift`` in every channel and the router column
    of ``expert`` raised by ``gain``: most tokens pick ``expert`` first,
    so its slots overflow and entries drop."""
    r = np.asarray(jp["router"]).copy()
    r[:, expert] += gain
    return (dict(jp, router=jnp.asarray(r)), dict(tp, router=_t(r)),
            x + np.float32(shift))


# (B, S, groups env, skew): capacity binds (16 groups of 32 tokens); T =
# 18, which 16 groups do not divide (halved to 2); REPRO_MOE_GROUPS=1 (one
# global group)
SETTINGS = {"capacity_binds": (4, 128, None, True),
            "groups_halved": (2, 9, None, False),
            "one_group": (2, 32, "1", False)}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_moe_apply_matches_jax(arch, setting, monkeypatch):
    B, S, groups, skew = SETTINGS[setting]
    if groups is not None:
        monkeypatch.setenv("REPRO_MOE_GROUPS", groups)
    jcfg, tcfg, jp, tp = _moe_params(arch)
    x = np.random.default_rng(1).normal(size=(B, S, jcfg.d_model)).astype(
        np.float32)
    if skew:
        jp, tp, x = _skew(jp, tp, x)
    jy, jaux = JMOE.moe_apply(jp, jnp.asarray(x), jcfg)
    ty, taux = TMOE.moe_apply(tp, _t(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert sorted(taux) == sorted(jaux) == ["dropped_frac", "load_balance",
                                            "router_z"]
    assert float(taux["dropped_frac"]) == float(jaux["dropped_frac"])
    for key in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   rtol=1e-6)
    T = B * S
    G = TMOE.n_groups(tcfg, T)
    assert G == {"capacity_binds": 16, "groups_halved": 2,
                 "one_group": 1}[setting]
    if skew:        # the skewed expert's slots overflow in every group
        assert float(taux["dropped_frac"]) > 0.1


def test_capacity_truncates_then_rounds_up():
    """C = int(Tg·k/E·cf) rounded up to a multiple of 8, at least 8."""
    cfg = t_smoke("arctic-480b")           # E 4, k 2, cf 1.25
    assert [TMOE.capacity(cfg, tg) for tg in (1, 8, 12, 13, 16, 64)] == [
        8, 8, 8, 8, 16, 40]


def test_top_k_breaks_ties_like_jax():
    """Exact ties keep the lower index first, as ``jax.lax.top_k``."""
    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = TMOE.top_k(_t(probs), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ============================ whole models ============================= #
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(arch):
    """Logits within 1e-5, the loss (NLL + load balance + router z) within
    1e-6, every aux metric as the reference's, and the gradient of every
    parameter (router and expert stacks included) within 1e-4."""
    jcfg, tcfg, (jm, jp), (tm, tp) = _models(arch)
    batch = JSyntheticLM(jcfg, JDataConfig(SEQ, BATCH, seed=0)).batch(0)
    jlogits = np.asarray(jax.jit(jm.forward)(jp, batch))
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jp, batch)
    tbatch = {k: _t(v) for k, v in batch.items()}
    for leaf in tree_leaves(tp):
        leaf.requires_grad_()
    tlogits = tm.forward(tp, tbatch)
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits, **TOL)
    tloss, tmet = tm.loss(tp, tbatch)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-6)
    assert sorted(tmet) == sorted(jmet)
    for key in jmet:
        np.testing.assert_allclose(float(tmet[key].detach()),
                                   float(jmet[key]), rtol=1e-6, err_msg=key)
    tloss.backward()
    want = tree_leaves(params_from_jax(_np(jgrads), "cpu"))
    got = [x.grad for x in tree_leaves(tp)]
    assert len(got) == len(want) > 20
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL)


class _CountMM(TorchDispatchMode):
    """Counts the unbatched products (``aten.mm``) dispatched inside."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_equal(arch):
    """remat none, full and dots give equal losses, aux metrics and
    gradients; the backward's ``aten.mm`` count under dots equals none's
    (the router's, the shared expert's and every projection's products
    are saved) and is below full's, as ``tests/test_torch_remat.py``."""
    jcfg, _, (_, jp), _ = _models(arch)
    batch = JSyntheticLM(jcfg, JDataConfig(SEQ, BATCH, seed=1)).batch(0)
    runs = {}
    for remat in ("none", "full", "dots"):
        tm = t_build(dataclasses.replace(t_smoke(arch), remat=remat), "cpu")
        tp = params_from_jax(_np(jp), "cpu")
        leaves = tree_leaves(tp)
        for leaf in leaves:
            leaf.requires_grad_()
        loss, met = tm.loss(tp, {k: _t(v) for k, v in batch.items()})
        mode = _CountMM()
        with mode:
            grads = torch.autograd.grad(loss, leaves)
        runs[remat] = (float(loss.detach()),
                       {k: float(v.detach()) for k, v in met.items()},
                       grads, mode.mm)
    for remat in ("full", "dots"):
        np.testing.assert_allclose(runs[remat][0], runs["none"][0],
                                   rtol=1e-6)
        assert runs[remat][1].keys() == runs["none"][1].keys()
        for key, v in runs["none"][1].items():
            np.testing.assert_allclose(runs[remat][1][key], v, rtol=1e-6)
        for a, b in zip(runs[remat][2], runs["none"][2]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-7)
    mm = {r: runs[r][3] for r in runs}
    assert mm["dots"] == mm["none"] < mm["full"], mm


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_raises_on_an_unconsumed_moe_leaf(arch):
    jcfg, _, (jm, jp), _ = _models(arch)
    key = f"seg{len(jm.program) - 1}_{jm.program[-1][0]}"
    tree = _np(jp)
    tree[key]["moe"]["extra"] = tree[key]["moe"]["router"]
    with pytest.raises(ValueError, match=f"{key}/moe"):
        params_from_jax(tree, "cpu")
    if jcfg.moe.n_shared_experts:
        tree = _np(jp)
        tree[key]["moe"]["shared"]["bias"] = tree[key]["moe"]["router"]
        with pytest.raises(ValueError, match=f"{key}/moe/shared"):
            params_from_jax(tree, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_checkpoint_keys_equal_reference(arch, tmp_path):
    """{"params", "opt"} of the smoke model (expert stacks, router, shared
    expert): the port's checkpoint keys equal
    ``repro.ft.checkpoint._flatten``'s of the same tree, and a checkpoint
    crosses between the packages both ways bit-equal."""
    _, _, _, (_, tp) = _models(arch)
    jparams = tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    jtree = {"params": jparams,
             "opt": j_adamw.init(j_adamw.AdamWConfig(), jparams)}
    ttree = {"params": tp, "opt": t_adamw.init(t_adamw.AdamWConfig(), tp)}
    jflat, _ = j_ck._flatten(jtree)
    tflat = t_ck._flatten(ttree)
    assert sorted(tflat) == sorted(jflat)
    seg = [k for k in tp if k.startswith("seg")][-1]
    assert {f"params::{seg}::0::moe::router",
            f"opt::.m::{seg}::1::moe::w_in"} <= set(tflat)
    for k in jflat:
        np.testing.assert_array_equal(tflat[k], jflat[k])
    j_ck.save(str(tmp_path / "j"), jtree, 3)
    got = t_ck.restore(tmp_path / "j", ttree)
    for a, b in zip(tree_leaves(got["params"]), tree_leaves(tp)):
        assert torch.equal(a, b)
    t_ck.save(tmp_path / "t", ttree, 3)
    back = j_ck.restore(str(tmp_path / "t"), jtree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
