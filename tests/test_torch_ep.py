"""Expert-parallel MoE training of the port (the MoE family under the
reference's "model" mesh axis) against the JAX package, on gloo CPU
ranks, f32, at ``arctic_480b.SMOKE`` and ``kimi_k2_1t_a32b.SMOKE``.

* Placements: ``dist.sharding.mesh_placements`` (model dims) against the reference's
  rules for every leaf of both archs' full configs at 2 and 4 model ranks.
  The expert stacks split on their expert dim in the port (the 3-D
  ``(E, d, f)`` leaf, labelled ``('experts', 'embed', 'ffn')``) and on
  ffn in the reference (its 4-D ``(L, E, d, f)`` stack, labelled ``(None,
  None, 'embed', 'ffn')``); this test asserts both labellings. The router
  splits on its expert columns, arctic's dense residual MLP and kimi's
  shared expert on ffn (the dense MLP's documented difference where the
  reference's layer count divides the ranks).
* ``moe_apply(model=)`` at 2 and 4 ranks against the reference's
  ``moe_apply`` on one device (``jax.grad`` of ``sum(y · cot)`` plus the
  two aux losses): ``y`` within 1e-5 and bitwise equal across the ranks,
  each aux term within 1e-6 (``dropped_frac`` exact), and the gathered
  gradients of the router, the expert stacks, the shared expert and the
  input within 1e-4, where capacity binds (entries dropped) and where 16
  groups do not divide T.
* 3 train steps at model 2, at data 2 x model 2 and at model 4 against
  the port's single-device steps from the same converted reference
  parameters: losses and gathered parameters within 1e-4, grad norms
  within 1e-5,
  the step-0 loss the reference's within 1e-6; the leaves a rank holds
  whole and the optimizer step bitwise equal across the ranks.
* An expert count the group does not divide (the reference's
  ``_mesh_clean`` drops the experts axis): narrowed configs whose expert
  stacks split over ffn (``arctic-480b:e3``, 3 experts, at 2 and 4 ranks)
  or stay whole (``kimi-k2-1t-a32b:e6``, 6 experts of width 30, at 4
  ranks) take ``moe_apply``'s parity above and 3 train steps against one
  rank's (the ffn split also on the int8 wire); their placements are the
  reference's rule applied leaf by leaf.
* A checkpoint saved at model 2 restores onto one rank and onto 4.
* The CLI at ``--model 2`` on arctic.

The spawned ranks import this module, so it imports JAX only inside the
functions that run it. Every spawn has a deadline of 120 s.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.dist.group import Mesh2D, ModelGroup, run_ranks
from test_torch_tp import _port_tree, _reference_dims

DEADLINE_S = 120.0
ARCHS = ("arctic-480b", "kimi-k2-1t-a32b")
SEQ, BATCH, STEPS = 64, 4, 3
# (B, S, skew): capacity binds (16 groups of 32 tokens, one expert raised
# in the router, so its slots overflow); T = 18, which 16 groups do not
# divide (halved to 2)
SETTINGS = {"capacity_binds": (4, 128, True), "groups_halved": (2, 9, False)}
# narrowed configs whose expert count a group does not divide:
# name -> (n_experts, d_ff_expert). arctic:e3 splits its stacks over ffn
# at 2 and 4 ranks; kimi:e6 over experts at 2 and, at 4, keeps them (and
# its shared expert) whole
UNEVEN = {"arctic-480b:e3": (3, 128), "kimi-k2-1t-a32b:e6": (6, 30)}
MOE_CASES = [(a, s) for a in ARCHS for s in SETTINGS] + [
    (a, "capacity_binds") for a in UNEVEN]
# train case -> (arch, data ranks, model ranks)
EVEN_TRAIN = {**{f"{a}_{d}": (a, d, 2) for a in ARCHS for d in (1, 2)},
              **{f"{a}_model4": (a, 1, 4) for a in ARCHS}}
UNEVEN_TRAIN = {"arctic-480b:e3_1": ("arctic-480b:e3", 1, 2),
                "arctic-480b:e3_int8": ("arctic-480b:e3", 1, 2),
                "kimi-k2-1t-a32b:e6_model4": ("kimi-k2-1t-a32b:e6", 1, 4)}
TRAIN = {**EVEN_TRAIN, **UNEVEN_TRAIN}
# the train cases on the int8 wire (compress_grads)
INT8 = ("arctic-480b:e3_int8",)


def _smoke(arch, module="torch"):
    """The smoke config of ``arch``, or of a narrowed one of
    :data:`UNEVEN` (``<arch>:<variant>``)."""
    if module == "torch":
        from repro_torch.configs import get_smoke
    else:
        from repro.configs import get_smoke
    base, _, _ = arch.partition(":")
    cfg = get_smoke(base)
    if arch in UNEVEN:
        E, f = UNEVEN[arch]
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=E, d_ff_expert=f))
    return cfg


def _batch(cfg, i, module="torch"):
    if module == "torch":
        from repro_torch.data.pipeline import DataConfig, SyntheticLM
    else:
        from repro.data.pipeline import DataConfig, SyntheticLM
    return SyntheticLM(cfg, DataConfig(SEQ, BATCH, seed=0, branch=2,
                                       n_docs=4)).batch(i)


def _flat(tree):
    """{'/'-joined path: numpy copy} of every tensor leaf (the converted
    reference parameters and ``Model.init``'s tree order their keys
    differently)."""
    from repro_torch.tree import tree_flatten_with_path
    return {"/".join(p): x.detach().float().numpy().copy()
            for p, x in tree_flatten_with_path(tree)[0]}


# ------------------------------------------------------------------ #
# placements against the reference's rules
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_placements_split_the_experts(arch, n):
    from repro.configs import get_config as j_config
    from repro.dist.sharding import logical_axes_for as j_axes
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import logical_axes_for, mesh_placements
    from repro_torch.tree import tree_flatten_with_path, tree_map

    cfg = get_config(arch)
    ref = _reference_dims(j_config(arch), n)
    flat, _ = tree_flatten_with_path(tree_map(
        lambda s: s.model, mesh_placements(_port_tree(ref), cfg, model=n)))
    port = {}
    for path, dim in flat:
        port.setdefault("/".join(p for p in path if not p.isdigit()),
                        set()).add(dim)
    experts = 0
    for p, (shape, rdim) in ref.items():
        pdim = port.get(p, {None})
        assert len(pdim) == 1, (p, pdim)     # every layer alike
        pdim = next(iter(pdim))
        leaf = p.rsplit("/", 1)[-1]
        stacked = p.startswith("seg")
        if "/moe/" in p and "/shared/" not in p and leaf != "router":
            # the reference's 4-D stack is stored ffn-split; the port's
            # 3-D stack expert-split
            axes = ("embed", "ffn") if leaf != "w_out" else ("ffn", "embed")
            assert len(shape) == 4
            assert j_axes(p, 4) == (None, None) + axes
            assert logical_axes_for(p.split("/", 1)[1], 3) == (
                "experts",) + axes
            assert rdim == (3 if leaf != "w_out" else 2), (p, rdim)
            assert pdim == 0, (p, pdim)
            experts += 1
        elif stacked and leaf in ("w_in", "w_gate", "w_out") and rdim == 0:
            # a dense or shared MLP: the reference's stacked layer axis
            # where the layer count divides the ranks, the port's ffn
            assert shape[0] % n == 0, (p, shape)
            want = 1 if leaf != "w_out" else 0
            assert pdim == want, (p, pdim, want)
        else:
            assert pdim == (rdim if rdim is None or not stacked
                            else rdim - 1), (p, shape, rdim, pdim)
    assert experts == 3      # w_in, w_gate, w_out
    seg = [k for k in ref if "/moe/router" in k][0]
    assert port[seg] == {1} and ref[seg][1] == 2


def test_split_is_judged_on_each_leafs_own_width():
    """kimi's shared expert is d_ff_expert · n_shared wide and its expert
    stacks d_ff_expert: a width the group divides splits, one it does not
    stays whole, whatever ``d_ff`` is."""
    from repro_torch.dist.sharding import ffn_width, leaf_placement

    cfg = _smoke("kimi-k2-1t-a32b")
    cfg = dataclasses.replace(cfg, d_ff=96, moe=dataclasses.replace(
        cfg.moe, d_ff_expert=20, n_shared_experts=3))
    assert ffn_width(cfg, "seg1_attn_moe/0/moe/shared/w_in") == 60
    assert ffn_width(cfg, "seg1_attn_moe/0/moe/w_in") == 20
    assert ffn_width(cfg, "seg0_attn_mlp/0/mlp/w_in") == 96
    shared = [f"seg1_attn_moe/0/moe/shared/{w}" for w in ("w_in", "w_out")]
    # 5 divides the shared width 60, not d_ff 96
    assert [leaf_placement(p, 2, cfg, 5) for p in shared] == [1, 0]
    assert leaf_placement("seg0_attn_mlp/0/mlp/w_in", 2, cfg, 5) is None
    # 32 divides d_ff 96, not the shared width 60
    assert [leaf_placement(p, 2, cfg, 32) for p in shared] == [None, None]
    assert leaf_placement("seg0_attn_mlp/0/mlp/w_in", 2, cfg, 32) == 1
    # the stacks split on E (8), whatever their width (20)
    assert leaf_placement("seg1_attn_moe/0/moe/w_in", 3, cfg, 4) == 0
    assert leaf_placement("seg1_attn_moe/0/moe/router", 2, cfg, 4) == 1


# ------------------------------------------------------------------ #
# the reference
# ------------------------------------------------------------------ #
def _moe_inputs(arch, setting):
    """The reference's last MoE layer parameters of the smoke model (as
    numpy), the input and the cotangent of ``setting``."""
    import jax

    from repro.models.model import build_model

    jm = build_model(_smoke(arch, "jax"))
    jp = jm.init(jax.random.PRNGKey(0))
    key = f"seg{len(jm.program) - 1}_{jm.program[-1][0]}"
    p = jax.tree.map(lambda a: np.asarray(a[-1]), jp[key]["moe"])
    B, S, skew = SETTINGS[setting]
    rng = np.random.default_rng(1)
    d = jm.cfg.d_model
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    cot = rng.normal(size=(B, S, d)).astype(np.float32)
    if skew:
        p["router"] = p["router"].copy()
        p["router"][:, 0] += 0.1
        x = x + np.float32(0.5)
    return p, x, cot


@functools.lru_cache(maxsize=None)
def _jax_moe(arch, setting):
    """The reference's ``moe_apply`` on one device: (params, x, cot) and
    its y, aux terms and gradients of (params, x) as numpy."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe as JMOE

    p, x, cot = _moe_inputs(arch, setting)
    cfg = _smoke(arch, "jax")

    def f(pp, xx):
        y, aux = JMOE.moe_apply(pp, xx, cfg)
        return (jnp.sum(y * cot) + aux["load_balance"] + aux["router_z"],
                (y, aux))

    (_, (y, aux)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1),
                                                 has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    to_np = functools.partial(jax.tree.map, np.asarray)
    return (p, x, cot, np.asarray(y), {k: float(v) for k, v in aux.items()},
            to_np(gp), np.asarray(gx))


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    """The reference's smoke parameters (converted) and its step-0 loss."""
    import jax
    import jax.numpy as jnp

    from repro.models.model import build_model
    from repro_torch.convert import params_from_jax

    cfg = _smoke(arch, "jax")
    jm = build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    b = {k: jnp.asarray(v) for k, v in _batch(cfg, 0, "jax").items()}
    loss, _ = jax.jit(jm.loss)(jp, b)
    return params_from_jax(jax.tree.map(np.asarray, jp), "cpu"), float(loss)


# ------------------------------------------------------------------ #
# the ranks
# ------------------------------------------------------------------ #
def _moe_rank(mg, arch, p, x, cot):
    """``moe_apply(model=mg)`` on this rank's slices of the whole MoE
    parameters ``p``: y, the aux terms and the gathered gradients of the
    parameters and of x, as numpy."""
    from repro_torch.dist.sharding import mesh_placements
    from repro_torch.models import moe as M
    from repro_torch.train.trainer import gather_params, shard_params
    from repro_torch.tree import tree_leaves, tree_map

    cfg = _smoke(arch)
    whole = tree_map(torch.from_numpy, p)
    pl = mesh_placements(whole, cfg, model=mg.size,
                         prefix=("seg", "0", "moe"))
    leaves = tree_map(lambda t: t.detach().requires_grad_(),
                      shard_params(whole, pl, Mesh2D(None, mg)))
    xx = torch.from_numpy(x).requires_grad_()
    y, aux = M.moe_apply(leaves, xx, cfg, model=mg)
    loss = (y * torch.from_numpy(cot)).sum() + aux["load_balance"] \
        + aux["router_z"]
    g = torch.autograd.grad(loss, tree_leaves(leaves) + [xx])
    it = iter(g[:-1])
    gp = gather_params(tree_map(lambda _: next(it), leaves), pl,
                       Mesh2D(None, mg))
    return (y.detach().numpy(), {k: float(v) for k, v in aux.items()},
            tree_map(lambda t: t.numpy(), gp), g[-1].numpy())


def _train(arch, params, mesh, ckpt=None, compress=False):
    """3 train steps of ``arch``'s smoke from ``params`` (whole leaves, cut
    here for the mesh's model group; ``mesh`` None: one device), on the
    int8 wire with ``compress``. Returns the losses, the grad norms, the
    final parameters (gathered) and the bytes of every leaf a rank holds
    whole and of the optimizer's step. ``ckpt``: a directory the final
    state is saved to (the model group gathers it, its rank 0 writes)."""
    from repro_torch.dist.sharding import mesh_placements
    from repro_torch.ft import checkpoint as ck
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import Schedule
    from repro_torch.train.trainer import (TrainConfig, gather_params,
                                           make_train_step, shard_params,
                                           state_shardings)
    from repro_torch.tree import tree_leaves

    cfg = _smoke(arch)
    tc = TrainConfig(optimizer=adamw.AdamWConfig(lr=1e-2),
                     schedule=Schedule(warmup_steps=2, total_steps=STEPS),
                     compress_grads=compress)
    data = None if mesh is None else mesh.data
    mg = None if mesh is None else mesh.model
    p = params
    if mg is not None:
        pl = mesh_placements(params, cfg, model=mg.size)
        p = shard_params(params, pl, Mesh2D(None, mg))
    step = make_train_step(build_model(cfg, "cpu"), tc, data=data,
                           model_group=mg)
    o = adamw.init(tc.optimizer, p)
    losses, norms, ef = [], [], None
    for i in range(STEPS):
        p, o, met, ef = step(p, o, _batch(cfg, i), ef)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    whole = bytes([o.step])
    if mg is not None:
        for t in (p, o.m, o.v):
            whole += b"".join(x.numpy().tobytes() for x, d in zip(
                tree_leaves(t), tree_leaves(pl)) if d.whole)
        if ckpt is not None:
            ck.save(ckpt, {"params": p, "opt": o}, STEPS,
                    state_shardings(pl, o), mg)
        p = gather_params(p, pl, Mesh2D(None, mg))
    return dict(losses=losses, norms=norms, params=_flat(p), whole=whole)


def _restore_rank(mg, arch, ckpt):
    """Restore the checkpoint at ``ckpt`` onto this rank's slices (the
    rank's own ``init_shards`` tree as the structure) and gather it."""
    from repro_torch.dist.sharding import mesh_placements
    from repro_torch.ft import checkpoint as ck
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import (gather_params, init_shards,
                                           state_shardings)

    cfg = _smoke(arch)
    p = init_shards(build_model(cfg, "cpu"), torch.Generator().manual_seed(
        1), mg)
    pl = mesh_placements(p, cfg, model=mg.size)
    o = adamw.init(adamw.AdamWConfig(), p)
    got = ck.restore(ckpt, {"params": p, "opt": o}, STEPS,
                     state_shardings(pl, o), mg)
    mesh = Mesh2D(None, mg)
    return dict(params=_flat(gather_params(got["params"], pl, mesh)),
                m=_flat(gather_params(got["opt"].m, pl, mesh)),
                step=got["opt"].step,
                shapes=[x.shape for x in _flat(got["params"]).values()])


def _rank_body(mesh, moe_cases, train_cases, ckpt, restore):
    """Every check of one mesh: the ``moe_apply`` cases on the model
    group, the train runs of ``train_cases`` (the model-2 runs with no
    data group save their final state under ``ckpt`` per arch), and the
    restores of ``restore`` (arch -> checkpoint directory)."""
    mg = mesh.model
    out = {}
    for case, args in moe_cases.items():
        out[case] = _moe_rank(mg, case[0], *args)
    for case, params in train_cases.items():
        arch, d, _ = TRAIN[case]
        out[case] = _train(arch, params, mesh if d > 1 else
                           dataclasses.replace(mesh, data=None),
                           ckpt=None if d > 1 or ckpt is None
                           or arch not in ARCHS or case in INT8
                           or (mesh.data is not None and mesh.data.index)
                           else f"{ckpt}/{arch}", compress=case in INT8)
    for arch, path in restore.items():
        out[f"restore_{arch}"] = _restore_rank(mg, arch, path)
    return out


@functools.lru_cache(maxsize=None)
def _single(arch, compress=False):
    """The port's single-device run of :func:`_train`."""
    return _train(arch, _jax_model(arch)[0], None, compress=compress)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Two spawns run every case: 4 ranks as a 2 x 2 (data, model) mesh
    (the model-2 cases on each model group, repeating the work on both
    data rows, the data 2 x model 2 runs, and the model-2 checkpoints),
    then 4 ranks as one model group (the model-4 cases, the model-4 train
    runs and the restores of those checkpoints). Returns {model ranks:
    every rank's results} and the checkpoint directory."""
    ckpt = str(tmp_path_factory.mktemp("ep_ckpt"))
    moe = {c: _jax_moe(*c)[:3] for c in MOE_CASES}
    train = {m: {c: _jax_model(a)[0] for c, (a, _, mm) in TRAIN.items()
                 if mm == m} for m in (2, 4)}
    out = {2: run_ranks(_rank_body, 4, backend="gloo", device="cpu",
                        timeout_s=DEADLINE_S, model=2,
                        args=(moe, train[2], ckpt, {}))}
    out[4] = run_ranks(_rank_body, 4, backend="gloo", device="cpu",
                       timeout_s=DEADLINE_S, model=4,
                       args=(moe, train[4], None,
                             {a: f"{ckpt}/{a}" for a in ARCHS}))
    return out, ckpt


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch,setting", MOE_CASES)
def test_moe_apply_under_a_model_group_matches_jax(ranks, arch, setting,
                                                   n):
    """y within 1e-5 and bitwise equal on every rank; the aux terms the
    reference's; the gathered gradients of every MoE parameter (the
    router's among them: it is wrong if the gated outputs, not the
    expert rows, were summed over the group) and of x within 1e-4."""
    _, _, _, y, aux, gp, gx = _jax_moe(arch, setting)
    recs = [r[(arch, setting)] for r in ranks[0][n]]
    for got_y, got_aux, got_gp, got_gx in recs:
        np.testing.assert_allclose(got_y, y, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got_y, recs[0][0])
        assert got_aux["dropped_frac"] == aux["dropped_frac"]
        for key in ("load_balance", "router_z"):
            np.testing.assert_allclose(got_aux[key], aux[key], rtol=1e-6)
        assert sorted(got_gp) == sorted(gp)
        for name in gp:
            if name == "shared":
                for w in gp[name]:
                    np.testing.assert_allclose(got_gp[name][w], gp[name][w],
                                               rtol=1e-4, atol=1e-4)
            else:
                np.testing.assert_allclose(got_gp[name], gp[name],
                                           rtol=1e-4, atol=1e-4,
                                           err_msg=name)
        np.testing.assert_allclose(got_gx, gx, rtol=1e-4, atol=1e-4)
    if SETTINGS[setting][2] and arch in ARCHS:
        assert aux["dropped_frac"] > 0.1    # the skewed expert overflows


@pytest.mark.parametrize("case", list(EVEN_TRAIN))
def test_train_steps_match_the_single_device_steps(ranks, case):
    """3 steps at model 2, data 2 x model 2 and model 4 from the same
    parameters and batches as the port's single-device steps: losses and
    gathered parameters within 1e-4, grad norms within 1e-5, the step-0
    loss the reference's within 1e-6; every leaf a rank holds whole
    (parameters, moments) and the step bitwise equal across the ranks.
    The parameters' 1e-4 lies between what f32 rounding moves them by and
    what a wrong gradient does (``tools/ep_rounding.py``)."""
    arch, _, m = TRAIN[case]
    want = _single(arch, case in INT8)
    recs = [r[case] for r in ranks[0][m]]
    for rec in recs:
        np.testing.assert_allclose(rec["losses"], want["losses"], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(rec["losses"][0], _jax_model(arch)[1],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(rec["norms"], want["norms"], rtol=1e-5,
                                   atol=1e-5)
        assert rec["params"].keys() == want["params"].keys()
        for k, b in want["params"].items():
            np.testing.assert_allclose(rec["params"][k], b, rtol=1e-4,
                                       atol=1e-4, err_msg=k)
        assert rec["whole"] == recs[0]["whole"]
        assert rec["losses"] == recs[0]["losses"]
    assert want["losses"][-1] < want["losses"][0]


@pytest.mark.parametrize("case", list(UNEVEN_TRAIN))
def test_uneven_train_steps_match_the_single_device_steps(ranks, case):
    """3 steps with an expert count the group does not divide (stacks
    split over ffn at model 2, on both gradient wires; whole at model 4)
    from the same parameters and batches as the port's single-device
    steps: losses within 1e-4, grad norms within 1e-5, the step-0 loss
    the reference's within 1e-6; every leaf a rank holds whole
    (parameters, moments; at model 4 the MoE's every leaf) and the step
    bitwise equal across the ranks. The gathered parameters are held
    within 1e-3: the ffn split sums each expert row's two halves, so its
    gradients differ from one device's in the last bits, and AdamW
    turns that into moves of up to the learning rate (1e-2) on an
    element whose gradient is at the rounding floor (7.9e-4 on one of
    the 16384 embedding entries, every other entry of the tree within
    1e-6); on the int8 wire such a difference can flip a value by one
    int8 step (5.0e-4 on 5 expert entries). The gradients themselves
    are held to 1e-4 by the ``moe_apply`` cases."""
    arch, _, m = TRAIN[case]
    want = _single(arch, case in INT8)
    recs = [r[case] for r in ranks[0][m]]
    for rec in recs:
        np.testing.assert_allclose(rec["losses"], want["losses"], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(rec["losses"][0], _jax_model(arch)[1],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(rec["norms"], want["norms"], rtol=1e-5,
                                   atol=1e-5)
        assert rec["params"].keys() == want["params"].keys()
        for k, b in want["params"].items():
            np.testing.assert_allclose(rec["params"][k], b, rtol=1e-3,
                                       atol=1e-3, err_msg=k)
        assert rec["whole"] == recs[0]["whole"]
        assert rec["losses"] == recs[0]["losses"]
    assert want["losses"][-1] < want["losses"][0]


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_at_two_ranks_restores_onto_one_and_four(ranks, arch):
    """The model-2 run's checkpoint holds the whole leaves (the gathered
    final parameters, bit for bit); restored onto one rank it is them,
    and onto 4 ranks each rank holds a quarter of every expert stack and
    gathers them back bit for bit."""
    from repro_torch.ft import checkpoint as ck
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw

    out, ckpt = ranks
    saved = [r[f"{arch}_1"]["params"] for r in out[2]]
    cfg = _smoke(arch)
    p = build_model(cfg, "cpu").init(torch.Generator().manual_seed(1))
    got = ck.restore(f"{ckpt}/{arch}", {"params": p, "opt": adamw.init(
        adamw.AdamWConfig(), p)})
    one, m = _flat(got["params"]), _flat(got["opt"].m)
    assert got["opt"].step == STEPS
    assert one.keys() == saved[0].keys()
    for k, b in saved[0].items():
        np.testing.assert_array_equal(one[k], b, err_msg=k)
    E = cfg.moe.n_experts
    for rec in out[4]:
        r4 = rec[f"restore_{arch}"]
        assert r4["step"] == STEPS
        for got4, want4 in ((r4["params"], one), (r4["m"], m)):
            assert got4.keys() == want4.keys()
            for k, b in want4.items():
                np.testing.assert_array_equal(got4[k], b, err_msg=k)
        assert (E // 4, cfg.d_model, cfg.moe.d_ff_expert) in r4["shapes"]


# ------------------------------------------------------------------ #
# what runs, what raises
# ------------------------------------------------------------------ #
def _fake(n=2):
    """A model group for the checks that raise before any collective."""
    return ModelGroup(None, 0, n, torch.device("cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_an_expert_count_the_group_does_not_divide_runs_whole(arch):
    """An expert count the group does not divide no longer raises: at 3
    ranks (arctic) and 5 (kimi) the smoke configs split nothing (experts,
    expert width, heads, ffn and vocabulary all indivisible), so every
    rank runs the whole model alone, with no collective: the loss under
    the group is one device's, bit for bit, and the step factory takes
    the group."""
    from repro_torch.models import moe as M
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import (TrainConfig, make_train_step,
                                           train_placements)
    from repro_torch.tree import tree_leaves

    cfg = _smoke(arch)
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, 0).items()}
    model = build_model(cfg, "cpu")
    n = cfg.moe.n_experts // 2 + 1 if arch == "kimi-k2-1t-a32b" else 3
    assert cfg.moe.n_experts % n and M.expert_split(cfg, n) is None
    assert all(s.whole and not s.model_sum for s in tree_leaves(
        train_placements(model, _fake(n))))
    params = model.init(torch.Generator().manual_seed(0))
    one, _ = model.loss(params, batch)
    split, _ = model.loss(params, batch, model=_fake(n))
    assert torch.equal(one, split)
    make_train_step(model, TrainConfig(), model_group=_fake(n))


@pytest.mark.parametrize("arch,n,want", [
    ("arctic-480b", 2, "experts"), ("arctic-480b", 3, None),
    ("kimi-k2-1t-a32b", 5, None), ("kimi-k2-1t-a32b", 256, "ffn"),
    ("arctic-480b:e3", 2, "ffn"), ("kimi-k2-1t-a32b:e6", 4, None)])
def test_expert_placements_follow_mesh_clean(arch, n, want):
    """The expert stacks and the router of every MoE layer are placed as
    the reference's ``_mesh_clean`` places the port's per-layer leaves
    (``logical_axes_for`` of the 3-D stack and the 2-D router, resolved
    by the default rules on a (1, n) mesh): over experts where n divides
    E, else over ffn where n divides ``d_ff_expert`` (the router whole),
    else whole; ``moe.expert_split`` names the branch (full configs, and
    the narrowed ones of :data:`UNEVEN`)."""
    import types

    from repro.dist import sharding as J
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import leaf_placement
    from repro_torch.models import moe as M

    cfg = _smoke(arch) if ":" in arch else get_config(arch)
    assert M.expert_split(cfg, n) == want
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((1, n)))
    d, E, f = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert
    shapes = {"w_in": (E, d, f), "w_gate": (E, d, f), "w_out": (E, f, d),
              "router": (d, E)}
    key = "seg1_attn_moe" if cfg.moe.first_k_dense else \
        "seg0_attn_moe_dense"
    for leaf, shape in shapes.items():
        path = f"{key}/0/moe/{leaf}"
        spec = J._mesh_clean(mesh, J.resolve(*J.logical_axes_for(
            path, len(shape))), shape)
        ref = [i for i, e in enumerate(spec) if e and "model" in e]
        assert leaf_placement(path, len(shape), cfg, n) == (
            ref[0] if ref else None), (leaf, spec)
        if leaf != "router":
            assert (None if not ref else "experts" if ref[0] == 0
                    else "ffn") == want


def test_init_shards_draws_only_the_ranks_experts():
    """``Model.init(span=)`` draws the same stream as the whole model and
    keeps only experts lo..hi-1 of every stack; ``init_shards`` cuts
    everything else as ``shard_params`` of the whole draw would."""
    from repro_torch.dist.sharding import mesh_placements
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import init_shards, shard_params
    from repro_torch.tree import tree_leaves

    cfg = _smoke("kimi-k2-1t-a32b")
    model = build_model(cfg, "cpu")
    whole = model.init(torch.Generator().manual_seed(0))
    for n in (2, 4):
        pl = mesh_placements(whole, cfg, model=n)
        for r in range(n):
            mg = ModelGroup(None, r, n, torch.device("cpu"))
            got = init_shards(model, torch.Generator().manual_seed(0), mg)
            want = shard_params(whole, pl, Mesh2D(None, mg))
            a, b = tree_leaves(got), tree_leaves(want)
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert torch.equal(x, y)
            stack = got["seg1_attn_moe"][0]["moe"]["w_in"]
            assert stack.shape[0] == cfg.moe.n_experts // n


@pytest.mark.parametrize("arch", ["arctic-480b", "kimi-k2-1t-a32b"])
def test_moe_families_run_under_a_model_group(arch):
    """The MoE families take a model group of 2 in the step factory, with
    ``compress_grads`` too (their expert stacks' scale groups span the
    ranks: the absmax is maxed over the group), their experts split
    E / 2 a rank."""
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import TrainConfig, make_train_step

    cfg = _smoke(arch)
    kinds = [kind for kind, _ in T.make_program(cfg)]
    assert any(k in T.MOE_KINDS for k in kinds)
    assert M.expert_split(cfg, 2) == "experts"
    assert M.expert_span(cfg, _fake(2)) == (0, cfg.moe.n_experts // 2)
    make_train_step(build_model(cfg, "cpu"),
                    TrainConfig(compress_grads=True), model_group=_fake(2))


# ------------------------------------------------------------------ #
# the CLI
# ------------------------------------------------------------------ #
CLI = ["--arch", "arctic-480b", "--smoke", "--device", "cpu", "--seq",
       "32", "--batch", "4", "--lr", "5e-3", "--data-branch", "2",
       "--data-docs", "4", "--log-every", "1", "--steps", "8"]


def _losses(out):
    return {int(line.split()[1]): float(line.split()[3])
            for line in out.splitlines() if line.startswith("step ")}


def test_cli_expert_parallel_prints_the_single_rank_losses(capfd):
    """8 smoke steps of arctic at ``--model 2``: every printed loss is
    ``--model 1``'s within 1e-4, the expert stacks split on dim 0 in the
    placements line, and the aux metrics are logged."""
    from repro_torch.launch.train import main

    one = main(CLI)
    l1 = _losses(capfd.readouterr().out)
    two = main(CLI + ["--model", "2", "--dist-backend", "gloo"])
    out = capfd.readouterr().out
    l2 = _losses(out)
    assert "model=2 (gloo)" in out
    assert "moe/w_in: split dim 0" in out and "moe/router: split dim 1" \
        in out
    assert " lb " in out and " dropped " in out
    assert sorted(l1) == sorted(l2) == list(range(8))
    for i in l1:
        assert abs(l1[i] - l2[i]) <= 1e-4
    assert abs(one - two) <= 1e-4
