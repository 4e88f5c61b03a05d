"""Data-parallel training of the port against the JAX package, on gloo
CPU ranks, f32.

* Uncompressed, on 2 and 4 ranks: ``make_train_step(..., data=
  DataGroup)`` equals the reference's single-device ``make_train_step``
  on the global batch (what pjit's data-parallel step computes) for the
  smollm smoke with and without ``microbatches=2``, the qwen2-vl smoke
  (M-RoPE positions split on axis 1) and the arctic smoke (its dispatch
  groups split over the ranks, the aux losses' shares): 3 steps, losses
  within 1e-5, parameters within 1e-4, the state bitwise equal across the
  ranks.
* Compressed (``compress_grads``), on 2 and 4 ranks: equal to the
  reference's own functions composed as its ``shard_map`` region runs
  them — per-slice ``jax.value_and_grad(model.loss)``, ``jax.vmap(
  compressed_psum_with_residual, axis_name="data")`` / n, then
  ``adamw.update`` with the schedule: losses within 1e-5, parameters
  within 1e-4, each rank's ``ef_state`` its reference row within 1e-6.
* The reference's convergence bar (``test_distributed.py``'s compressed
  train step, whose 8-device mesh this JAX cannot build): 25 compressed
  steps against fp32 on 4 ranks. The single-device compressed step
  against ``test_substrates.py``'s setup.
* What raises; the CLI (``--data``, ``--compress-grads``, elastic resume
  of a 2-rank checkpoint on 1 and 4 ranks); ``reshard`` and
  ``restore(shardings=)``.

The spawned ranks import this module, so it imports JAX only inside the
functions that run it. Every spawn has a deadline of 120 s.
"""
import functools
import os

import numpy as np
import pytest
import torch

from repro_torch.dist.group import DataGroup, SeqGroup, run_ranks

DEADLINE_S = 120.0
SEQ, BATCH, STEPS = 64, 8, 3
# case -> (arch, microbatches)
CASES = {"smollm": ("smollm-135m", 1), "smollm_mb2": ("smollm-135m", 2),
         "qwen2vl": ("qwen2-vl-2b", 1), "arctic": ("arctic-480b", 1)}
CONVERGE_STEPS = 25


def _tcfg(module, mb=1, compress=False):
    kw = dict(warmup_steps=2, total_steps=STEPS)
    if module == "torch":
        from repro_torch.optim import adamw
        from repro_torch.optim.schedule import Schedule
        from repro_torch.train.trainer import TrainConfig
    else:
        from repro.optim import adamw
        from repro.optim.schedule import Schedule
        from repro.train.trainer import TrainConfig
    return TrainConfig(optimizer=adamw.AdamWConfig(lr=5e-3),
                       schedule=Schedule(**kw), microbatches=mb,
                       compress_grads=compress)


def _batch(arch, i, module="torch"):
    if module == "torch":
        from repro_torch.configs import get_smoke
        from repro_torch.data.pipeline import DataConfig, SyntheticLM
    else:
        from repro.configs import get_smoke
        from repro.data.pipeline import DataConfig, SyntheticLM
    return SyntheticLM(get_smoke(arch), DataConfig(
        SEQ, BATCH, seed=0, branch=2, n_docs=4)).batch(i)


def _flat(*trees):
    from repro_torch.tree import tree_leaves
    return torch.cat([x.detach().reshape(-1).float() for t in trees
                      for x in tree_leaves(t)]).numpy()


def _np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_init(arch):
    """The reference's smoke parameters, and the port's converted."""
    import jax

    from repro.configs import get_smoke
    from repro.models.model import build_model
    from repro_torch.convert import params_from_jax

    jmodel = build_model(get_smoke(arch))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jparams, params_from_jax(_np_tree(jparams), "cpu")


@functools.lru_cache(maxsize=None)
def _jax_global(case):
    """The reference's single-device step on the global batch, 3 steps:
    losses and the final parameters (the port's layout, flat)."""
    import jax
    import jax.numpy as jnp

    from repro.optim import adamw
    from repro.train.trainer import make_train_step
    from repro_torch.convert import params_from_jax

    arch, mb = CASES[case]
    jmodel, p, _ = _jax_init(arch)
    jt = _tcfg("jax", mb)
    step = jax.jit(make_train_step(jmodel, jt))
    o, losses = adamw.init(jt.optimizer, p), []
    for i in range(STEPS):
        p, o, met, _ = step(p, o, {k: jnp.asarray(v) for k, v in
                                   _batch(arch, i, "jax").items()})
        losses.append(float(met["loss"]))
    return losses, _flat(params_from_jax(_np_tree(p), "cpu"))


@functools.lru_cache(maxsize=None)
def _to_jax_order():
    """(the reference's smollm tree def and leaf shapes, and for each
    position of the port's flat parameter vector its position in the
    reference's)."""
    import jax

    from repro_torch.convert import params_from_jax
    from repro_torch.tree import tree_leaves

    _, jp, _ = _jax_init("smollm-135m")
    leaves, treedef = jax.tree.flatten(jp)
    off, idx = 0, []
    for x in leaves:
        idx.append(np.arange(off, off + x.size).reshape(x.shape))
        off += x.size
    perm = torch.cat([t.reshape(-1) for t in tree_leaves(params_from_jax(
        jax.tree.unflatten(treedef, idx), "cpu"))]).numpy()
    return treedef, [x.shape for x in leaves], perm


def _jax_tree(flat):
    """The reference's tree of a flat vector in the port's order."""
    import jax
    import jax.numpy as jnp

    treedef, shapes, perm = _to_jax_order()
    j = np.empty_like(flat)
    j[perm] = flat
    out, off = [], 0
    for shape in shapes:
        n = int(np.prod(shape))
        out.append(jnp.asarray(j[off: off + n].reshape(shape)))
        off += n
    return jax.tree.unflatten(treedef, out)


def _jax_compressed(n, wire_in):
    """The reference's compressed data-parallel step, composed from its
    own functions as its shard_map region runs them: per-slice
    ``jax.value_and_grad(model.loss)``, ``jax.vmap(
    compressed_psum_with_residual, axis_name="data")`` over g + ef, / n,
    AdamW with the schedule. The wire runs on the port's inputs
    (``wire_in[r][t]``: rank r's g + ef at step t), so that no value can
    round the other way; the reference's per-slice gradients are returned
    beside them. Returns (the mean losses, per step the slices' gradients
    and the wire's residual rows, the final parameters and residual rows;
    flat, in the port's order)."""
    import jax
    import jax.numpy as jnp

    from repro.dist import compression
    from repro.optim import adamw
    from repro_torch.convert import params_from_jax

    def port_flat(tree):
        return _flat(params_from_jax(_np_tree(tree), "cpu"))

    jmodel, p, _ = _jax_init("smollm-135m")
    jt = _tcfg("jax", compress=True)
    vg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))
    o = adamw.init(jt.optimizer, p)
    is_pair = lambda t: isinstance(t, tuple)  # noqa: E731
    losses, grads, resids = [], [], []
    rows = BATCH // n
    for t in range(STEPS):
        b = _batch("smollm-135m", t, "jax")
        outs = [vg(p, {k: jnp.asarray(v[r * rows:(r + 1) * rows])
                       for k, v in b.items()}) for r in range(n)]
        losses.append(float(np.mean([float(lr) for (lr, _), _ in outs])))
        grads.append([port_flat(g) for _, g in outs])
        x = jax.tree.map(lambda *xs: jnp.stack(xs),
                         *[_jax_tree(wire_in[r][t]) for r in range(n)])
        pairs = jax.vmap(lambda x: jax.tree.map(
            lambda a: compression.compressed_psum_with_residual(a, "data"),
            x), axis_name="data")(x)
        tot = jax.tree.map(lambda t: t[0][0] / n, pairs, is_leaf=is_pair)
        ef = jax.tree.map(lambda t: t[1], pairs, is_leaf=is_pair)
        resids.append([port_flat(jax.tree.map(lambda e: e[r], ef))
                       for r in range(n)])
        p, o, _ = adamw.update(jt.optimizer, o, p, tot,
                               jt.schedule(o.step))
    return losses, grads, resids, port_flat(p)


# ------------------------------------------------------------------ #
# the ranks
# ------------------------------------------------------------------ #
def _train(data, arch, params, steps, tcfg, batch_of=None):
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import make_train_step

    step = make_train_step(build_model(get_smoke(arch), "cpu"), tcfg,
                           data=data)
    p, o, ef, losses = params, adamw.init(tcfg.optimizer, params), None, []
    for i in range(steps):
        p, o, met, ef = step(p, o, (batch_of or _batch)(arch, i), ef)
        losses.append(float(met["loss"]))
    return p, o, ef, losses


def _rank_body(group, params):
    from repro_torch.dist import compression
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import TrainConfig

    data = DataGroup.of(group)
    out = {}
    for case, (arch, mb) in CASES.items():
        p, o, _, losses = _train(data, arch, params[arch], STEPS,
                                 _tcfg("torch", mb))
        out[case] = dict(losses=losses, params=_flat(p),
                         state=_flat(p, o.m, o.v).tobytes())
    wire_in, real = [], compression.compressed_psum_with_residual

    def spy(x, group, *rest):
        wire_in.append(_flat(x))
        return real(x, group, *rest)

    compression.compressed_psum_with_residual = spy
    p, o, ef, losses = _train(data, "smollm-135m", params["smollm-135m"],
                              STEPS, _tcfg("torch", compress=True))
    compression.compressed_psum_with_residual = real
    out["compressed"] = dict(losses=losses, params=_flat(p), ef=_flat(ef),
                             state=_flat(p, o.m, o.v).tobytes(),
                             wire_in=wire_in)
    if data.size == 4:
        # the reference's convergence bar: lr 1e-2, clip 1.0, the
        # default schedule, batches i % 4
        def cyc(arch, i):
            return _batch(arch, i % 4)
        for compress in (False, True):
            tc = TrainConfig(optimizer=adamw.AdamWConfig(lr=1e-2,
                                                         grad_clip=1.0),
                             compress_grads=compress)
            _, _, _, losses = _train(data, "smollm-135m",
                                     params["smollm-135m"], CONVERGE_STEPS,
                                     tc, cyc)
            out[f"converge_{compress}"] = losses
    return out


@pytest.fixture(scope="module")
def ranks():
    """One spawn per group size runs every case."""
    params = {arch: _jax_init(arch)[2] for arch, _ in CASES.values()}
    return {n: run_ranks(_rank_body, n, backend="gloo", device="cpu",
                         timeout_s=DEADLINE_S, args=(params,))
            for n in (2, 4)}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_data_parallel_step_equals_the_global_batch_step(ranks, case, n):
    losses, params = _jax_global(case)
    res = [r[case] for r in ranks[n]]
    for rec in res:
        np.testing.assert_allclose(rec["losses"], losses, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(rec["params"], params, rtol=1e-4,
                                   atol=1e-4)
        assert rec["state"] == res[0]["state"]
        assert rec["losses"] == res[0]["losses"]


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_step_equals_the_reference_composition(ranks, n):
    """Against the reference's functions composed as its shard_map region
    runs them (``_jax_compressed``): the losses within 1e-5; each rank's
    wire input g + ef, less its previous residual, its slice's gradient
    within 1e-5; the wire's residual (``ef_state``) equal to the rank's
    reference row within 1e-6; the parameters within 1e-4; the state
    bitwise equal across the ranks."""
    res = [r["compressed"] for r in ranks[n]]
    wire_in = [rec["wire_in"] for rec in res]
    losses, grads, resids, params = _jax_compressed(n, wire_in)
    for r, rec in enumerate(res):
        np.testing.assert_allclose(rec["losses"], losses, rtol=1e-5,
                                   atol=1e-5)
        for t in range(STEPS):
            g = wire_in[r][t] - (resids[t - 1][r] if t else 0.0)
            np.testing.assert_allclose(g, grads[t][r], rtol=1e-5,
                                       atol=1e-5)
        np.testing.assert_allclose(rec["ef"], resids[-1][r], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(rec["params"], params, rtol=1e-4,
                                   atol=1e-4)
        assert rec["state"] == res[0]["state"]
    # the residuals are each rank's own
    assert not np.array_equal(res[0]["ef"], res[1]["ef"])


def test_compressed_converges_beside_fp32(ranks):
    """The reference's bar: 25 steps on the int8 wire end 0.5 below the
    first loss and within 0.3 of the fp32 run's."""
    fp32 = ranks[4][0]["converge_False"]
    c = ranks[4][0]["converge_True"]
    assert abs(c[0] - fp32[0]) < 1e-5          # the loss is pre-reduce
    assert c[-1] < c[0] - 0.5, c[::6]
    assert abs(c[-1] - fp32[-1]) < 0.3, (c[-1], fp32[-1])
    for r in ranks[4][1:]:
        assert r["converge_True"] == c


def test_compress_grads_single_device_ef_threading():
    """``test_substrates.py``'s setup on the port: one device, the local
    quantize-dequantize with error feedback through the fixed 4-tuple;
    the first steps' losses equal the reference's within 1e-4."""
    import jax
    import jax.numpy as jnp

    from repro.optim import adamw as jadamw
    from repro.train.trainer import TrainConfig as JTrainConfig
    from repro.train.trainer import make_train_step as j_make
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import TrainConfig, make_train_step
    from repro_torch.tree import tree_leaves

    jmodel, jp, params = _jax_init("smollm-135m")
    jt = JTrainConfig(optimizer=jadamw.AdamWConfig(lr=1e-2, grad_clip=1.0),
                      compress_grads=True)
    tt = TrainConfig(optimizer=adamw.AdamWConfig(lr=1e-2, grad_clip=1.0),
                     compress_grads=True)
    jstep = jax.jit(j_make(jmodel, jt))
    step = make_train_step(build_model(get_smoke("smollm-135m"), "cpu"), tt)
    jo, o = jadamw.init(jt.optimizer, jp), adamw.init(tt.optimizer, params)
    jef = ef = None
    jl, losses = [], []
    for i in range(30):
        b = _batch("smollm-135m", i % 4)
        params, o, met, ef = step(params, o, b, ef)
        losses.append(float(met["loss"]))
        if i < 5:
            jp, jo, jm, jef = jstep(jp, jo, {k: jnp.asarray(v)
                                             for k, v in b.items()}, jef)
            jl.append(float(jm["loss"]))
    np.testing.assert_allclose(losses[:5], jl, rtol=1e-4, atol=1e-4)
    assert len(tree_leaves(ef)) == len(tree_leaves(params))
    assert all(e.shape == p.shape and e.dtype == torch.float32
               for e, p in zip(tree_leaves(ef), tree_leaves(params)))
    assert losses[-1] < losses[0] - 0.5, losses[::6]


def test_batches_are_the_references():
    for arch in ("smollm-135m", "qwen2-vl-2b"):
        a, b = _batch(arch, 1), _batch(arch, 1, "jax")
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


# ------------------------------------------------------------------ #
# what raises
# ------------------------------------------------------------------ #
def _fake(n, cls=DataGroup):
    """A group object for the argument checks, which raise before any
    collective."""
    return cls(None, 0, n, torch.device("cpu"))


def _model(arch="smollm-135m"):
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import build_model
    return build_model(get_smoke(arch), "cpu")


def test_sequence_and_data_groups_together_raise():
    from repro_torch.train.trainer import make_train_step
    with pytest.raises(ValueError, match="not both"):
        make_train_step(_model(), _tcfg("torch"), group=_fake(2, SeqGroup),
                        data=_fake(2))
    with pytest.raises(ValueError, match="not both"):
        _model().loss(None, {}, group=_fake(2, SeqGroup), data=_fake(2))
    with pytest.raises(TypeError, match="DataGroup"):
        make_train_step(_model(), _tcfg("torch"), data=_fake(2, SeqGroup))
    with pytest.raises(TypeError, match="SeqGroup"):
        make_train_step(_model(), _tcfg("torch"), group=_fake(2))


@pytest.mark.parametrize("compress", [False, True])
def test_a_batch_the_ranks_do_not_divide_raises(compress):
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import make_train_step

    model, tc = _model(), _tcfg("torch", compress=compress)
    params = model.init(torch.Generator().manual_seed(0))
    step = make_train_step(model, tc, data=_fake(3))
    want = ("compress_grads: batch axis must divide the compress mesh axes"
            if compress else "batch axis must divide the data group's 3")
    with pytest.raises(ValueError, match=want):
        step(params, adamw.init(tc.optimizer, params),
             _batch("smollm-135m", 0))


def test_dispatch_groups_the_ranks_do_not_divide_raise(monkeypatch):
    from repro_torch.models.moe import moe_apply

    model = _model("arctic-480b")
    params = model.init(torch.Generator().manual_seed(0))
    p = params["seg0_attn_moe_dense"][0]["moe"]
    x = torch.zeros(2, 16, model.cfg.d_model)
    monkeypatch.setenv("REPRO_MOE_GROUPS", "2")
    with pytest.raises(ValueError, match="do not split over the data "
                       "group's 4 ranks"):
        moe_apply(p, x, model.cfg, _fake(4))


# ------------------------------------------------------------------ #
# the CLI, elastic resume, reshard
# ------------------------------------------------------------------ #
CLI = ["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--seq", "32",
       "--batch", "4", "--lr", "5e-3", "--data-branch", "2", "--data-docs",
       "4", "--log-every", "1"]


def _losses(out):
    return {int(line.split()[1]): float(line.split()[3])
            for line in out.splitlines() if line.startswith("step ")}


def test_cli_data_parallel_prints_the_single_rank_losses(capfd):
    from repro_torch.launch.train import main

    one = main(CLI + ["--steps", "3"])
    l1 = _losses(capfd.readouterr().out)
    two = main(CLI + ["--steps", "3", "--data", "2", "--dist-backend",
                      "gloo"])
    out = capfd.readouterr().out
    l2 = _losses(out)
    assert "data=2 (gloo)" in out
    assert sorted(l1) == sorted(l2) == [0, 1, 2]
    for i in l1:
        assert abs(l1[i] - l2[i]) <= 1e-4     # printed to 4 decimals
    assert abs(one - two) <= 1e-5
    c = main(CLI + ["--steps", "3", "--data", "2", "--compress-grads"])
    out = capfd.readouterr().out
    assert "compress_grads" in out and np.isfinite(c)
    assert abs(_losses(out)[0] - l1[0]) <= 1e-4   # step 0 is pre-reduce
    # --data with --model runs (tests/test_torch_tp.py), on the int8 wire
    # too (tests/test_torch_compress_split.py)
    main(CLI + ["--steps", "1", "--data", "2", "--model", "2",
                "--compress-grads"])
    out = capfd.readouterr().out
    assert "compress_grads" in out
    assert abs(_losses(out)[0] - l1[0]) <= 1e-4


def test_cli_nccl_without_the_cards_names_gloo(capfd):
    from repro_torch.launch.train import main
    with pytest.raises(SystemExit):
        main(CLI + ["--steps", "1", "--data", "2", "--dist-backend",
                    "nccl"])
    assert "--dist-backend gloo" in capfd.readouterr().err


@pytest.mark.parametrize("resume_on", [1, 4])
def test_elastic_resume_of_a_two_rank_checkpoint(tmp_path, capfd,
                                                 resume_on):
    """A checkpoint written at step 2 by rank 0 of a 2-rank run resumes on
    ``resume_on`` ranks, and step 2's loss equals the uninterrupted
    run's within 1e-5 (the reference's elastic checkpoint test, on
    ranks)."""
    from repro_torch.launch.train import main

    full = main(CLI + ["--steps", "3"])
    capfd.readouterr()
    ck = str(tmp_path / "ck")
    main(CLI + ["--steps", "3", "--data", "2", "--ckpt", ck,
                "--ckpt-every", "2"])
    capfd.readouterr()
    import shutil
    shutil.rmtree(os.path.join(ck, "step_00000003"))
    resumed = main(CLI + ["--steps", "3", "--data", str(resume_on),
                          "--ckpt", ck, "--resume"])
    out = capfd.readouterr().out
    assert "# resumed from step 2" in out
    assert sorted(_losses(out)) == [2]
    assert abs(resumed - full) <= 1e-5


def test_reshard_and_restore_onto_device_trees(tmp_path):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.ft.checkpoint import restore, save
    from repro_torch.ft.manager import reshard
    from repro_torch.optim import adamw

    model = _model()
    params = model.init(torch.Generator().manual_seed(0))
    state = {"params": params, "opt": adamw.init(adamw.AdamWConfig(),
                                                 params)}
    moved = reshard(state, "cpu")
    assert isinstance(moved["opt"].step, int)
    assert _flat(moved["params"]).tobytes() == _flat(params).tobytes()
    tree = {"params": {"embed": torch.device("cpu")}, "opt": "cpu"}
    moved = reshard(state, tree)
    assert moved["params"]["ln_f"]["scale"] is params["ln_f"]["scale"]
    assert _flat(moved["params"], moved["opt"].v).tobytes() == \
        _flat(params, state["opt"].v).tobytes()
    save(tmp_path, state, 4)
    back = restore(tmp_path, state, shardings=tree)
    assert _flat(back["params"], back["opt"].m).tobytes() == \
        _flat(params, state["opt"].m).tobytes()
    with pytest.raises(ValueError, match="model_group"):
        restore(tmp_path, state, shardings={"params": {"embed": {
            "w": (Replicate(), Shard(0))}}})
    with pytest.raises(TypeError, match="placement"):
        reshard(state, 3)
