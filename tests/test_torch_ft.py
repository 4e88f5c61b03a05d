"""Port parity for fault tolerance, training side: the checkpoint format
(keys, dtypes, bit-exact round trips, checkpoints crossing between the
JAX package and the port), keep-k GC and the stale-tmp sweep, fault plans,
the restart loop, the eval step, and the train CLI's kill and resume.
Everything on the CPU; the reference runs on numpy inputs from a seed."""
import os
import subprocess
import sys
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_smoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.ft import checkpoint as j_ck
from repro.ft.injection import FaultPlan as JFaultPlan
from repro.models.model import build_model as j_build
from repro.optim import adamw as j_adamw
from repro.train.trainer import make_eval_step as j_make_eval
from repro_torch.configs import get_smoke as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.ft import (CheckpointManager, FaultPlan, StepCrash,
                            StragglerWatchdog, latest_step, restore,
                            run_with_restarts, save, sweep_stale_tmp)
from repro_torch.ft import checkpoint as t_ck
from repro_torch.ft.faults import RestartsExhausted
from repro_torch.ft.manager import reshard
from repro_torch.models.model import build_model as t_build
from repro_torch.obs import Observability
from repro_torch.optim import adamw as t_adamw
from repro_torch.train.trainer import make_eval_step
from repro_torch.tree import (tree_flatten_with_path, tree_leaves,
                              tree_unflatten)

torch.set_num_threads(2)


class Pair(NamedTuple):
    a: torch.Tensor
    b: Optional[torch.Tensor] = None


def _np_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"layers": [{"w": rng.normal(size=(4, 6)).astype(np.float32),
                        "b": rng.normal(size=(6,)).astype(np.float32)}
                       for _ in range(2)],
            "emb": rng.normal(size=(5, 4)).astype(np.float32)}


def _t_tree(p, dtype=torch.float32):
    return {"layers": [{k: torch.from_numpy(v).to(dtype)
                        for k, v in layer.items()} for layer in p["layers"]],
            "emb": torch.from_numpy(p["emb"]).to(dtype)}


def _assert_bits_equal(got, want):
    fg, dg = tree_flatten_with_path(got)
    fw, dw = tree_flatten_with_path(want)
    assert dg == dw
    for (pg, a), (pw, b) in zip(fg, fw):
        assert pg == pw
        assert type(a) is type(b), pg
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and a.device == b.device, pg
            assert torch.equal(a, b), pg
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, pg
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, pg


# ============================ tree + format ============================= #
def test_tree_flatten_unflatten_roundtrip():
    tree = {"x": [torch.zeros(2), (torch.ones(1), 3)],
            "nt": Pair(torch.ones(2)), "none": None,
            "opt": t_adamw.AdamWState(step=7, m={"w": torch.ones(1)},
                                      v={"w": torch.zeros(1)}, master=None)}
    flat, treedef = tree_flatten_with_path(tree)
    keys = ["::".join(p) for p, _ in flat]
    assert keys == ["x::0", "x::1::0", "x::1::1", "nt::.a", "opt::.step",
                    "opt::.m::w", "opt::.v::w"]
    back = tree_unflatten(treedef, [x for _, x in flat])
    assert isinstance(back["nt"], Pair) and back["nt"].b is None
    assert isinstance(back["x"][1], tuple) and back["none"] is None
    assert back["opt"].step == 7 and back["opt"].master is None
    # the dict/list leaves come in tree_leaves' order
    params = _t_tree(_np_params())
    assert [x for _, x in tree_flatten_with_path(params)[0]] \
        == tree_leaves(params)
    with pytest.raises(ValueError, match="more leaves"):
        tree_unflatten(treedef, [x for _, x in flat] + [0])


def test_checkpoint_keys_equal_reference():
    """The keys of {"params", "opt": AdamW state} are the reference's,
    letter for letter (dict keys and list indices bare, NamedTuple fields
    with a leading '.', no key for the None master)."""
    p = _np_params()
    jtree = {"params": jax.tree.map(jnp.asarray, p)}
    jtree["opt"] = j_adamw.init(j_adamw.AdamWConfig(), jtree["params"])
    ttree = {"params": _t_tree(p)}
    ttree["opt"] = t_adamw.init(t_adamw.AdamWConfig(), ttree["params"])
    jflat, _ = j_ck._flatten(jtree)
    tflat = t_ck._flatten(ttree)
    assert sorted(tflat) == sorted(jflat)
    assert {"params::layers::0::w", "opt::.m::emb", "opt::.step"} \
        <= set(tflat)
    for k in jflat:
        assert tflat[k].dtype == jflat[k].dtype, k
        np.testing.assert_array_equal(tflat[k], jflat[k])


def test_checkpoint_roundtrip_bit_equal(tmp_path):
    """bf16 (written as f32), f32, f16, int8, uint8, int32 tensors, numpy
    arrays, Python ints and a NamedTuple with a None member come back
    bit-equal, with their dtypes and types. Shapes follow the file, not
    ``like`` (a variable-length blob)."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((3, 5), generator=g)
    tree = {"bf16": x.bfloat16(), "f32": x, "f16": x.half(),
            "i8": torch.randint(-128, 127, (4, 2), generator=g,
                                dtype=torch.int8),
            "u8": np.frombuffer(b"variable blob", np.uint8).copy(),
            "i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "hist": np.linspace(-3, 0, 7),
            "step": 12, "nt": Pair(x[:2].clone())}
    save(tmp_path, tree, step=4)
    data = np.load(tmp_path / "step_00000004" / "arrays.npz")
    assert data["bf16"].dtype == np.float32
    assert data["step"].dtype == np.int32 and data["step"].shape == ()
    like = dict(tree, u8=np.zeros(2, np.uint8), step=0,
                nt=Pair(torch.zeros(1)),
                bf16=torch.zeros(1, dtype=torch.bfloat16))
    _assert_bits_equal(restore(tmp_path, like), tree)
    assert latest_step(tmp_path) == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_between_packages(tmp_path, dtype):
    """A checkpoint written by ``repro.ft.save`` restores bit-equal
    through the port, and one written by the port restores bit-equal
    through ``repro.ft.restore``: {"params", "opt"} after one AdamW step,
    the step an int32 in JAX and an int in the port."""
    p = _np_params(1)
    grads = _np_params(2)
    jp = jax.tree.map(lambda a: jnp.asarray(a, dtype), p)
    jcfg = j_adamw.AdamWConfig(lr=1e-2)
    jp, jo, _ = j_adamw.update(jcfg, j_adamw.init(jcfg, jp), jp,
                               jax.tree.map(jnp.asarray, grads))
    jtree = {"params": jp, "opt": jo}
    tdt = getattr(torch, dtype)
    tparams = _t_tree(p, tdt)
    tlike = {"params": tparams,
             "opt": t_adamw.init(t_adamw.AdamWConfig(), tparams)}

    j_ck.save(str(tmp_path / "j"), jtree, 1)
    got = restore(tmp_path / "j", tlike)
    assert got["opt"].step == 1 and isinstance(got["opt"].step, int)
    assert got["opt"].master is None
    jflat = j_ck._flatten(jtree)[0]
    for (path, leaf), (_, like) in zip(tree_flatten_with_path(got)[0],
                                       tree_flatten_with_path(tlike)[0]):
        if isinstance(leaf, torch.Tensor):
            assert leaf.dtype == like.dtype
            np.testing.assert_array_equal(leaf.float().numpy(),
                                          jflat["::".join(path)])

    save(tmp_path / "t", got, 1)
    back = j_ck.restore(str(tmp_path / "t"), jtree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


# ============================ manager + GC ============================== #
def test_keep_k_gc_with_async_writes(tmp_path):
    """Async writes through the manager: the caller's tensors change right
    after ``save`` returns (as the engine's slabs do), yet each checkpoint
    holds the values at the call; keep-k leaves the newest ``keep``."""
    mgr = CheckpointManager(tmp_path, keep=2, async_write=True)
    state = {"w": torch.zeros(256, 64), "n": 0}
    for step in range(1, 6):
        state["w"].fill_(float(step))      # in place, like a live slab
        state["n"] = step
        mgr.save(state, step)
        state["w"].fill_(-1.0)             # torn if the copy were late
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000004",
                                            "step_00000005"]
    for step in (4, 5):
        got = restore(tmp_path, state, step)
        assert got["n"] == step and bool((got["w"] == step).all())
    got, step = mgr.restore_latest(state)
    assert step == 5 and got["n"] == 5


def test_async_write_error_reaches_the_caller(tmp_path):
    """A background write that fails raises at the next ``wait``."""
    mgr = CheckpointManager(tmp_path, keep=2, async_write=True)
    mgr.save({"x": torch.ones(3)}, 1)
    mgr.wait()
    (tmp_path / "step_00000003").write_text("a file where a dir goes")
    mgr.save({"x": torch.ones(3)}, 3)
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                              # reported once
    with pytest.raises(TypeError, match="unsupported leaf"):
        mgr.save({"x": object()}, 4)


def test_stale_tmp_sweep(tmp_path):
    """Port of test_serve_ft.py::test_stale_tmp_sweep: dead-pid and
    own-pid tmp dirs go, a live foreign writer's stays, ``save`` sweeps."""
    d = tmp_path / "ck"
    d.mkdir()
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    for name in (f"tmp.3.{os.getpid()}", f"tmp.4.{dead.pid}", "tmp.5.1"):
        (d / name).mkdir()
        (d / name / "leaf.npy").write_bytes(b"x")
    assert sweep_stale_tmp(d) == 2
    assert sorted(p.name for p in d.iterdir()) == ["tmp.5.1"]
    (d / f"tmp.9.{dead.pid}").mkdir()
    save(d, {"x": np.arange(3)}, step=1)
    assert sorted(p.name for p in d.iterdir()) == ["step_00000001",
                                                   "tmp.5.1"]


# ============================ fault plans =============================== #
@pytest.mark.parametrize("seed,n,rates", [
    (3, 100, dict(crash_rate=0.1, exhaust_rate=0.05)),
    (0, 64, dict(crash_rate=0.2, exhaust_rate=0.1, straggle_rate=0.3,
                 straggle_s=0.5)),
    (11, 7, dict())])
def test_fault_plan_sample_equals_reference(seed, n, rates):
    t, j = FaultPlan.sample(seed, n, **rates), JFaultPlan.sample(seed, n,
                                                                 **rates)
    assert (t.crash_steps, t.exhaust_steps, t.straggle_steps,
            t.straggle_s) == (j.crash_steps, j.exhaust_steps,
                              j.straggle_steps, j.straggle_s)
    assert t == FaultPlan.sample(seed, n, **rates)


# ============================ restart loop ============================== #
def test_run_with_restarts_bounded(tmp_path):
    """Port of test_serve_ft.py::test_run_with_restarts_bounded."""
    mgr = CheckpointManager(tmp_path / "ck", keep=2, async_write=False)

    def bad_step(state, step):
        raise StepCrash("always")

    with pytest.raises(RestartsExhausted, match="after 3 restarts"):
        run_with_restarts(bad_step, 0, 5, mgr, checkpoint_every=2,
                          max_restarts=3)
    calls = []

    def rt_step(state, step):
        calls.append(step)
        raise RuntimeError("not a taxonomy fault")

    with pytest.raises(RuntimeError, match="not a taxonomy"):
        run_with_restarts(rt_step, 0, 5, mgr, checkpoint_every=2,
                          max_restarts=3)
    assert len(calls) == 1


@pytest.mark.parametrize("fail_at", [{7, 13}, {2, 13}])
def test_run_with_restarts_recovers(tmp_path, fail_at):
    """Port of test_substrates.py::test_run_with_restarts_recovers, and a
    crash before the first checkpoint (step 2), which restarts from the
    state the loop began with, not from the crashed run's."""
    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=False)
    final, hist = run_with_restarts(
        lambda s, i: {"x": s["x"] + 1}, {"x": torch.zeros(())}, n_steps=20,
        manager=mgr, checkpoint_every=5, fail_at=fail_at,
        watchdog=StragglerWatchdog())
    assert hist["restarts"] == 2
    assert float(final["x"]) == 20.0


def test_run_with_restarts_events(tmp_path):
    """Port of test_obs.py::test_run_with_restarts_events (an int state)."""
    obs = Observability(tracing=True)
    mgr = CheckpointManager(tmp_path / "ck", keep=2, async_write=False)
    state, hist = run_with_restarts(
        lambda s, i: s + 1, 0, 8, mgr, checkpoint_every=2,
        fail_at={5}, obs=obs)
    assert state == 8 and isinstance(state, int) and hist["restarts"] == 1
    assert obs.tracer.find("ft.fault") and obs.tracer.find("ft.restore")
    assert len(obs.tracer.find("train.step")) == hist["steps_run"]
    assert obs.registry.value("ft_faults", kind="StepCrash") == 1


def test_reshard_is_multi_gpu_work():
    """A placement that splits a leaf over ranks needs the ranks' model
    group: without one it raises. (Devices re-place:
    ``tests/test_torch_dist_data.py``; split placements across groups:
    ``test_tensor_parallel_checkpoint_*`` below.)"""
    from torch.distributed.tensor import Replicate, Shard
    split = (Replicate(), Shard(0))     # (data, model)
    with pytest.raises(ValueError, match="model_group"):
        reshard({"x": torch.zeros(2)}, split)
    with pytest.raises(ValueError, match="model_group"):
        reshard({"x": torch.zeros(2)}, {"x": split})
    with pytest.raises(ValueError, match="model_group"):
        save("unused", {"x": torch.zeros(2)}, 1, shardings=split)


# ===================== tensor-parallel checkpoints ===================== #
def _tp_state():
    """A gemma-smoke train state on one device: the parameters from a
    seed, the moments random, step 3."""
    cfg = t_smoke("gemma-7b")
    params = t_build(cfg, "cpu").init(torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(6)
    rnd = lambda p: torch.randn(p.shape, generator=gen)  # noqa: E731
    from repro_torch.tree import tree_map
    opt = t_adamw.AdamWState(step=3, m=tree_map(rnd, params),
                             v=tree_map(rnd, params), master=None)
    return cfg, {"params": params, "opt": opt}


def _tp_rank(world, state, path_tp):
    """One rank of a 4-rank world holding two layouts of the gemma-smoke
    state: one model group of 4, and a (data 2, model 2) mesh. Writes the
    4-way state's checkpoint (gathered, rank 0 writes), then checks every
    move between layouts against slices cut from the whole state, bit
    for bit: restore onto 2 and onto 4 ranks, reshard 4 -> 2, 2 -> 4,
    2 -> 1."""
    import torch.distributed as dist

    from repro_torch.dist.group import mesh_groups
    from repro_torch.dist.sharding import mesh_placements
    from repro_torch.train.trainer import state_shardings

    cfg = t_smoke("gemma-7b")
    mg4 = mesh_groups(world, 4).model
    mg2 = mesh_groups(world, 2).model
    sh = {n: state_shardings(mesh_placements(state["params"], cfg,
                                             model=n),
                             state["opt"]) for n in (2, 4)}
    local4 = reshard(state, sh[4], mg4)
    local2 = reshard(state, sh[2], mg2)
    save(path_tp, local4, 3, shardings=sh[4], model_group=mg4)
    dist.barrier()
    out = {}

    def same(a, b):
        try:
            _assert_bits_equal(a, b)
            return True
        except AssertionError:
            return False

    out["restore_2"] = same(restore(path_tp, local2, shardings=sh[2],
                                    model_group=mg2), local2)
    out["restore_4"] = same(restore(path_tp, local4, shardings=sh[4],
                                    model_group=mg4), local4)
    out["reshard_4_2"] = same(reshard(local4, sh[2], mg2, current=sh[4],
                                      current_group=mg4), local2)
    out["reshard_2_4"] = same(reshard(local2, sh[4], mg4, current=sh[2],
                                      current_group=mg2), local4)
    out["reshard_2_1"] = same(reshard(local2, None, current=sh[2],
                                      current_group=mg2), state)
    out["split"] = (local4["params"]["embed"]["w"].shape[0],
                    local2["opt"].m["seg0_attn_mlp"][0]["mlp"]["w_in"]
                    .shape[1])
    return out


def test_tensor_parallel_checkpoint_is_the_single_device_one(tmp_path):
    """A 4-way tensor-parallel state's checkpoint holds the whole leaves:
    its keys and every array equal a single-device checkpoint of the same
    state bit for bit. It restores onto 1 rank (here), 2 and 4 (on the
    ranks), and ``reshard`` moves the live state 4 -> 2, 2 -> 4 and
    2 -> 1, all bit-equal to slices of the whole state; the reference's
    ``restore`` reads it."""
    from repro_torch.dist.group import run_ranks
    from repro_torch.tree import tree_map

    cfg, state = _tp_state()
    save(tmp_path / "single", state, 3)
    res = run_ranks(_tp_rank, 4, backend="gloo", device="cpu",
                    timeout_s=120.0, args=(state, str(tmp_path / "tp")))
    for r, rec in enumerate(res):
        assert rec.pop("split") == (cfg.vocab_size // 4, cfg.d_ff // 2)
        assert all(rec.values()), (r, rec)
    a = np.load(tmp_path / "single" / "step_00000003" / "arrays.npz")
    b = np.load(tmp_path / "tp" / "step_00000003" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    assert open(tmp_path / "single" / "step_00000003" / "meta.json").read() \
        == open(tmp_path / "tp" / "step_00000003" / "meta.json").read()
    _assert_bits_equal(restore(tmp_path / "tp", state), state)
    jlike = {"params": tree_map(lambda x: jnp.asarray(x.numpy()),
                                state["params"])}
    jlike["opt"] = j_adamw.init(j_adamw.AdamWConfig(), jlike["params"])
    back = j_ck.restore(str(tmp_path / "tp"), jlike)
    assert int(back["opt"].step) == 3
    got, want = j_ck._flatten(back)[0], t_ck._flatten(state)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])


# ============================ eval + CLI ================================ #
def test_eval_step_matches_reference():
    """``make_eval_step`` metrics within 1e-5 (relative) of the
    reference's on the same parameters and batch (f32)."""
    jcfg, tcfg = j_smoke("smollm-135m"), t_smoke("smollm-135m")
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(4))
    ds = JSyntheticLM(jcfg, JDataConfig(64, 2, seed=1, branch=2, n_docs=4))
    batch = ds.batch(3)
    jm = jax.jit(j_make_eval(jmodel))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tm = make_eval_step(t_build(tcfg, "cpu"))(tparams, batch)
    assert set(tm) == set(jm) == {"nll", "loss"}
    for k in jm:
        assert not tm[k].requires_grad
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)


def test_cli_kill_and_resume_bit_equal(tmp_path, capsys, monkeypatch):
    """``--ckpt --ckpt-every 10`` on the CPU: a 30-step run killed at step
    20 (a StepCrash from its 21st step; the LR schedule spans the 30
    steps, as a relaunched job's does) and resumed with ``--resume`` runs
    steps 20..29 with the losses and grad norms of an uninterrupted
    30-step run, bit for bit, and ends with a checkpoint at step 30."""
    import repro_torch.launch.train as cli

    real = cli.make_train_step
    seen = {}                       # step -> (loss, grad norm), as floats

    def recording(kill_at=None):
        def make(model, tcfg, **kw):
            step = real(model, tcfg, **kw)

            def run(params, opt, batch, ef_state=None):
                if opt.step == kill_at:
                    raise StepCrash(f"killed at step {kill_at}")
                i = opt.step
                params, opt, met, ef_state = step(params, opt, batch,
                                                  ef_state)
                seen[i] = (float(met["loss"]), float(met["grad_norm"]))
                return params, opt, met, ef_state
            return run
        return make

    args = ["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--seq",
            "32", "--batch", "2", "--lr", "5e-3", "--data-branch", "2",
            "--data-docs", "4", "--steps", "30"]
    monkeypatch.setattr(cli, "make_train_step", recording())
    cli.main(args)
    full, seen = dict(seen), {}
    assert sorted(full) == list(range(30))

    ckpt = str(tmp_path / "ck")
    monkeypatch.setattr(cli, "make_train_step", recording(kill_at=20))
    with pytest.raises(StepCrash):
        cli.main(args + ["--ckpt", ckpt, "--ckpt-every", "10"])
    assert latest_step(ckpt) == 20
    assert seen == {i: full[i] for i in range(20)}
    seen.clear()

    monkeypatch.setattr(cli, "make_train_step", recording())
    cli.main(args + ["--ckpt", ckpt, "--ckpt-every", "10", "--resume"])
    assert "# resumed from step 20" in capsys.readouterr().out
    assert seen == {i: full[i] for i in range(20, 30)}
    assert latest_step(ckpt) == 30
    with pytest.raises(SystemExit):
        cli.main(args + ["--resume"])          # --resume needs --ckpt
