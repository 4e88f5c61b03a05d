"""Port parity: the training path (model forward/loss/grads, AdamW +
schedule, the train step with and without microbatches, the data
pipeline, the straggler watchdog, the train CLI) against the JAX
reference on the CPU, at the smollm smoke config in f32 with reference
parameters converted by ``params_from_jax``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_smoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.ft.manager import StragglerWatchdog as JWatchdog
from repro.models.model import build_model as j_build
from repro.optim import adamw as j_adamw
from repro.optim.schedule import Schedule as JSchedule
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import make_train_step as j_make_step
from repro_torch.configs import get_smoke as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.ft.manager import StragglerWatchdog
from repro_torch.models.model import build_model as t_build
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim.schedule import Schedule
from repro_torch.train.trainer import TrainConfig, make_train_step
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)
# f32 end to end; the attention gradients are 1e-4 by the reference's own
# bar, so the model's grads are held there too.
TOL = dict(rtol=1e-4, atol=1e-4)
SEQ, BATCH = 64, 4


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = j_smoke("smollm-135m"), t_smoke("smollm-135m")
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    ds = JSyntheticLM(jcfg, JDataConfig(SEQ, BATCH, seed=0, branch=2,
                                        n_docs=4))
    return jcfg, tcfg, jmodel, jparams, np_params, ds


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_forward_loss_and_grads_match_jax(setup):
    """Logits, loss and the grads w.r.t. every parameter equal the
    reference's (remat 'full' on both sides)."""
    jcfg, tcfg, jmodel, jparams, np_params, ds = setup
    assert jcfg.remat == tcfg.remat == "full"
    batch = ds.batch(0)
    jlogits = np.asarray(jax.jit(jmodel.forward)(jparams, batch))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(jparams, batch)

    tmodel = t_build(tcfg, "cpu")
    tparams = params_from_jax(np_params, device="cpu")
    for leaf in tree_leaves(tparams):
        leaf.requires_grad_()
    tlogits = tmodel.forward(tparams, _tbatch(batch))
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits, **TOL)
    tloss, metrics = tmodel.loss(tparams, _tbatch(batch))
    assert set(metrics) == {"nll", "loss"}
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-6)
    tloss.backward()
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), device="cpu")
    got = [x.grad for x in tree_leaves(tparams)]
    want = tree_leaves(want)
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_jax(setup, microbatches):
    """Three steps of the train step (clip, AdamW, warmup + cosine):
    losses within 1e-5 relative, parameters within 1e-4."""
    jcfg, tcfg, jmodel, jparams, np_params, ds = setup
    sched = dict(warmup_steps=2, total_steps=3)
    jt = JTrainConfig(optimizer=j_adamw.AdamWConfig(lr=5e-3),
                      schedule=JSchedule(**sched), microbatches=microbatches)
    tt = TrainConfig(optimizer=t_adamw.AdamWConfig(lr=5e-3),
                     schedule=Schedule(**sched), microbatches=microbatches)
    jstep = jax.jit(j_make_step(jmodel, jt))
    tstep = make_train_step(t_build(tcfg, "cpu"), tt)
    jp, jo = jparams, j_adamw.init(jt.optimizer, jparams)
    tp = params_from_jax(np_params, device="cpu")
    to = t_adamw.init(tt.optimizer, tp)
    for i in range(3):
        b = ds.batch(i)
        jp, jo, jm, _ = jstep(jp, jo, {k: jnp.asarray(v) for k, v in
                                       b.items()})
        tp, to, tm, _ = tstep(tp, to, b)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert to.step == int(jo.step) == 3
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    for g, w in zip(tree_leaves(tp), want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def test_adamw_master_and_bf16_moments_match_jax():
    """``use_master`` and ``moment_dtype`` carry over: bf16 params with an
    f32 master and bf16 moments, two updates, equal to the reference."""
    rng = np.random.default_rng(5)
    p = {"a": rng.normal(size=(4, 8)).astype(np.float32),
         "b": [{"w": rng.normal(size=(8,)).astype(np.float32)}]}
    g = [{"a": rng.normal(size=(4, 8)).astype(np.float32),
          "b": [{"w": rng.normal(size=(8,)).astype(np.float32)}]}
         for _ in range(2)]
    kw = dict(lr=1e-2, moment_dtype="bfloat16", use_master=True)
    jcfg, tcfg = j_adamw.AdamWConfig(**kw), t_adamw.AdamWConfig(**kw)
    jp = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), p)
    tp = {"a": torch.tensor(p["a"]).bfloat16(),
          "b": [{"w": torch.tensor(p["b"][0]["w"]).bfloat16()}]}
    js, ts = j_adamw.init(jcfg, jp), t_adamw.init(tcfg, tp)
    for gi in g:
        jp, js, _ = j_adamw.update(jcfg, js, jp, jax.tree.map(jnp.asarray,
                                                             gi), 0.5)
        tg = {"a": torch.tensor(gi["a"]),
              "b": [{"w": torch.tensor(gi["b"][0]["w"])}]}
        tp, ts, _ = t_adamw.update(tcfg, ts, tp, tg, 0.5)
    assert ts.m["a"].dtype == torch.bfloat16
    for a, b in ((tp["a"], jp["a"]), (ts.master["a"], js.master["a"]),
                 (ts.v["b"][0]["w"], js.v["b"][0]["w"])):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=1e-2,
                                   atol=1e-6)


@pytest.mark.parametrize("kind", ["cosine", "rsqrt", "constant"])
def test_schedule_matches_jax(kind):
    """Tolerance 1e-6: the reference evaluates the scale in f32."""
    js = JSchedule(warmup_steps=7, total_steps=40, kind=kind)
    ts = Schedule(warmup_steps=7, total_steps=40, kind=kind)
    for step in (0, 1, 6, 7, 8, 20, 39, 40, 55):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6,
                                   atol=1e-7)


def test_synthetic_batches_bitwise_equal():
    jcfg, tcfg = j_smoke("smollm-135m"), t_smoke("smollm-135m")
    for host, n_hosts in ((0, 1), (1, 2)):
        kw = dict(seq_len=33, global_batch=4, seed=3, branch=4, n_docs=5)
        jd = JSyntheticLM(jcfg, JDataConfig(**kw), host, n_hosts)
        td = SyntheticLM(tcfg, DataConfig(**kw), host, n_hosts)
        for step in (0, 5):
            a, b = jd.batch(step), td.batch(step)
            assert set(a) == set(b) == {"tokens", "labels"}
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_straggler_watchdog_matches_jax():
    times = [1.0, 1.0, 1.0, 0.1, 0.1, 0.12, 0.5, 0.1, 0.11, 0.4, 0.1]
    jw, tw = JWatchdog(), StragglerWatchdog()
    assert [tw.observe(t) for t in times] == [jw.observe(t) for t in times]
    assert tw.events == jw.events > 0


def test_cli_smoke_loss_drops(capsys):
    """The verify recipe on the CPU: the loss drops from about 6.5 within
    30 steps."""
    from repro_torch.launch.train import main

    final = main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                  "--steps", "30", "--seq", "64", "--batch", "4", "--lr",
                  "5e-3", "--data-branch", "2", "--data-docs", "4"])
    out = capsys.readouterr().out
    first = float(out.split("step     0 loss")[1].split()[0])
    assert 6.0 < first < 7.0, out
    assert final < first - 0.8, out


def test_cli_unported_options_raise():
    """``--model`` > 1 (tensor parallelism) runs every family
    (``tests/test_torch_tp.py``, ``tests/test_torch_tp_families.py``),
    ``--data`` and ``--compress-grads`` run
    (``tests/test_torch_dist_data.py``), with ``--model`` > 1 and
    ``--fsdp`` too (``tests/test_torch_compress_split.py``); an expert
    count the model group does not divide is multi-GPU work left to port,
    and raises before any rank starts."""
    from repro_torch.launch.train import main

    for extra in (["--arch", "arctic-480b", "--model", "3"],):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1, "
                           "'multi-GPU'"):
            main(["--smoke", "--device", "cpu", "--steps", "1"] + extra)
