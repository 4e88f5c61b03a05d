"""Port parity for the vision-language family (qwen2-vl-2b at its ``SMOKE``
shape: M-RoPE sections (2, 3, 3), 16 vision slots, GQA 2) against the JAX
reference on the CPU: M-RoPE, the vision merge, the model's forward, loss
and gradients, the lockstep decode and engine, the batch extras, the
microbatched train step, checkpoint keys and the command lines.

Inputs are f32 and made from a seed (the JAX init, handed to the port as
numpy through ``params_from_jax``; tokens, embeddings and positions from
numpy). Tolerances: ``rope`` 1e-6 (abs and rel), logits and ``decode_step``
logits 1e-5, loss 1e-6 (rel), every gradient 1e-4 (the reference's own
gradient bar: the same f32 algorithm summed in another order), greedy
tokens and batches exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_smoke as j_smoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.ft import checkpoint as j_ck
from repro.models import layers as JL
from repro.models.model import build_model as j_build
from repro.optim import adamw as j_adamw
from repro.serve.engine import ContinuousConfig as JConfig
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import make_train_step as j_train_step
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_smoke as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.ft import checkpoint as t_ck
from repro_torch.models import layers as TL
from repro_torch.models.model import build_model as t_build
from repro_torch.optim import adamw as t_adamw
from repro_torch.serve.engine import ContinuousConfig as TConfig
from repro_torch.serve.engine import ContinuousEngine as TEngine
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.train.trainer import TrainConfig, make_train_step
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)
ARCH = "qwen2-vl-2b"
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
SEQ, BATCH = 64, 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _amplify(params, gain=6.0):
    """Scale every residual branch's output projection (``wo``,
    ``w_out``), so greedy tokens depend on the blocks."""
    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return tree * gain if name in ("wo", "w_out") else tree
    return {k: walk(v) if k.startswith("seg") else v
            for k, v in params.items()}


def _models(seed=0, amplify=False):
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    if amplify:
        jparams = _amplify(jparams)
    tparams = params_from_jax(_np(jparams), "cpu")
    return jcfg, (jmodel, jparams), (t_build(tcfg, "cpu"), tparams)


def _jbatch(step=0, seq=SEQ, batch=BATCH, seed=0):
    return JSyntheticLM(j_smoke(ARCH), JDataConfig(seq, batch, seed=seed)
                        ).batch(step)


# ============================== configs ================================ #
def test_config_and_program_equal_reference():
    """CONFIG and SMOKE equal the reference's field for field, the program
    is the reference's dense stack, and the port's init holds the
    reference's parameters (``vision_proj`` included)."""
    for jget, tget in ((j_config, t_config), (j_smoke, t_smoke)):
        assert dataclasses.asdict(tget(ARCH)) == \
            dataclasses.asdict(jget(ARCH))
        assert t_build(tget(ARCH), "cpu").program == \
            j_build(jget(ARCH)).program == [("attn_mlp",
                                             jget(ARCH).n_layers)]
    c = t_config(ARCH)
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.hd, c.d_ff,
            c.vocab_size, c.mrope_sections, c.n_vision_tokens) == (
        28, 1536, 12, 2, 128, 8960, 151936, (16, 24, 24), 1024)
    _, (jm, jp), _ = _models()
    tp = t_build(t_smoke(ARCH), "cpu").init(torch.Generator().manual_seed(0))
    assert tp["vision_proj"]["w"].shape == (64, 64)
    assert sum(x.numel() for x in tree_leaves(tp)) == \
        sum(x.size for x in jax.tree.leaves(jp))


# =============================== M-RoPE ================================ #
@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16),
                                         ((16, 24, 24), 128)])
@pytest.mark.parametrize("equal", [True, False])
def test_mrope_matches_jax(sections, hd, equal):
    """``rope`` with sections over (3, B, S) positions within 1e-6 of the
    reference's, with the three components equal (where M-RoPE is plain
    RoPE, which the port's plain path must then equal too) and unequal."""
    rng = np.random.default_rng(hd)
    B, S, H = 2, 12, 3
    x = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    if equal:
        pos = np.broadcast_to(rng.integers(0, 4000, (B, S)),
                              (3, B, S)).astype(np.int32)
    else:
        pos = rng.integers(0, 4000, (3, B, S)).astype(np.int32)
    want = np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                              sections))
    got = TL.rope(_t(x), _t(pos), 1e6, sections)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    plain = TL.rope(_t(x), _t(pos[0]), 1e6)
    if equal:
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-6,
                                   atol=1e-6)
    else:
        assert not np.allclose(got.numpy(), plain.numpy(), atol=1e-3)
    with pytest.raises(AssertionError):
        TL.rope(_t(x), _t(pos), 1e6, (1, 1, 1))


# ========================== forward and grads ========================== #
def test_forward_loss_and_grads_match_jax():
    """On a SyntheticLM batch (16 vision slots, (3, B, S) positions):
    logits within 1e-5, loss within 1e-6 and the gradient of every
    parameter within 1e-4, ``vision_proj`` included."""
    jcfg, (jm, jp), (tm, tp) = _models()
    batch = _jbatch()
    assert batch["positions"].shape == (3, BATCH, SEQ)
    jlogits = np.asarray(jax.jit(jm.forward)(jp, batch))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jp, batch)
    tbatch = {k: _t(v) for k, v in batch.items()}
    for leaf in tree_leaves(tp):
        leaf.requires_grad_()
    tlogits = tm.forward(tp, tbatch)
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits, **TOL)
    tloss, _ = tm.loss(tp, tbatch)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-6)
    tloss.backward()
    want = params_from_jax(_np(jgrads), "cpu")
    assert float(want["vision_proj"]["w"].abs().sum()) > 0
    np.testing.assert_allclose(tp["vision_proj"]["w"].grad.numpy(),
                               want["vision_proj"]["w"].numpy(), **GRAD_TOL)
    got = [x.grad for x in tree_leaves(tp)]
    assert len(got) == len(tree_leaves(want)) > 15
    for g, w in zip(got, tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("extras", ["none", "vision", "positions"])
def test_forward_default_positions_and_vision_merge(extras):
    """Without extras (text only, default positions arange in all three
    components), with a random vision mask and no positions, and with
    unequal (3, B, S) positions: logits within 1e-5 of the reference's."""
    jcfg, (jm, jp), (tm, tp) = _models(seed=1)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (BATCH, 24)
                                    ).astype(np.int32)}
    if extras == "vision":
        batch["vision_embeds"] = rng.normal(
            size=(BATCH, 24, jcfg.d_model)).astype(np.float32)
        batch["vision_mask"] = rng.integers(0, 2, (BATCH, 24)).astype(bool)
    if extras == "positions":
        batch["positions"] = rng.integers(0, 24, (3, BATCH, 24)
                                          ).astype(np.int32)
    want = np.asarray(jm.forward(jp, batch))
    got = tm.forward(tp, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ================================ decode =============================== #
@pytest.mark.parametrize("vision", [False, True])
def test_decode_step_logits_match_jax(vision):
    """20 lockstep decode steps past the smoke window of 16 (M-RoPE text
    decode: default (3, B, 1) positions at t): logits within 1e-5 at every
    step, without and with (B, 1) vision extras (the reference's
    ``test_decode_step`` feeds them)."""
    jcfg, (jm, jp), (tm, tp) = _models(amplify=True)
    B, n = 2, 20
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (B, n))
    vis = rng.normal(size=(B, n, jcfg.d_model)).astype(np.float32)
    vmask = rng.integers(0, 2, (B, n)).astype(bool)
    jc, tc = jm.init_cache(B, n), tm.init_cache(B, n)
    step = jax.jit(jm.decode_step)
    for t in range(n):
        bt = {"tokens": toks[:, t:t + 1]}
        if vision:
            bt.update(vision_embeds=vis[:, t:t + 1],
                      vision_mask=vmask[:, t:t + 1])
        jl, jc = step(jp, jc, {k: jnp.asarray(v) for k, v in bt.items()}, t)
        tl, tc = tm.decode_step(tp, tc, {k: _t(v) for k, v in bt.items()}, t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"step {t}", **TOL)


def test_lockstep_engine_greedy_tokens_identical():
    """Batch 2, prompt 20 (past the window), 12 new tokens on the lockstep
    engines: identical greedy tokens."""
    jcfg, (jm, jp), (tm, tp) = _models(amplify=True)
    prompts = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 20))
    want = JServeEngine(jm, JServeConfig(max_len=32)).generate(
        jp, jnp.asarray(prompts), 12)
    got = ServeEngine(tm, ServeConfig(max_len=32)).generate(tp, prompts, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(set(got.flatten().tolist())) > 3


def test_continuous_engine_refuses_like_the_reference():
    jcfg, (jm, _), (tm, _) = _models()
    kw = dict(n_pages=16, page=8, chunk=8, max_batch=2)
    with pytest.raises(NotImplementedError, match="text-only LMs"):
        JEngine(jm, JConfig(**kw))
    with pytest.raises(NotImplementedError, match="text-only LMs"):
        TEngine(tm, TConfig(**kw), device="cpu")


# ============================ data and train =========================== #
@pytest.mark.parametrize("seq,batch,n_hosts", [(64, 2, 1), (20, 4, 2)])
def test_synthetic_batches_bit_equal(seq, batch, n_hosts):
    """Batches of three steps (every host's): the same keys, dtypes and
    values as the reference's, the vision slots cut to S // 2."""
    cfg = t_smoke(ARCH)
    for host in range(n_hosts):
        j = JSyntheticLM(j_smoke(ARCH), JDataConfig(seq, batch, seed=3),
                         host, n_hosts)
        t = SyntheticLM(cfg, DataConfig(seq, batch, seed=3), host, n_hosts)
        for step in range(3):
            jb, tb = j.batch(step), t.batch(step)
            assert list(tb) == list(jb) == [
                "tokens", "labels", "vision_mask", "vision_embeds",
                "positions"]
            for key in jb:
                assert tb[key].dtype == jb[key].dtype, key
                np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)
            assert int(tb["vision_mask"].sum(1)[0]) == min(16, seq // 2)


def test_microbatched_train_step_matches_jax():
    """Two AdamW steps with 2 microbatches (M-RoPE positions split on their
    batch axis, axis 1): loss and grad norm within 1e-4 of the
    reference's, and the parameters left within 1e-4."""
    jcfg, (jm, jp), (tm, tp) = _models()
    batches = [_jbatch(step=i, batch=4) for i in range(2)]
    jstep = jax.jit(j_train_step(jm, JTrainConfig(microbatches=2)))
    tstep = make_train_step(tm, TrainConfig(microbatches=2))
    jopt = j_adamw.init(j_adamw.AdamWConfig(), jp)
    topt = t_adamw.init(t_adamw.AdamWConfig(), tp)
    for b in batches:
        jp, jopt, jmet = jstep(jp, jopt, b)[:3]
        tp, topt, tmet, _ = tstep(tp, topt, b)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=1e-4, atol=1e-4, err_msg=key)
    for a, b in zip(tree_leaves(tp), tree_leaves(params_from_jax(
            _np(jp), "cpu"))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_train_checkpoint_keys_equal_reference(tmp_path):
    """{"params", "opt"} of the smoke model: the port's checkpoint keys
    (``vision_proj`` included) equal ``repro.ft.checkpoint._flatten``'s of
    the same tree, and a checkpoint crosses between the packages both
    ways bit-equal."""
    _, _, (_, tp) = _models()
    jparams = tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    jtree = {"params": jparams,
             "opt": j_adamw.init(j_adamw.AdamWConfig(), jparams)}
    ttree = {"params": tp, "opt": t_adamw.init(t_adamw.AdamWConfig(), tp)}
    jflat, _ = j_ck._flatten(jtree)
    tflat = t_ck._flatten(ttree)
    assert sorted(tflat) == sorted(jflat)
    assert {"params::vision_proj::w", "opt::.v::vision_proj::w"} <= set(tflat)
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


# ================================ CLIs ================================= #
def test_train_cli_loss_falls(capsys):
    from repro_torch.launch.train import main

    final = main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                  "20", "--seq", "64", "--batch", "4", "--lr", "5e-3",
                  "--data-branch", "2", "--data-docs", "4"])
    out = capsys.readouterr().out
    first = float(out.split("step     0 loss")[1].split()[0])
    assert final < first - 0.5, out


@pytest.mark.parametrize("engine", ["lockstep", "continuous"])
def test_serve_cli(engine, capsys):
    from repro_torch.launch.serve import main

    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--engine", engine,
            "--batch", "2", "--prompt-len", "20", "--new-tokens", "6"]
    if engine == "continuous":
        with pytest.raises(NotImplementedError, match="text-only LMs"):
            main(argv)
        return
    assert main(argv).shape == (2, 6)
    assert "engine=lockstep" in capsys.readouterr().out
