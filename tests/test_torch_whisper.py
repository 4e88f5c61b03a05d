"""Port parity for the encoder-decoder family (whisper-base at its ``SMOKE``
shape: 2 encoder and 2 decoder layers, 32 audio frames, the encoder on
the bidirectional pattern with global rows) against the JAX reference on
the CPU: cross attention, sinusoidal positions, the encoder, the model's
forward, loss and gradients, the lockstep decode (zero and filled cross
caches) and engine, the batch extras, checkpoints (keys, and a reference
train checkpoint resumed by the port's CLI) and the command lines.

Inputs are f32 and made from a seed (the JAX init, handed to the port as
numpy through ``params_from_jax``; tokens, embeddings and caches from
numpy). Tolerances: cross attention, the encoder, logits and
``decode_step`` logits 1e-5 (abs and rel), loss 1e-6 (rel), every
gradient 1e-4 (the reference's own gradient bar), sinusoidal positions,
greedy tokens and batches exact.
"""
import dataclasses
import shutil

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
from repro.launch.train import main as j_train_main
from repro.models import layers as JL
from repro.models.model import build_model as j_build
from repro.optim import adamw as j_adamw
from repro.serve.engine import ContinuousConfig as JConfig
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_smoke as t_smoke
from repro_torch.convert import (checkpoint_from_jax, is_jax_checkpoint,
                                 params_from_jax)
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.ft import checkpoint as t_ck
from repro_torch.launch.train import main as t_train_main
from repro_torch.models import layers as TL
from repro_torch.models.model import build_model as t_build
from repro_torch.optim import adamw as t_adamw
from repro_torch.serve.engine import ContinuousConfig as TConfig
from repro_torch.serve.engine import ContinuousEngine as TEngine
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map

torch.set_num_threads(2)
ARCH = "whisper-base"
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
SEQ, BATCH = 64, 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _amplify(params, gain=6.0):
    """Scale every residual branch's output projection (``wo``,
    ``w_out``) of the decoder and the encoder, so greedy tokens depend on
    the blocks."""
    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return tree * gain if name in ("wo", "w_out") else tree
    return {k: walk(v) if k.startswith("seg") or k == "enc" else v
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
    is the decoder's ``xattn`` stack, and the port's init holds the
    reference's parameters (the encoder's included)."""
    for jget, tget in ((j_config, t_config), (j_smoke, t_smoke)):
        assert dataclasses.asdict(tget(ARCH)) == \
            dataclasses.asdict(jget(ARCH))
        assert t_build(tget(ARCH), "cpu").program == \
            j_build(jget(ARCH)).program == [("xattn", jget(ARCH).n_layers)]
    c = t_config(ARCH)
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.hd, c.d_ff,
            c.vocab_size, c.act, c.encoder_decoder, c.n_audio_frames) == (
        6, 512, 8, 8, 64, 2048, 51865, "gelu", True, 1500)
    _, (jm, jp), _ = _models()
    tp = t_build(t_smoke(ARCH), "cpu").init(torch.Generator().manual_seed(0))
    assert list(tp["enc"]) == ["seg0_attn_mlp", "ln_f"]
    assert len(tp["enc"]["seg0_attn_mlp"]) == 2
    assert list(tp["seg0_xattn"][0]) == ["ln1", "attn", "ln_x", "xattn",
                                         "ln2", "mlp"]
    assert sum(x.numel() for x in tree_leaves(tp)) == \
        sum(x.size for x in jax.tree.leaves(jp))


# ======================= cross attention, positions ==================== #
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)])
def test_cross_attention_matches_jax(H, Hkv):
    """``cross_attn_apply`` (S 24 over 32 encoder frames) and
    ``cross_attn_decode`` (one token over cached encoder K/V) within 1e-5
    of the reference's, also with fewer KV heads than query heads."""
    cfg = dataclasses.replace(j_smoke(ARCH), n_kv_heads=Hkv, n_heads=H)
    tcfg = dataclasses.replace(t_smoke(ARCH), n_kv_heads=Hkv, n_heads=H)
    p = JL.attn_init(jax.random.PRNGKey(3), cfg)
    tp = {k: _t(v) for k, v in _np(p).items()}
    rng = np.random.default_rng(H + Hkv)
    x = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    want, (jk, jv) = JL.cross_attn_apply(p, jnp.asarray(x), jnp.asarray(enc),
                                         cfg)
    got = TL.cross_attn_apply(tp, _t(x), _t(enc), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    xt = x[:, :1]
    want = JL.cross_attn_decode(p, jnp.asarray(xt), jk, jv, cfg)
    got = TL.cross_attn_decode(tp, _t(xt), _t(jk), _t(jv), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S,d,dtype", [(32, 64, "float32"),
                                       (1500, 512, "float32"),
                                       (1500, 512, "bfloat16")])
def test_sinusoidal_positions_bit_equal(S, d, dtype):
    want = np.asarray(JL.sinusoidal_pos(S, d, jnp.dtype(dtype))
                      ).astype(np.float32)
    got = TL.sinusoidal_pos(S, d, getattr(torch, dtype))
    assert got.shape == (S, d) and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_encoder_matches_jax():
    """``Model._encode`` over the batch's audio frames (sinusoidal
    positions, the bidirectional pattern with 2 global rows and columns,
    the final norm) within 1e-5 of the reference's."""
    _, (jm, jp), (tm, tp) = _models()
    batch = _jbatch()
    assert batch["audio_embeds"].shape == (BATCH, 32, 64)
    want = np.asarray(jm._encode(jp, batch))
    got = tm._encode(tp, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ========================== forward and grads ========================== #
def test_forward_loss_and_grads_match_jax():
    """On a SyntheticLM batch: logits within 1e-5, loss within 1e-6 and
    the gradient of every parameter within 1e-4, the encoder's (which
    reach it through every decoder layer's cross attention) included."""
    jcfg, (jm, jp), (tm, tp) = _models()
    batch = _jbatch()
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
    enc = tree_leaves(want["enc"])
    assert len(enc) == 17 and all(float(w.abs().sum()) > 0 for w in enc)
    got = [x.grad for x in tree_leaves(tp)]
    assert len(got) == len(tree_leaves(want)) > 40
    for g, w in zip(got, tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL)


# ================================ decode =============================== #
@pytest.mark.parametrize("cross", ["zero", "filled"])
def test_decode_step_logits_match_jax(cross):
    """20 lockstep decode steps past the smoke window of 16: logits within
    1e-5 at every step, with the cross caches as ``init_cache`` leaves
    them (zeros: nothing fills them in either package) and with the same
    seeded ``xk``/``xv`` on both sides."""
    jcfg, (jm, jp), (tm, tp) = _models(amplify=True)
    B, n = 2, 20
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (B, n))
    jc, tc = jm.init_cache(B, n), tm.init_cache(B, n)
    assert tuple(tc["seg0_xattn"]["xk"].shape) == \
        tuple(jc["seg0_xattn"]["xk"].shape) == (2, B, 32, 4, 16)
    if cross == "filled":
        for key in ("xk", "xv"):
            x = rng.normal(size=jc["seg0_xattn"][key].shape).astype(
                np.float32)
            jc["seg0_xattn"][key] = jnp.asarray(x)
            tc["seg0_xattn"][key].copy_(_t(x))
    step = jax.jit(jm.decode_step)
    for t in range(n):
        jl, jc = step(jp, jc, {"tokens": jnp.asarray(toks[:, t:t + 1])}, t)
        tl, tc = tm.decode_step(tp, tc, {"tokens": _t(toks[:, t:t + 1])}, t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"step {t}", **TOL)
    for key in ("k", "v", "xk", "xv"):
        np.testing.assert_allclose(tc["seg0_xattn"][key].numpy(),
                                   np.asarray(jc["seg0_xattn"][key]), **TOL)


def test_lockstep_engine_greedy_tokens_identical():
    """Batch 2, prompt 20 (past the window), 12 new tokens on the lockstep
    engines: identical greedy tokens; the cross caches stay zero in both
    (the engines feed tokens only)."""
    jcfg, (jm, jp), (tm, tp) = _models(amplify=True)
    prompts = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 20))
    jeng = JServeEngine(jm, JServeConfig(max_len=32))
    want = jeng.generate(jp, jnp.asarray(prompts), 12)
    teng = ServeEngine(tm, ServeConfig(max_len=32))
    got = teng.generate(tp, prompts, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(set(got.flatten().tolist())) > 3
    cache, _ = teng.prefill(tp, prompts[:, :4])
    assert not cache["seg0_xattn"]["xk"].any()


def test_continuous_engine_refuses_like_the_reference():
    jcfg, (jm, _), (tm, _) = _models()
    kw = dict(n_pages=16, page=8, chunk=8, max_batch=2)
    with pytest.raises(NotImplementedError, match="text-only LMs"):
        JEngine(jm, JConfig(**kw))
    with pytest.raises(NotImplementedError, match="text-only LMs"):
        TEngine(tm, TConfig(**kw), device="cpu")


# ============================ data and train =========================== #
@pytest.mark.parametrize("seq,batch,n_hosts", [(64, 2, 1), (16, 4, 2)])
def test_synthetic_batches_bit_equal(seq, batch, n_hosts):
    """Batches of three steps (every host's): the same keys, dtypes and
    values (the audio frames drawn after the tokens) as the reference's."""
    cfg = t_smoke(ARCH)
    for host in range(n_hosts):
        j = JSyntheticLM(j_smoke(ARCH), JDataConfig(seq, batch, seed=3),
                         host, n_hosts)
        t = SyntheticLM(cfg, DataConfig(seq, batch, seed=3), host, n_hosts)
        for step in range(3):
            jb, tb = j.batch(step), t.batch(step)
            assert list(tb) == list(jb) == ["tokens", "labels",
                                            "audio_embeds"]
            for key in jb:
                assert tb[key].dtype == jb[key].dtype, key
                np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)


def test_train_checkpoint_keys_equal_reference(tmp_path):
    """{"params", "opt"} of the smoke model: the port's checkpoint keys
    (the nested ``enc`` segment included) equal
    ``repro.ft.checkpoint._flatten``'s of the same tree, and a checkpoint
    crosses between the packages both ways bit-equal."""
    _, _, (_, tp) = _models()
    jparams = tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    jtree = {"params": jparams,
             "opt": j_adamw.init(j_adamw.AdamWConfig(), jparams)}
    ttree = {"params": tp, "opt": t_adamw.init(t_adamw.AdamWConfig(), tp)}
    jflat, _ = j_ck._flatten(jtree)
    tflat = t_ck._flatten(ttree)
    assert sorted(tflat) == sorted(jflat)
    assert {"params::enc::seg0_attn_mlp::1::attn::wq",
            "opt::.m::seg0_xattn::0::xattn::wk"} <= set(tflat)
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


def test_params_from_jax_raises_on_unconsumed_leaves():
    _, (_, jp), _ = _models()
    tree = _np(jp)
    tree["enc"]["extra"] = tree["enc"]["ln_f"]
    with pytest.raises(ValueError, match="under enc"):
        params_from_jax(tree, "cpu")
    tree = _np(jp)
    tree["seg0_xattn"]["xattn"]["bias"] = tree["seg0_xattn"]["xattn"]["wq"]
    with pytest.raises(ValueError, match="seg0_xattn/xattn"):
        params_from_jax(tree, "cpu")


ARGS = ["--smoke", "--steps", "3", "--seq", "64", "--batch", "4", "--lr",
        "5e-3", "--data-branch", "2", "--data-docs", "4", "--log-every",
        "1"]


def test_reference_checkpoint_resumes_in_the_port(tmp_path, capsys):
    """The reference's CLI trains 3 steps and checkpoints after steps 2 and
    3 (stacked decoder and encoder segments); the port's CLI resumes from
    step 2 and runs step 3 (index 2) of the same schedule: its loss and
    the state it leaves equal the reference's within 1e-4."""
    ckpt = tmp_path / "ckpt"
    j_loss = j_train_main(["--arch", ARCH, *ARGS, "--ckpt", str(ckpt),
                           "--ckpt-every", "2"])
    shutil.move(str(ckpt / "step_00000003"), str(tmp_path / "jax_final"))
    assert is_jax_checkpoint(ckpt)
    t_loss = t_train_main(["--arch", ARCH, *ARGS, "--device", "cpu",
                           "--ckpt", str(ckpt), "--resume"])
    out = capsys.readouterr().out
    assert "# resumed from step 2" in out, out
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-4, atol=1e-4)

    params = t_build(t_smoke(ARCH), "cpu").init(
        torch.Generator().manual_seed(1))
    like = {"params": params,
            "opt": t_adamw.init(t_adamw.AdamWConfig(), params)}
    got = t_ck.restore(ckpt, like, 3)
    (tmp_path / "j").mkdir()
    shutil.move(str(tmp_path / "jax_final"),
                str(tmp_path / "j" / "step_00000003"))
    want, step = checkpoint_from_jax(tmp_path / "j", like)
    assert step == 3 and got["opt"].step == want["opt"].step == 3
    flat_g, _ = tree_flatten_with_path(got)
    flat_w, _ = tree_flatten_with_path(want)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    assert any(p[:2] == ("params", "enc") for p, _ in flat_g)
    for (path, a), (_, b) in zip(flat_g, flat_w):
        if torch.is_tensor(a):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg="::".join(path))


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
