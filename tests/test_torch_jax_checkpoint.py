"""A train checkpoint written by the reference's CLI (``repro.launch.train
--ckpt``: each segment's layers stacked on a leading axis) resumes in the
port's CLI (``--resume``), through ``convert.checkpoint_from_jax``, for
the smollm smoke model and the kimi-k2 MoE smoke model (whose expert
stacks are stacked ``(n, E, d, f)`` leaves). The step after the resume
matches the reference's: loss within 1e-4, and the parameters and AdamW
moments it leaves within 1e-4 (f32, the same update summed in another
order)."""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_smoke
from repro.ft import checkpoint as j_ck
from repro.launch.train import main as j_main
from repro.models.model import build_model as j_build
from repro.optim import adamw as j_adamw
from repro_torch.configs import get_smoke as t_smoke
from repro_torch.convert import checkpoint_from_jax, is_jax_checkpoint
from repro_torch.ft import checkpoint as t_ck
from repro_torch.launch.train import main as t_main
from repro_torch.models.model import build_model as t_build
from repro_torch.optim import adamw as t_adamw
from repro_torch.tree import tree_flatten_with_path

torch.set_num_threads(2)
ARGS = ["--smoke", "--steps", "3", "--seq", "64", "--batch", "4", "--lr",
        "5e-3", "--data-branch", "2", "--data-docs", "4", "--log-every",
        "1"]


def _like(arch):
    params = t_build(t_smoke(arch), "cpu").init(
        torch.Generator().manual_seed(1))
    return {"params": params,
            "opt": t_adamw.init(t_adamw.AdamWConfig(), params)}


@pytest.mark.parametrize("arch", ["smollm-135m", "kimi-k2-1t-a32b"])
def test_reference_checkpoint_resumes_in_the_port(arch, tmp_path, capsys):
    """The reference trains 3 steps and checkpoints after steps 2 and 3;
    the port resumes from step 2 and runs step 3 (index 2) of the same
    schedule: its loss and the state it leaves equal the reference's."""
    ckpt = tmp_path / "ckpt"
    j_loss = j_main(["--arch", arch, *ARGS, "--ckpt", str(ckpt),
                     "--ckpt-every", "2"])
    shutil.move(str(ckpt / "step_00000003"), str(tmp_path / "jax_final"))
    assert is_jax_checkpoint(ckpt)
    t_loss = t_main(["--arch", arch, *ARGS, "--device", "cpu", "--ckpt",
                     str(ckpt), "--resume"])
    out = capsys.readouterr().out
    assert "# resumed from step 2" in out, out
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-4, atol=1e-4)

    like = _like(arch)
    assert not is_jax_checkpoint(ckpt)        # the port wrote step 3
    got = t_ck.restore(ckpt, like, 3)
    (tmp_path / "j").mkdir()
    shutil.move(str(tmp_path / "jax_final"),
                str(tmp_path / "j" / "step_00000003"))
    want, step = checkpoint_from_jax(tmp_path / "j", like)
    assert step == 3 and got["opt"].step == want["opt"].step == 3
    flat_g, _ = tree_flatten_with_path(got)
    flat_w, _ = tree_flatten_with_path(want)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, a), (_, b) in zip(flat_g, flat_w):
        if torch.is_tensor(a):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg="::".join(path))


def test_checkpoint_from_jax_unstacks_and_checks(tmp_path):
    """Layer i of every stacked leaf (parameters, m, v) lands in layer i of
    the port's tree, the step as an int; an unconsumed key or a depth the
    port's tree does not take raises."""
    arch = "kimi-k2-1t-a32b"
    jm = j_build(j_smoke(arch))
    jp = jm.init(jax.random.PRNGKey(0))
    jopt = j_adamw.init(j_adamw.AdamWConfig(), jp)
    jopt = jopt._replace(m=jax.tree.map(lambda a: a + 1.0, jopt.m),
                         step=jnp.asarray(7, jnp.int32))
    j_ck.save(str(tmp_path / "a"), {"params": jp, "opt": jopt}, 7)
    assert is_jax_checkpoint(tmp_path / "a")
    got, step = checkpoint_from_jax(tmp_path / "a", _like(arch))
    assert step == 7 and got["opt"].step == 7
    w = np.asarray(jp["seg1_attn_moe"]["moe"]["w_in"])       # (2, E, d, f)
    for i in range(2):
        np.testing.assert_array_equal(
            got["params"]["seg1_attn_moe"][i]["moe"]["w_in"].numpy(), w[i])
        np.testing.assert_array_equal(
            got["opt"].m["seg1_attn_moe"][i]["moe"]["w_in"].numpy(),
            np.ones_like(w[i]))

    extra = dict(jp, bogus={"w": jnp.zeros((2,))})
    j_ck.save(str(tmp_path / "b"), {"params": extra, "opt": jopt}, 7)
    with pytest.raises(ValueError, match="unconsumed keys.*bogus"):
        checkpoint_from_jax(tmp_path / "b", _like(arch))
    deeper = j_build(dataclasses.replace(j_smoke(arch), n_layers=4))
    dp = deeper.init(jax.random.PRNGKey(0))
    j_ck.save(str(tmp_path / "c"), {
        "params": dp, "opt": j_adamw.init(j_adamw.AdamWConfig(), dp)}, 1)
    with pytest.raises(ValueError, match="stacks 3 layers"):
        checkpoint_from_jax(tmp_path / "c", _like(arch))
