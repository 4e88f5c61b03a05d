"""Tensor-parallel training of the recurrent, VLM and encoder-decoder
families (recurrentgemma-9b, mamba2-370m, qwen2-vl-2b, whisper-base) on
gloo CPU ranks, f32, against the JAX package and the port's single-device
steps.

* The split functions ``rglru_apply``, ``ssm_apply`` and
  ``cross_attn_apply`` under model groups of 2, 3 and 4 against the
  reference's single-device functions: outputs within 1e-5; input and
  weight gradients, gathered (the whole leaves' shares summed as the
  trainer sums them, ``trainer.sum_model_shares_``), within 1e-4. The SSD
  cases take each of its paths: by heads; whole between split products
  (``w_out`` alone, or both with heads the group does not divide);
  ``w_in`` alone; unsplit.
* ``Model.loss`` and its gathered gradients against JAX's single-device
  loss (1e-6) and gradients (1e-4): the four smokes at 2 model ranks,
  recurrentgemma at 4, mamba2 at 3 (its widths 296 and 128 do not divide
  3: the block runs whole).
* 3 train steps against the port's single-device steps: each smoke at
  model 2, recurrentgemma at data 2 x model 2 and under the FSDP fallback
  there (``w_a`` and ``w_i`` split over data): losses and gathered
  parameters within 1e-4, grad norms within 1e-5, the leaves a rank holds
  whole and the optimizer step bitwise equal across the ranks.
* The CLI at ``--model 2``.

The four archs' placements are held in
``tests/test_torch_tp.py::test_placements_are_the_references``.

Two spawns run on threads while this process compiles the reference's
functions: 4 ranks (their model groups of 2 as a 2 x 2 mesh, and one
group of 4) and 3 ranks (one group of 3). The spawned ranks import this
module, so it imports JAX only inside functions. Every spawn has a
deadline of 120 s.
"""
import dataclasses
import functools
import threading

import numpy as np
import pytest
import torch

from repro_torch.dist.group import DataGroup, Mesh2D, mesh_groups, run_ranks

DEADLINE_S = 120.0
SEQ, BATCH, STEPS = 64, 4, 3
ARCHS = {"recurrentgemma": "recurrentgemma-9b", "mamba2": "mamba2-370m",
         "qwen2vl": "qwen2-vl-2b", "whisper": "whisper-base"}
# a split function's case -> (arch, the block's key, SSMConfig fields or
# config fields replaced); the SSD's paths at 2 / 3 / 4 ranks
# (test_ssm_cases_take_each_path):
# ssm        d_inner 128 (8 heads of 16), w_in 296: heads / unsplit / heads
# ssm_out    1 head of 128, w_in 289: whole / unsplit / whole
# ssm_heads6 d_inner 12 (6 heads of 2), N 1, w_in 32: heads / heads with
#            w_in whole / whole with w_in split
# ssm_in     d_inner 4 (1 head), N 3, w_in 15: whole / w_in alone / whole
FN = {"rglru": ("recurrentgemma-9b", "rec", {}),
      "ssm": ("mamba2-370m", "ssm", {}),
      "ssm_out": ("mamba2-370m", "ssm", {"ssm": dict(
          d_state=16, head_dim=128, chunk=16)}),
      "ssm_heads6": ("mamba2-370m", "ssm", {"d_model": 12, "ssm": dict(
          d_state=1, head_dim=2, expand=1, chunk=16)}),
      "ssm_in": ("mamba2-370m", "ssm", {"d_model": 4, "ssm": dict(
          d_state=3, head_dim=4, expand=1, chunk=16)}),
      "xattn": ("whisper-base", "xattn", {}),
      "xattn_gqa": ("whisper-base", "xattn", {"n_kv_heads": 2})}
# loss case -> the model group sizes it runs at
LOSS = {"recurrentgemma": (2, 4), "mamba2": (2, 3), "qwen2vl": (2,),
        "whisper": (2,)}
# train case -> (arch key, data ranks, fsdp)
TRAIN = {"train_recurrentgemma": ("recurrentgemma", 1, False),
         "train_mamba2": ("mamba2", 1, False),
         "train_qwen2vl": ("qwen2vl", 1, False),
         "train_whisper": ("whisper", 1, False),
         "train_recurrentgemma_data2": ("recurrentgemma", 2, False),
         "train_recurrentgemma_fsdp": ("recurrentgemma", 2, True)}


def _cfg(arch, fields=None, module="torch"):
    if module == "torch":
        from repro_torch.configs import get_smoke
        from repro_torch.configs.base import SSMConfig
    else:
        from repro.configs import get_smoke
        from repro.configs.base import SSMConfig
    fields = dict(fields or {})
    if "ssm" in fields:
        fields["ssm"] = SSMConfig(**fields["ssm"])
    return dataclasses.replace(get_smoke(arch), **fields)


def _batch(cfg, i, module="torch"):
    if module == "torch":
        from repro_torch.data.pipeline import DataConfig, SyntheticLM
    else:
        from repro.data.pipeline import DataConfig, SyntheticLM
    return SyntheticLM(cfg, DataConfig(SEQ, BATCH, seed=0, branch=2,
                                       n_docs=4)).batch(i)


def _flat(tree):
    from repro_torch.tree import tree_leaves
    return [x.detach().float().numpy().copy() for x in tree_leaves(tree)]


def _fn_inputs(case):
    """(x, enc_out or None, the output's cotangent) of a split function's
    case, from numpy."""
    arch, _, fields = FN[case]
    d = _cfg(arch, fields).d_model
    rng = np.random.default_rng(list(FN).index(case))
    x = rng.normal(size=(2, 32, d)).astype(np.float32)
    enc = rng.normal(size=(2, 20, d)).astype(np.float32) \
        if case.startswith("xattn") else None
    return x, enc, rng.normal(size=(2, 32, d)).astype(np.float32)


# ------------------------------------------------------------------ #
# the ranks
# ------------------------------------------------------------------ #
def _split_fn(mg, case, params):
    """One rank's split function of ``case`` on its slices of the whole
    block ``params``: its output, x's (and enc_out's) gradient and the
    gathered parameter gradients, the whole leaves' shares summed."""
    from repro_torch.dist.sharding import mesh_placements
    from repro_torch.models import layers as L
    from repro_torch.models import rglru as RG
    from repro_torch.models import ssm as SSM
    from repro_torch.train.trainer import (gather_params, shard_params,
                                           sum_model_shares_)
    from repro_torch.tree import tree_leaves, tree_map

    arch, block, fields = FN[case]
    cfg = _cfg(arch, fields)
    x, enc, cot = (None if a is None else torch.from_numpy(a)
                   for a in _fn_inputs(case))
    on = Mesh2D(None, mg)
    pl = mesh_placements(params, cfg, model=mg.size,
                         prefix=(f"seg0_{block}", "0", block))
    leaves = tree_map(lambda t: t.detach().requires_grad_(),
                      shard_params(params, pl, on))
    ins = [x.requires_grad_()] + ([] if enc is None
                                  else [enc.requires_grad_()])
    if block == "rec":
        out = RG.rglru_apply(leaves, x, cfg, mg)
    elif block == "ssm":
        out = SSM.ssm_apply(leaves, x, cfg, mg)
    else:
        out = L.cross_attn_apply(leaves, x, enc, cfg, mg)
    g = torch.autograd.grad((out * cot).sum(), ins + tree_leaves(leaves))
    it = iter(g[len(ins):])
    gp = sum_model_shares_(tree_map(lambda _: next(it), leaves), pl, mg)
    return (out.detach().numpy(), [t.numpy() for t in g[:len(ins)]],
            _flat(gather_params(gp, pl, on)))


def _loss_grads(mg, arch, params):
    """``Model.loss`` of ``arch``'s smoke on this rank's slices of
    ``params`` (whole) and its gathered gradients, the whole leaves'
    shares summed."""
    from repro_torch.dist.sharding import mesh_placements
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import (gather_params, shard_params,
                                           sum_model_shares_)
    from repro_torch.tree import tree_leaves, tree_map

    cfg = _cfg(arch)
    model = build_model(cfg, "cpu")
    on = Mesh2D(None, mg)
    pl = mesh_placements(params, cfg, model=mg.size)
    leaves = tree_map(lambda p: p.detach().requires_grad_(),
                      shard_params(params, pl, on))
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, 0).items()}
    loss, _ = model.loss(leaves, batch, model=mg)
    g = torch.autograd.grad(loss, tree_leaves(leaves))
    it = iter(g)
    g = sum_model_shares_(tree_map(lambda _: next(it), leaves), pl, mg)
    return float(loss), _flat(gather_params(g, pl, on))


def _train(arch, params, mesh, fsdp=False):
    """3 train steps of ``arch``'s smoke from the whole ``params``, cut
    here for ``mesh`` (None: one device). Returns the losses, the grad
    norms, the final parameters (gathered) and the bytes of every leaf a
    rank holds whole (parameters and moments) and of the optimizer's
    step."""
    from repro_torch.dist.sharding import mesh_placements
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import Schedule
    from repro_torch.train.trainer import (TrainConfig, gather_params,
                                           make_train_step, shard_params)
    from repro_torch.tree import tree_leaves

    cfg = _cfg(arch)
    model = build_model(cfg, "cpu")
    tc = TrainConfig(optimizer=adamw.AdamWConfig(lr=5e-3),
                     schedule=Schedule(warmup_steps=2, total_steps=STEPS))
    data = None if mesh is None else mesh.data
    mg = None if mesh is None else mesh.model
    p = params
    if mesh is not None:        # whole params: placements in their order
        pl = mesh_placements(params, cfg, data.size if fsdp else 1,
                             mg.size)
        p = shard_params(params, pl, mesh)
    step = make_train_step(model, tc, data=data, model_group=mg, fsdp=fsdp)
    o = adamw.init(tc.optimizer, p)
    losses, norms = [], []
    for i in range(STEPS):
        p, o, met, _ = step(p, o, _batch(cfg, i))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    whole = bytes([o.step])
    if mesh is not None:
        for t in (p, o.m, o.v):
            whole += b"".join(x.numpy().tobytes() for x, s in zip(
                tree_leaves(t), tree_leaves(pl)) if s.whole)
        p = gather_params(p, pl, mesh)
    return dict(losses=losses, norms=norms, params=_flat(p), whole=whole)


def _rank_body(world, fn_params, loss_params, train_params):
    """Every check of one spawn: {model group size: {case: result}}. A
    4-rank world runs the groups of 2 (a 2 x 2 mesh: the single-group
    cases on each data row, the data 2 cases over the mesh) and the group
    of 4; a 3-rank world the group of 3."""
    sizes = (2, 4) if world.size == 4 else (3,)
    meshes = {m: mesh_groups(world, m) for m in sizes}
    out = {}
    for m, mesh in meshes.items():
        mg, res = mesh.model, {}
        for case, params in fn_params.items():
            res[case] = _split_fn(mg, case, params)
        for case, params in loss_params.items():
            if m in LOSS[case]:
                res[case] = _loss_grads(mg, ARCHS[case], params)
        if m == 2:
            for case, (key, d, fsdp) in TRAIN.items():
                res[case] = _train(ARCHS[key], train_params[key],
                                   mesh if d > 1 else Mesh2D(None, mg),
                                   fsdp)
        out[m] = res
    return out


# ------------------------------------------------------------------ #
# the references
# ------------------------------------------------------------------ #
def _np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_fn_params(case):
    """The reference's block parameters of a split function's case
    (numpy)."""
    import jax

    from repro.models import layers as JL
    from repro.models import rglru as JRG
    from repro.models import ssm as JSSM

    arch, block, fields = FN[case]
    cfg = _cfg(arch, fields, "jax")
    init = {"rec": JRG.rglru_init, "ssm": JSSM.ssm_init,
            "xattn": JL.attn_init}[block]
    return _np(init(jax.random.PRNGKey(7), cfg))


@functools.lru_cache(maxsize=None)
def _jax_fn(case):
    """The reference's single-device output and gradients (inputs, then
    the parameters in the port's leaf order) of a split function's
    case."""
    import jax
    import jax.numpy as jnp

    from repro.models import layers as JL
    from repro.models import rglru as JRG
    from repro.models import ssm as JSSM

    arch, block, fields = FN[case]
    cfg = _cfg(arch, fields, "jax")
    x, enc, cot = (None if a is None else jnp.asarray(a)
                   for a in _fn_inputs(case))

    def f(p, x, enc):
        if block == "rec":
            return JRG.rglru_apply(p, x, cfg)
        if block == "ssm":
            return JSSM.ssm_apply(p, x, cfg)
        return JL.cross_attn_apply(p, x, enc, cfg)[0]

    p = jax.tree.map(jnp.asarray, _jax_fn_params(case))
    out, vjp = jax.vjp(f, p, x, enc)
    gp, gx, genc = vjp(cot)
    return (np.asarray(out), [np.asarray(gx)] + (
        [] if enc is None else [np.asarray(genc)]),
        _flat(_torch_tree(_np(gp))))


def _torch_tree(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@functools.lru_cache(maxsize=None)
def _jax_model(key):
    """The reference's smoke model, parameters and the parameters
    converted to the port's layout."""
    import jax

    from repro.models.model import build_model
    from repro_torch.convert import params_from_jax

    jmodel = build_model(_cfg(ARCHS[key], module="jax"))
    jp = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jp, params_from_jax(_np(jp), "cpu")


@functools.lru_cache(maxsize=None)
def _jax_loss(key):
    """The reference's single-device loss and gradients (flat, the port's
    layout) on the batch of step 0."""
    import jax
    import jax.numpy as jnp

    from repro_torch.convert import params_from_jax

    jmodel, jp, _ = _jax_model(key)
    b = {k: jnp.asarray(v) for k, v in
         _batch(_cfg(ARCHS[key], module="jax"), 0, "jax").items()}
    (loss, _), g = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jp, b)
    return float(loss), _flat(params_from_jax(_np(g), "cpu"))


@functools.lru_cache(maxsize=None)
def _single(key):
    """The port's single-device run of :func:`_train`."""
    return _train(ARCHS[key], _jax_model(key)[2], None)


@pytest.fixture(scope="module")
def ranks():
    """{model group size: every rank's results at that size}: both
    spawns run on threads while this process computes the references."""
    fn_params = {c: _torch_tree(_jax_fn_params(c)) for c in FN}
    loss_params = {k: _jax_model(k)[2] for k in LOSS}
    box = {}

    def spawn(n):
        try:
            box[n] = run_ranks(_rank_body, n, backend="gloo", device="cpu",
                               timeout_s=DEADLINE_S,
                               args=(fn_params, loss_params,
                                     loss_params if n == 4 else {}))
        except BaseException as e:          # re-raised below
            box[f"err{n}"] = e

    threads = [threading.Thread(target=spawn, args=(n,)) for n in (4, 3)]
    for t in threads:
        t.start()
    try:
        for case in FN:
            _jax_fn(case)
        for key in LOSS:
            _jax_loss(key)
        for key in ARCHS:
            _single(key)
    finally:
        for t in threads:
            t.join()
    for n in (4, 3):
        if f"err{n}" in box:
            raise box[f"err{n}"]
    out = {}
    for n, sizes in ((4, (2, 4)), (3, (3,))):
        for m in sizes:
            out[m] = [rec[m] for rec in box[n]]
    return out


# ------------------------------------------------------------------ #
# the checks
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("case", list(FN))
def test_split_functions_match_jax(ranks, case, n):
    """Every rank's output within 1e-5 of the reference's single-device
    function; the input gradients and the gathered parameter gradients
    (whole leaves' shares summed) within 1e-4."""
    out, gin, gp = _jax_fn(case)
    for got_out, got_in, got_p in (r[case] for r in ranks[n]):
        np.testing.assert_allclose(got_out, out, rtol=1e-5, atol=1e-5)
        assert len(got_in) == len(gin) and len(got_p) == len(gp)
        for a, b in zip(got_in + got_p, gin + gp):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_ssm_cases_take_each_path():
    """The SSD cases' widths give every path of ``ssm_apply`` at 2, 3 and
    4 ranks: by heads (w_in split or whole), whole between the products
    (w_in split or whole), w_in alone, unsplit."""
    from repro_torch.dist.sharding import split_axes
    from repro_torch.models.ssm import _dims

    paths = {}
    for case in ("ssm", "ssm_out", "ssm_heads6", "ssm_in"):
        cfg = _cfg("mamba2-370m", FN[case][2])
        d_inner, H, N, _ = _dims(cfg)
        for n in (2, 3, 4):
            cut_in = "ffn" in split_axes(cfg, n, 2 * d_inner + 2 * N + H)
            cut_out = "ffn" in split_axes(cfg, n, d_inner)
            paths[case, n] = ("unsplit" if not (cut_in or cut_out) else
                              "in" if not cut_out else
                              ("heads" if H % n == 0 else "whole")
                              + ("" if cut_in else ", w_in whole"))
    assert paths == {
        ("ssm", 2): "heads", ("ssm", 3): "unsplit", ("ssm", 4): "heads",
        ("ssm_out", 2): "whole, w_in whole", ("ssm_out", 3): "unsplit",
        ("ssm_out", 4): "whole, w_in whole",
        ("ssm_heads6", 2): "heads", ("ssm_heads6", 3): "heads, w_in whole",
        ("ssm_heads6", 4): "whole",
        ("ssm_in", 2): "whole, w_in whole", ("ssm_in", 3): "in",
        ("ssm_in", 4): "whole, w_in whole"}


@pytest.mark.parametrize("case,n", [(c, n) for c, ns in LOSS.items()
                                    for n in ns])
def test_loss_and_gathered_grads_match_jax(ranks, case, n):
    loss, grads = _jax_loss(case)
    for got_loss, got in (r[case] for r in ranks[n]):
        np.testing.assert_allclose(got_loss, loss, rtol=1e-6, atol=1e-6)
        assert len(got) == len(grads)
        for a, b in zip(got, grads):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", list(TRAIN))
def test_train_steps_match_the_single_device_steps(ranks, case):
    """3 steps at model 2 (data 2 x model 2, and with fsdp) from the same
    parameters and batches as the port's single-device steps: losses and
    gathered parameters within 1e-4, grad norms within 1e-5; every leaf a
    rank holds whole and the step bitwise equal across the ranks."""
    want = _single(TRAIN[case][0])
    recs = [r[case] for r in ranks[2]]
    for rec in recs:
        np.testing.assert_allclose(rec["losses"], want["losses"], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(rec["norms"], want["norms"], rtol=1e-5,
                                   atol=1e-5)
        assert len(rec["params"]) == len(want["params"])
        for a, b in zip(rec["params"], want["params"]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        assert rec["whole"] == recs[0]["whole"]
        assert rec["losses"] == recs[0]["losses"]


def _fake(cls, n):
    """A group of ``n`` ranks for the placements, which read its size."""
    return cls(None, 0, n, torch.device("cpu"))


def test_recurrent_whole_leaves_are_summed_and_take_the_fsdp_fallback():
    """recurrentgemma's RG-LRU at 2 model ranks: w_in, w_gate_branch and
    w_out split on d_rnn; conv_w, w_a, w_i and lam whole with their
    gradient summed over the model group, conv_w, w_a and w_i split over
    2 data ranks under fsdp (their largest dim); at 3 model ranks (64 does not divide) every leaf
    whole, nothing summed. mamba2's SSD alike."""
    from repro_torch.dist.group import ModelGroup
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import train_placements

    rg = build_model(_cfg("recurrentgemma-9b"), "cpu")
    pl = train_placements(rg, _fake(ModelGroup, 2), _fake(DataGroup, 2),
                          fsdp=True)
    rec = pl["seg0_griffin"][0]["r1"]["rec"]
    assert {k: (s.data, s.model, s.model_sum) for k, s in rec.items()} == {
        "w_in": (None, 1, False), "w_gate_branch": (None, 1, False),
        "w_out": (None, 0, False), "conv_w": (1, None, True),
        "w_a": (0, None, True), "w_i": (0, None, True),
        "lam": (None, None, True)}
    pl3 = train_placements(rg, _fake(ModelGroup, 3))
    rec3 = pl3["seg0_griffin"][0]["r2"]["rec"]
    assert all(s.model is None and not s.model_sum for s in rec3.values())
    mb = build_model(_cfg("mamba2-370m"), "cpu")
    ssm = train_placements(mb, _fake(ModelGroup, 2))["seg0_ssm"][1]["ssm"]
    assert {k for k, s in ssm.items() if s.model_sum} == {
        "conv_w", "A_log", "D", "dt_bias", "norm_scale"}
    assert (ssm["w_in"].model, ssm["w_out"].model) == (1, 0)


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma-7b",
                                  "phi4-mini-3.8b", "granite-3-8b",
                                  "longformer-4k", "recurrentgemma-9b",
                                  "mamba2-370m", "arctic-480b",
                                  "kimi-k2-1t-a32b", "qwen2-vl-2b",
                                  "whisper-base"])
def test_ffn_width_is_the_whole_leafs_dim(arch):
    """Every ffn-labelled dim of an arch's whole leaves
    (``Model.param_shapes``, the published config) is the width
    ``ffn_width`` judges the split on; the placements of a rank's slices
    (``init_shards`` of the smoke at 2 and 4 model ranks) equal those of
    the whole leaves."""
    from repro_torch.configs import get_config
    from repro_torch.dist.group import ModelGroup
    from repro_torch.dist.sharding import (ffn_width, logical_axes_for,
                                           mesh_placements)
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import init_shards
    from repro_torch.tree import tree_flatten_with_path, tree_leaves

    cfg = get_config(arch)
    seen = 0
    for path, leaf in tree_flatten_with_path(
            build_model(cfg, "cpu").param_shapes())[0]:
        p = "/".join(path)
        for i, axis in enumerate(logical_axes_for(p, leaf.dim())):
            if axis == "ffn":
                assert leaf.shape[i] == ffn_width(cfg, p), (p, leaf.shape)
                seen += 1
    assert seen
    smoke = _cfg(arch)
    model = build_model(smoke, "cpu")
    for n in (2, 4):
        if smoke.moe is not None and smoke.moe.n_experts % n:
            continue
        whole = mesh_placements(model.param_shapes(), smoke, model=n)
        cut = init_shards(model, torch.Generator().manual_seed(0),
                          _fake(ModelGroup, n))
        got = mesh_placements(cut, smoke, model=n)
        assert [(s.model, s.model_sum) for s in tree_leaves(got)] == [
            (s.model, s.model_sum) for s in tree_leaves(whole)]


def test_every_arch_and_an_uneven_expert_count_take_a_model_group():
    """Every arch takes a model group of 2 in the step factory (the
    families' blocks run split), and so does an MoE expert count the group
    does not divide, which raised before: kimi's 8 experts at 9 ranks
    stay whole, as the reference's ``_mesh_clean`` keeps them."""
    from repro_torch.configs import ARCHS as ALL
    from repro_torch.configs import get_smoke
    from repro_torch.dist.group import ModelGroup
    from repro_torch.models import moe as M
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import TrainConfig, make_train_step

    def fake(n):
        return ModelGroup(None, 0, n, torch.device("cpu"))

    for arch in ALL:
        make_train_step(build_model(get_smoke(arch), "cpu"), TrainConfig(),
                        model_group=fake(2))
    kimi = get_smoke("kimi-k2-1t-a32b")
    n = kimi.moe.n_experts + 1
    make_train_step(build_model(kimi, "cpu"), TrainConfig(),
                    model_group=fake(n))
    assert M.expert_split(kimi, n) is None


# ------------------------------------------------------------------ #
# the CLI
# ------------------------------------------------------------------ #
CLI = ["--arch", "recurrentgemma-9b", "--smoke", "--device", "cpu", "--seq",
       "32", "--batch", "4", "--lr", "5e-3", "--data-branch", "2",
       "--data-docs", "4", "--log-every", "1", "--steps", "8"]


def _losses(out):
    return {int(line.split()[1]): float(line.split()[3])
            for line in out.splitlines() if line.startswith("step ")}


def test_cli_model_parallel_prints_the_single_rank_losses(capfd):
    """8 recurrentgemma smoke steps at ``--model 2``: every printed loss
    is ``--model 1``'s within 1e-4, and the placements line names the
    RG-LRU's whole leaves whose gradient is summed."""
    from repro_torch.launch.train import main

    one = main(CLI)
    l1 = _losses(capfd.readouterr().out)
    two = main(CLI + ["--model", "2", "--dist-backend", "gloo"])
    out = capfd.readouterr().out
    l2 = _losses(out)
    assert "model=2 (gloo)" in out
    assert "rec/w_a: whole, gradient summed over model" in out
    assert "rec/w_in: split dim 1 over model" in out
    assert sorted(l1) == sorted(l2) == list(range(8))
    for i in l1:
        assert abs(l1[i] - l2[i]) <= 1e-4
    assert abs(one - two) <= 1e-4
