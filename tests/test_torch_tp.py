"""Tensor-parallel training of the port (the reference's "model" mesh
axis) against the JAX package, on gloo CPU ranks, f32.

* Placements: ``dist.sharding.mesh_placements`` (model dims) against the reference's
  ``_mesh_clean(resolve(logical_axes_for(...)))`` under ``cell_rules``,
  for every leaf of the full configs of the five dense archs,
  recurrentgemma-9b, mamba2-370m, qwen2-vl-2b and whisper-base at 2, 3
  and 4 model ranks (a stand-in mesh object). Equal everywhere but the
  ffn-labelled leaves of a stacked segment (the MLP's, the RG-LRU's and
  the SSD's), where the reference puts "model" on the stacked layer axis
  whenever the layer count divides it (this test asserts that labelling)
  and the port splits the leaf's own ffn width where it divides.
* Vocab-parallel ``embed_apply`` and ``cross_entropy`` (softcap, a mask,
  a rank holding no gold token) against the reference's single-device
  functions.
* ``Model.loss`` and its gradients, gathered, against JAX's single-device
  loss (1e-6) and gradients (1e-4) on one placement branch each: gemma
  and phi4 smoke at 2 ranks (all split), smollm at 2 (3 / 1 heads:
  attention replicated) and 3 (heads split, KV replicated), longformer
  at 2 with an odd vocabulary (vocab replicated).
* 3 train steps at ``model_group`` 2 and at data 2 x model 2 against the
  port's single-device steps: losses and gathered parameters within
  1e-4, ``grad_norm`` within 1e-5, replicated leaves and the optimizer
  step bitwise equal across the ranks.
* What raises: ``compress_grads`` and a sequence group beside a model
  group. A model group runs every block kind of the 11 archs; only an
  MoE expert count it does not divide raises
  (``tests/test_torch_tp_families.py`` holds the recurrent, VLM and
  encoder-decoder families against the reference).
* The CLI at ``--model 2``.

The spawned ranks import this module, so it imports JAX only inside the
functions that run it. Every spawn has a deadline of 120 s.
"""
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.dist.group import Mesh2D, ModelGroup, run_ranks

DEADLINE_S = 120.0
DENSE = ("smollm-135m", "gemma-7b", "phi4-mini-3.8b", "granite-3-8b",
         "longformer-4k")
# the families whose placements the same test holds
FAMILIES = ("recurrentgemma-9b", "mamba2-370m", "qwen2-vl-2b",
            "whisper-base")
SEQ, BATCH, STEPS = 64, 4, 3
# case -> (arch, model ranks, fields replaced in the smoke config)
CASES = {"gemma": ("gemma-7b", 2, {}), "phi4": ("phi4-mini-3.8b", 2, {}),
         "smollm": ("smollm-135m", 2, {}),
         "smollm_n3": ("smollm-135m", 3, {}),
         "longformer_odd_vocab": ("longformer-4k", 2, {"vocab_size": 257})}
# train case -> (arch, model ranks, data ranks)
TRAIN = {"train_gemma": ("gemma-7b", 2, 1),
         "train_smollm": ("smollm-135m", 2, 1),
         "train_gemma_data2": ("gemma-7b", 2, 2)}


def _smoke(arch, fields=None, module="torch"):
    if module == "torch":
        from repro_torch.configs import get_smoke
    else:
        from repro.configs import get_smoke
    return dataclasses.replace(get_smoke(arch), **(fields or {}))


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


# ------------------------------------------------------------------ #
# placements against the reference's rules
# ------------------------------------------------------------------ #
def _reference_dims(cfg, n):
    """{'/'-joined stacked path: (shape, the dim "model" lands on)} for
    every leaf of the reference's parameter tree (abstract shapes)."""
    import jax

    from repro.dist import sharding as J
    from repro.launch.specs import cell_rules
    from repro.models.model import build_model

    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((1, n)))
    cell = types.SimpleNamespace(global_batch=1, seq_len=4096)
    rules = cell_rules(cfg, cell, mesh)
    tree = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        p = J._path_str(path)
        with J.axis_rules(rules):
            spec = J.resolve(*J.logical_axes_for(p, len(leaf.shape)))
        spec = J._mesh_clean(mesh, spec, leaf.shape)
        dims = [i for i, e in enumerate(spec) if e and "model" in e]
        out[p] = (tuple(leaf.shape), dims[0] if dims else None)
    return out


def _port_tree(ref):
    """The port's per-layer tree of ``ref``'s leaves, as meta tensors: a
    stacked segment leaf becomes one leaf per layer, its layer axis
    dropped."""
    tree = {}
    for p, (shape, _) in ref.items():
        parts = p.split("/")
        seg = next((i for i, k in enumerate(parts) if k.startswith("seg")),
                   None)
        node = tree
        if seg is None:
            for k in parts[:-1]:
                node = node.setdefault(k, {})
            node[parts[-1]] = torch.empty(shape, device="meta")
            continue
        for k in parts[:seg]:           # an encoder's segment: enc/seg0_...
            node = node.setdefault(k, {})
        for layer in node.setdefault(parts[seg],
                                     [{} for _ in range(shape[0])]):
            sub = layer
            for k in parts[seg + 1:-1]:
                sub = sub.setdefault(k, {})
            sub[parts[-1]] = torch.empty(shape[1:], device="meta")
    return tree


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("arch", DENSE + FAMILIES)
def test_placements_are_the_references(arch, n):
    from repro.configs import get_config as j_config
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import mesh_placements
    from repro_torch.tree import tree_flatten_with_path, tree_map

    cfg = get_config(arch)
    ref = _reference_dims(j_config(arch), n)
    flat, _ = tree_flatten_with_path(tree_map(
        lambda s: s.model, mesh_placements(_port_tree(ref), cfg, model=n)))
    port = {}
    for path, dim in flat:
        key = "/".join(p for p in path if not p.isdigit())
        port.setdefault(key, set()).add(dim)
    checked = 0
    for p, (shape, rdim) in ref.items():
        # a leaf whose placement is None is an empty node of the port's
        # placements tree: it is missing from ``port``
        pdim = port.get(p, {None})
        assert len(pdim) == 1, (p, pdim)     # every layer alike
        pdim = pdim.pop()
        stacked = any(k.startswith("seg") for k in p.split("/"))
        leaf = p.rsplit("/", 1)[-1]
        if stacked and leaf in ("w_in", "w_gate", "w_gate_branch", "w_out"):
            # the reference's labelling: the stacked layer axis exactly
            # where the layer count divides the ranks; the port's: the
            # leaf's own ffn width (its last dim, w_out's first)
            assert (rdim == 0) == (shape[0] % n == 0), (p, shape, rdim)
            ffn = 1 if leaf != "w_out" else 0
            if rdim in (0, None):
                want = ffn if shape[1 + ffn] % n == 0 else None
            else:
                want = rdim - 1
            assert pdim == want, (p, pdim, want)
        else:
            assert pdim == (rdim if rdim is None or not stacked
                            else rdim - 1), (p, shape, rdim, pdim)
        checked += 1
    assert checked == len(ref)


# ------------------------------------------------------------------ #
# the ranks
# ------------------------------------------------------------------ #
def _grads(model, params, batch, mg):
    from repro_torch.tree import tree_leaves, tree_map

    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = model.loss(leaves, batch, model=mg)
    g = torch.autograd.grad(loss, tree_leaves(leaves))
    it = iter(g)
    return float(loss), tree_map(lambda _: next(it), params)


VOCAB_CASES = {"softcap": (30.0, False, False), "mask": (30.0, True, False),
               "no_gold": (30.0, False, True),
               "no_softcap": (None, False, False)}


def _vocab_pieces(mg, full_w, tokens, x, targets, mask):
    """Vocab-parallel ``embed_apply``, and ``logits_apply`` then
    ``cross_entropy``, on this rank's slice of the gemma smoke's tied
    embedding ``full_w``: the lookup, and per case of
    :data:`VOCAB_CASES` the loss and its gradients in ``x`` and in the
    rank's embedding rows."""
    from repro_torch.models import layers as L

    n, i = mg.size, mg.index
    w = full_w.chunk(n, 0)[i].clone()
    out = {"embed": L.embed_apply({"w": w}, tokens, _smoke("gemma-7b"),
                                  mg).numpy()}
    for case, (cap, masked, no_gold) in VOCAB_CASES.items():
        cfg = _smoke("gemma-7b", {"logit_softcap": cap})
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        t = targets % (full_w.shape[0] // n) if no_gold else targets
        logits = L.logits_apply({"w": ww}, None, xx, cfg, mg)
        loss = L.cross_entropy(logits, t, mask if masked else None,
                               model=mg)
        gx, gw = torch.autograd.grad(loss, (xx, ww))
        out[case] = (float(loss), gx.numpy(), gw.numpy())
    return out


def _train(arch, params, mesh):
    """3 train steps of ``arch``'s smoke from ``params`` (whole leaves,
    cut here for the mesh's model group; ``mesh`` None: one device).
    Returns the losses, the grad norms, the final parameters (gathered)
    and the bytes of every leaf a rank holds whole (replicated parameters
    and moments) and of the optimizer's step."""
    from repro_torch.dist.sharding import mesh_placements
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import Schedule
    from repro_torch.train.trainer import (TrainConfig, gather_params,
                                           make_train_step, shard_params)
    from repro_torch.tree import tree_leaves

    cfg = _smoke(arch)
    tc = TrainConfig(optimizer=adamw.AdamWConfig(lr=5e-3),
                     schedule=Schedule(warmup_steps=2, total_steps=STEPS))
    data = None if mesh is None else mesh.data
    mg = None if mesh is None else mesh.model
    p = params
    if mg is not None:
        pl = mesh_placements(params, cfg, model=mg.size)
        p = shard_params(params, pl, Mesh2D(None, mg))
    step = make_train_step(build_model(cfg, "cpu"), tc, data=data,
                           model_group=mg)
    o = adamw.init(tc.optimizer, p)
    losses, norms = [], []
    for i in range(STEPS):
        p, o, met, _ = step(p, o, _batch(cfg, i))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    whole = bytes([o.step])
    if mg is not None:
        for t in (p, o.m, o.v):
            whole += b"".join(x.numpy().tobytes() for x, d in zip(
                tree_leaves(t), tree_leaves(pl)) if d.whole)
        p = gather_params(p, pl, Mesh2D(None, mg))
    return dict(losses=losses, norms=norms, params=_flat(p), whole=whole)


def _rank_body(mesh, loss_cases, train_cases, vocab_args):
    """Every check of one mesh: the loss and gathered gradients of each
    ``loss_cases`` entry (its whole parameters), the vocab-parallel
    pieces, the train runs of ``train_cases``."""
    from repro_torch.dist.sharding import mesh_placements
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import gather_params, shard_params

    mg = mesh.model
    out = {}
    for case, params in loss_cases.items():
        arch, _, fields = CASES[case]
        cfg = _smoke(arch, fields)
        pl = mesh_placements(params, cfg, model=mg.size)
        loss, g = _grads(build_model(cfg, "cpu"),
                         shard_params(params, pl, Mesh2D(None, mg)),
                         {k: torch.as_tensor(v) for k, v in
                          _batch(cfg, 0).items()}, mg)
        out[case] = (loss, _flat(gather_params(g, pl,
                                               Mesh2D(None, mg))))
    if vocab_args is not None:
        out["vocab"] = _vocab_pieces(mg, *vocab_args)
    for case, params in train_cases.items():
        arch, _, d = TRAIN[case]
        out[case] = _train(arch, params, mesh if d > 1 else
                           dataclasses.replace(mesh, data=None))
    return out


@functools.lru_cache(maxsize=None)
def _jax(case):
    """The reference's smoke parameters (converted), its single-device
    loss and gradients (the port's layout, flat)."""
    import jax
    import jax.numpy as jnp

    from repro.models.model import build_model
    from repro_torch.convert import params_from_jax

    arch, _, fields = CASES[case]
    cfg = _smoke(arch, fields, "jax")
    jmodel = build_model(cfg)
    jp = jmodel.init(jax.random.PRNGKey(0))
    b = {k: jnp.asarray(v) for k, v in _batch(cfg, 0, "jax").items()}
    (loss, _), g = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jp, b)
    to_np = functools.partial(jax.tree.map, np.asarray)
    return (params_from_jax(to_np(jp), "cpu"), float(loss),
            _flat(params_from_jax(to_np(g), "cpu")))


def _vocab_inputs():
    rng = np.random.default_rng(3)
    full_w = torch.from_numpy(rng.normal(size=(256, 64)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, 256, (2, 9)))
    x = torch.from_numpy(rng.normal(size=(2, 9, 64)).astype(np.float32))
    targets = torch.from_numpy(rng.integers(0, 256, (2, 9)).astype(np.int32))
    mask = torch.from_numpy(rng.random((2, 9)) < 0.6)
    return full_w, tokens, x, targets, mask


def _train_params(arch):
    """The converted reference parameters a train case starts from."""
    return _jax({"gemma-7b": "gemma", "smollm-135m": "smollm"}[arch])[0]


@functools.lru_cache(maxsize=None)
def _single(arch):
    """The port's single-device run of :func:`_train`."""
    return _train(arch, _train_params(arch), None)


@pytest.fixture(scope="module")
def ranks():
    """Two spawns run every case: 4 ranks as a 2 x 2 (data, model) mesh
    (the model-2 cases on each model group, which repeat the work on both
    data rows, and the data 2 x model 2 run), and 3 ranks as one model
    group. Returns {model ranks: every rank's results}."""
    out = {}
    for m, n in ((2, 4), (3, 3)):
        loss_cases = {c: _jax(c)[0] for c, (_, mm, _) in CASES.items()
                      if mm == m}
        train_cases = {c: _train_params(a) for c, (a, mm, _) in
                       TRAIN.items() if mm == m}
        out[m] = run_ranks(_rank_body, n, backend="gloo", device="cpu",
                           timeout_s=DEADLINE_S, model=m,
                           args=(loss_cases, train_cases,
                                 _vocab_inputs() if m == 2 else None))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gathered_grads_match_jax(ranks, case):
    _, loss, grads = _jax(case)
    for rec in ranks[CASES[case][1]]:
        got_loss, got = rec[case]
        np.testing.assert_allclose(got_loss, loss, rtol=1e-6, atol=1e-6)
        assert len(got) == len(grads)
        for a, b in zip(got, grads):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("what", ["embed", *VOCAB_CASES])
def test_vocab_parallel_embed_and_cross_entropy_match_jax(ranks, what):
    """Each rank's lookup equals the reference's bit for bit; its loss is
    the reference's within 1e-6, its gradient in the hidden state the
    whole one and in its embedding rows the reference's rows, 1e-6."""
    import jax
    import jax.numpy as jnp

    from repro.models import layers as JL

    full_w, tokens, x, targets, mask = (a.numpy() for a in _vocab_inputs())
    recs = [r["vocab"] for r in ranks[2]]
    if what == "embed":
        want = np.asarray(JL.embed_apply({"w": jnp.asarray(full_w)},
                                         jnp.asarray(tokens),
                                         _smoke("gemma-7b", module="jax")))
        for rec in recs:
            np.testing.assert_array_equal(rec["embed"], want)
        return
    cap, masked, no_gold = VOCAB_CASES[what]
    cfg = _smoke("gemma-7b", {"logit_softcap": cap}, "jax")
    t = jnp.asarray(targets % 128 if no_gold else targets)
    m = jnp.asarray(mask) if masked else None

    def loss_fn(xx, ww):
        return JL.cross_entropy(JL.logits_apply({"w": ww}, None, xx, cfg), t,
                                m)

    loss, (gx, gw) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(full_w))
    for i, rec in enumerate(recs):
        r = i % 2                   # the rank's place in its model group
        got_loss, got_gx, got_gw = rec[what]
        np.testing.assert_allclose(got_loss, float(loss), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got_gx, np.asarray(gx), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got_gw, np.asarray(gw)[r * 128:
                                                          (r + 1) * 128],
                                   rtol=1e-6, atol=1e-6)
    if no_gold:     # rank 1 held none of the gold tokens
        assert int(np.asarray(t).max()) < 128


@pytest.mark.parametrize("case", list(TRAIN))
def test_train_steps_match_the_single_device_steps(ranks, case):
    """3 steps at model 2 (and data 2 x model 2) from the same parameters
    and batches as the port's single-device steps: losses and gathered
    parameters within 1e-4, grad norms within 1e-5; every leaf a rank
    holds whole (parameters, moments) and the step bitwise equal across
    the ranks."""
    arch, m, _ = TRAIN[case]
    want = _single(arch)
    recs = [r[case] for r in ranks[m]]
    for rec in recs:
        np.testing.assert_allclose(rec["losses"], want["losses"], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(rec["norms"], want["norms"], rtol=1e-5,
                                   atol=1e-5)
        for a, b in zip(rec["params"], want["params"]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        assert rec["whole"] == recs[0]["whole"]
        assert rec["losses"] == recs[0]["losses"]
    assert want["losses"][-1] < want["losses"][0]


# ------------------------------------------------------------------ #
# what raises
# ------------------------------------------------------------------ #
def _fake(n=2):
    """A model group for the checks that raise before any collective."""
    return ModelGroup(None, 0, n, torch.device("cpu"))


@pytest.mark.parametrize("arch", ["arctic-480b", "kimi-k2-1t-a32b"])
def test_moe_families_run_under_a_model_group(arch):
    """The MoE families' blocks pass the checks a model group of 2 makes
    (their experts split over it: ``tests/test_torch_ep.py`` holds them
    against the reference), and the model builds its split forward up to
    the first collective: a group with no process group behind it stops
    there, not at a check."""
    from repro_torch.models.model import build_model

    cfg = _smoke(arch)
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, 0).items()}
    model = build_model(cfg, "cpu")
    with pytest.raises(ValueError, match="process group has not been "
                       "initialized"):
        model.loss(model.init(torch.Generator().manual_seed(0)), batch,
                   model=_fake())


def test_compress_grads_and_a_sequence_group_with_a_model_group_raise():
    from repro_torch.dist.group import SeqGroup
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import TrainConfig, make_train_step

    model = build_model(_smoke("smollm-135m"), "cpu")
    with pytest.raises(NotImplementedError, match="absmax"):
        make_train_step(model, TrainConfig(compress_grads=True),
                        model_group=_fake())
    seq = SeqGroup(None, 0, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="not both"):
        make_train_step(model, TrainConfig(), group=seq, model_group=_fake())
    with pytest.raises(ValueError, match="not both"):
        model.loss(None, {}, group=seq, model=_fake())
    with pytest.raises(TypeError, match="ModelGroup"):
        make_train_step(model, TrainConfig(), model_group=seq)
    # one rank is no group: the plain step
    make_train_step(model, TrainConfig(adamw.AdamWConfig()),
                    model_group=_fake(1))


def test_placement_rules_replicate_what_does_not_divide():
    """phi4-mini's 24 / 8 heads at 3 ranks: wq and wo split, wk and wv
    whole; granite's 12800-wide ffn at 3: the MLP whole; longformer's odd
    vocabulary: the embedding whole."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import leaf_placement, split_axes

    phi = get_config("phi4-mini-3.8b")
    assert split_axes(phi, 3) == {"heads", "vocab"}
    assert [leaf_placement(f"seg0_attn_mlp/0/attn/{w}", 2, phi, 3)
            for w in ("wq", "wk", "wv", "wo")] == [1, None, None, 0]
    assert leaf_placement("seg0_attn_mlp/0/mlp/w_in", 2,
                          get_config("granite-3-8b"), 3) is None
    assert leaf_placement("embed/w", 2, get_config("longformer-4k"),
                          2) is None
    assert split_axes(phi, 1) == frozenset()


# ------------------------------------------------------------------ #
# the CLI
# ------------------------------------------------------------------ #
CLI = ["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--seq", "32",
       "--batch", "4", "--lr", "5e-3", "--data-branch", "2", "--data-docs",
       "4", "--log-every", "1", "--steps", "30"]


def _losses(out):
    return {int(line.split()[1]): float(line.split()[3])
            for line in out.splitlines() if line.startswith("step ")}


def test_cli_model_parallel_prints_the_single_rank_losses(capfd):
    """30 smoke steps at ``--model 2``: the loss falls, and every printed
    loss is ``--model 1``'s within 1e-4; the placements line is
    printed once."""
    from repro_torch.launch.train import main

    one = main(CLI)
    l1 = _losses(capfd.readouterr().out)
    two = main(CLI + ["--model", "2", "--dist-backend", "gloo"])
    out = capfd.readouterr().out
    l2 = _losses(out)
    assert "model=2 (gloo)" in out
    assert out.count("# placements over 2 model ranks") == 1
    assert sorted(l1) == sorted(l2) == list(range(30))
    for i in l1:
        assert abs(l1[i] - l2[i]) <= 1e-4
    assert abs(one - two) <= 1e-4
    assert l2[29] < l2[0] - 0.5, l2
