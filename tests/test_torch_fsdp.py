"""The FSDP fallback of the port (``make_train_step(..., data=, fsdp=True)``,
``--data N --fsdp``) against the reference's rules and the port's own
data-parallel step, on gloo CPU ranks, f32.

* Placements: ``dist.sharding.mesh_placements`` (data dims) against the reference's
  ``param_shardings`` (its ``NamedSharding`` patched to return the spec)
  under ``cell_rules``, for every leaf of the 11 archs' full configs on a
  stand-in ``(data D, model M)`` mesh, D in {2, 4}, M in {1, 2}. Every
  leaf's data dim is the reference's, less the stacked layer axis; the
  1-D per-layer leaves, 2-D in the reference's stacked tree, split there
  and stay whole here (asserted).
* The gather Function (``DataGroup.gather_weight``) at 2 and 4 ranks:
  forward bitwise the whole leaf; backward the f32 sum of the ranks'
  gradients, this rank's slice; with a bf16 slice, the gradient that
  reaches AdamW is f32 and bitwise ``_psum_flat_``'s slice at 2 ranks.
* 3 train steps against the port's ``--data`` step from the same
  (converted reference) parameters: smollm, gemma, whisper (an odd
  vocabulary: the embeddings stay whole), arctic and recurrentgemma at
  data 2, smollm at data 4, with ``microbatches=2`` and under
  ``remat="dots"`` and ``"none"``, gemma and arctic (its experts split
  over the model group) at data 2 x model 2. Losses and gathered
  parameters within 1e-4, ``grad_norm`` within 1e-5, the step-0 loss
  within 1e-6 (rtol and atol, as ``test_torch_tp.py``) of the reference's
  single-device loss on the global batch, the leaves held whole and the
  optimizer step bitwise equal across the ranks, each rank holding only
  its slices of the split leaves and of their moments (and of an f32
  master, in the microbatch case).
* ``init_shards`` under FSDP equals ``shard_params`` of the whole draw.
* Checkpoints: saved at FSDP data 2, bit-equal to the plain ``--data 2``
  file of the same state; restored onto FSDP data 4, plain data and one
  device; a resumed run continues with the uninterrupted run's losses.
* What raises (``compress_grads`` with it no longer does); the CLI at
  ``--data 2 --fsdp`` (and with ``--model 2``).

Two spawns run every rank case, at once, beside the reference's
compiles: 2 ranks (the data-2 cases) and 4 (its data group of 4, its
2 x 2 mesh, the checkpoint moves between them). The spawned ranks import
this module, so it imports JAX only inside the functions that run it.
Each spawn has a deadline of 120 s.
"""
import dataclasses
import functools
import os
import threading
import types

import numpy as np
import pytest
import torch

from repro_torch.dist.group import DataGroup, run_ranks

DEADLINE_S = 120.0
SEQ, BATCH, STEPS = 64, 8, 3
ARCHS = ("smollm-135m", "gemma-7b", "phi4-mini-3.8b", "granite-3-8b",
         "longformer-4k", "recurrentgemma-9b", "mamba2-370m", "arctic-480b",
         "kimi-k2-1t-a32b", "qwen2-vl-2b", "whisper-base")
# case -> (arch, data ranks, model ranks, microbatches, smoke fields)
CASES = {
    "smollm": ("smollm-135m", 2, 1, 1, {}),
    "gemma": ("gemma-7b", 2, 1, 1, {}),
    "whisper_odd_vocab": ("whisper-base", 2, 1, 1, {"vocab_size": 257}),
    "arctic": ("arctic-480b", 2, 1, 1, {}),
    "recurrentgemma": ("recurrentgemma-9b", 2, 1, 1, {}),
    "smollm_data4": ("smollm-135m", 4, 1, 1, {}),
    "smollm_mb2": ("smollm-135m", 2, 1, 2, {}),
    "smollm_remat_dots": ("smollm-135m", 2, 1, 1, {"remat": "dots"}),
    "smollm_remat_none": ("smollm-135m", 2, 1, 1, {"remat": "none"}),
    "gemma_data2_model2": ("gemma-7b", 2, 2, 1, {}),
    "arctic_data2_model2": ("arctic-480b", 2, 2, 1, {}),
}


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


def _tcfg(mb=1, compress=False, master=False):
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import Schedule
    from repro_torch.train.trainer import TrainConfig
    return TrainConfig(optimizer=adamw.AdamWConfig(lr=5e-3,
                                                   use_master=master),
                       schedule=Schedule(warmup_steps=2, total_steps=STEPS),
                       microbatches=mb, compress_grads=compress)


def _flat(tree):
    from repro_torch.tree import tree_leaves
    return [x.detach().float().numpy().copy() for x in tree_leaves(tree)]


def _bytes(*trees):
    from repro_torch.tree import tree_leaves
    return b"".join(x.detach().numpy().tobytes() for t in trees
                    for x in tree_leaves(t))


# ------------------------------------------------------------------ #
# placements against the reference's param_shardings
# ------------------------------------------------------------------ #
@functools.lru_cache(maxsize=None)
def _reference_tree(arch):
    import jax

    from repro.configs import get_config
    from repro.models.model import build_model
    return jax.eval_shape(build_model(get_config(arch)).init,
                          jax.random.PRNGKey(0))


def _reference_data_dims(arch, D, M, monkeypatch):
    """{'/'-joined stacked path: (shape, the dim "data" lands on)} from the
    reference's own ``param_shardings`` under ``cell_rules`` on a
    stand-in (data D, model M) mesh."""
    import jax
    from jax.sharding import PartitionSpec

    from repro.configs import get_config
    from repro.dist import sharding as J
    from repro.launch.specs import cell_rules

    monkeypatch.setattr(J, "NamedSharding", lambda mesh, spec: spec)
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((D, M)))
    cell = types.SimpleNamespace(global_batch=D, seq_len=4096)
    tree = _reference_tree(arch)
    specs = J.param_shardings(tree, mesh, cell_rules(get_config(arch), cell,
                                                     mesh))
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    shapes = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = {}
    for (path, spec), (_, leaf) in zip(flat, shapes):
        dims = [i for i, e in enumerate(spec) if e and "data" in e]
        out[J._path_str(path)] = (tuple(leaf.shape),
                                  dims[0] if dims else None)
    return out


def _stacked(path):
    """Whether a reference path is a stacked segment leaf (a layer axis
    leads): ``seg*`` and the encoder's ``enc/seg*``."""
    return path.split("/")[0].startswith("seg") or \
        path.startswith("enc/seg")


def _port_tree(ref):
    """The port's per-layer tree of ``ref``'s leaves, as meta tensors: a
    stacked segment leaf becomes one leaf per layer, its layer axis
    dropped (the encoder's segment too)."""
    tree = {}
    for p, (shape, _) in ref.items():
        parts = p.split("/")
        seg = 1 if parts[0] == "enc" else 0
        node = tree
        for k in parts[:seg]:
            node = node.setdefault(k, {})
        if parts[seg].startswith("seg"):
            layers = node.setdefault(parts[seg],
                                     [{} for _ in range(shape[0])])
            for layer in layers:
                n = layer
                for k in parts[seg + 1:-1]:
                    n = n.setdefault(k, {})
                n[parts[-1]] = torch.empty(shape[1:], device="meta")
        else:
            for k in parts[seg:-1]:
                node = node.setdefault(k, {})
            node[parts[-1]] = torch.empty(shape, device="meta")
    return tree


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_placements_are_the_references(arch, D, M, monkeypatch):
    """Every leaf's data dim equals the reference's ``param_shardings``',
    less the stacked layer axis. The documented difference: a per-layer
    leaf that is 1-D in the port is 2-D ``(L, d)`` in the reference's
    stacked tree, which splits it (on ``d``, or on ``L`` for mamba2's
    ``(48, 32)`` leaves); the port keeps it whole. No leaf of 2 or more
    per-layer dims splits on the reference's layer axis."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import mesh_placements
    from repro_torch.tree import tree_flatten_with_path, tree_map

    ref = _reference_data_dims(arch, D, M, monkeypatch)
    flat, _ = tree_flatten_with_path(tree_map(
        lambda s: s.data, mesh_placements(_port_tree(ref), get_config(arch),
                                          D, M)))
    port = {}
    for path, dim in flat:
        port.setdefault("/".join(p for p in path if not p.isdigit()),
                        set()).add(dim)
    one_d = split = 0
    for p, (shape, rdim) in ref.items():
        # a leaf whose placement is None is an empty node of the port's
        # placements tree: it is missing from ``port``
        pdim = port.get(p, {None})
        assert len(pdim) == 1, (p, pdim)     # every layer alike
        pdim = pdim.pop()
        if _stacked(p) and len(shape) == 2:
            # the reference's labelling of a 1-D per-layer leaf
            assert rdim == (0 if shape[0] > shape[1] else 1), (p, shape)
            assert shape[rdim] % D == 0 and pdim is None, (p, rdim, pdim)
            one_d += 1
            continue
        if _stacked(p):
            assert rdim != 0, (p, shape)     # never the layer axis
            rdim = None if rdim is None else rdim - 1
        assert pdim == rdim, (p, shape, rdim, pdim)
        split += pdim is not None
    assert one_d > 0 and (split > 0 or M > 1)


def test_fsdp_dim_is_the_largest_dim_where_the_ranks_divide_it():
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import Split, fsdp_dim, mesh_placements

    assert fsdp_dim((576, 576), 2) == 0          # the first on a tie
    assert fsdp_dim((576, 1536), 2) == 1
    assert fsdp_dim((50265, 768), 2) is None     # odd: whole
    assert fsdp_dim((50265, 768), 1) is None     # one rank: no split
    assert fsdp_dim((768,), 2) is None           # 1-D: whole
    cfg = get_config("smollm-135m")
    meta = {"embed": {"w": torch.empty(49152, 576, device="meta")},
            "seg0_attn_mlp": [{"attn": {
                "wq": torch.empty(576, 576, device="meta")}}]}
    # under a model group of 3 smollm's 9 heads split wq: no fsdp there;
    # its 49152-row vocabulary splits over "model" too
    assert mesh_placements(meta, cfg, 2, 3) == {
        "embed": {"w": Split(model=0)},
        "seg0_attn_mlp": [{"attn": {"wq": Split(model=1)}}]}
    assert mesh_placements(meta, cfg, 2) == {
        "embed": {"w": Split(data=0)},
        "seg0_attn_mlp": [{"attn": {"wq": Split(data=0)}}]}


# ------------------------------------------------------------------ #
# the ranks
# ------------------------------------------------------------------ #
def _slot(shard):
    """An f32 zero of ``shard``'s shape to differentiate against (a scalar
    expanded, as the trainer makes it)."""
    return torch.zeros((), requires_grad=True).expand(shard.shape)


def _gather_function(data, seed):
    """``gather_weight`` on an (8, 12) f32 leaf split on each dim, and on a
    bf16 slice: the forward, the f32 gradient of ``sum(w * c_r)`` (c_r
    this rank's cotangent) that reaches ``grad_to``, and, for bf16,
    ``_psum_flat_``'s slice of the same per-rank gradients."""
    from repro_torch.train.trainer import _psum_flat_

    rng = np.random.default_rng(seed)
    whole = torch.from_numpy(rng.normal(size=(8, 12)).astype(np.float32))
    cot = torch.from_numpy(np.random.default_rng(seed + 1 + data.index)
                           .normal(size=(8, 12)).astype(np.float32))
    out = {}
    for dim in (0, 1):
        shard = data.shard(whole, dim)
        slot = _slot(shard)
        w = data.gather_weight(shard, dim, slot)
        (g,) = torch.autograd.grad((w * cot).sum(), (slot,))
        out[dim] = (w.detach().numpy(), g.numpy())
    shard = data.shard(whole, 1).bfloat16()
    slot = _slot(shard)
    w = data.gather_weight(shard, 1, slot)
    (g,) = torch.autograd.grad((w * cot.bfloat16()).sum(), (slot,))
    flat = _psum_flat_({"w": cot.bfloat16().float()}, data)["w"]
    out["bf16"] = (w.dtype, g.dtype, g.numpy(), data.shard(flat, 1).numpy())
    return out


def _train(arch, fields, params, data, mg, mb, fsdp, steps=STEPS):
    """``steps`` train steps of ``arch``'s smoke from ``params`` (whole
    leaves, cut here) on the data group ``data`` (and model group ``mg``),
    with or without ``fsdp``. Returns the losses, the grad norms, the
    final parameters (gathered), the bytes of the leaves a rank holds
    whole and of the step, and whether every split leaf of the parameters,
    the moments and the f32 master (kept by the microbatch case) is this
    rank's slice (by shape)."""
    from repro_torch.dist.group import Mesh2D
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import (gather_params, make_train_step,
                                           shard_params, train_placements)
    from repro_torch.tree import tree_leaves, tree_map

    cfg = _smoke(arch, fields)
    model = build_model(cfg, "cpu")
    tc = _tcfg(mb, master=mb > 1)   # the microbatch case keeps a master
    pl = train_placements(model, mg, data, fsdp)
    mesh = Mesh2D(data, mg)
    p = shard_params(params, pl, mesh)
    step = make_train_step(model, tc, data=data, model_group=mg, fsdp=fsdp)
    o = adamw.init(tc.optimizer, p)
    losses, norms = [], []
    for i in range(steps):
        p, o, met, _ = step(p, o, _batch(cfg, i))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    whole = bytes([o.step])
    sliced = True
    if fsdp:
        # matched by key: the trees' orders may differ
        held = tree_leaves(tree_map(lambda _, s: s.whole, p, pl))
        for t in (p, o.m, o.v):
            whole += b"".join(x.numpy().tobytes() for x, h in zip(
                tree_leaves(t), held) if h)

        def is_slice(x, w, s):
            want = list(w.shape)
            for d, g in ((s.model, mg), (s.data, data)):
                if d is not None:
                    want[d] //= g.size
            return list(x.shape) == want
        for t in (p, o.m, o.v) + (() if o.master is None else (o.master,)):
            sliced &= all(tree_leaves(tree_map(is_slice, t, params, pl)))
    p = gather_params(p, pl, mesh)
    return dict(losses=losses, norms=norms, params=_flat(p), whole=whole,
                sliced=sliced)


def _init_shards(mesh):
    """``init_shards`` under FSDP against ``shard_params`` of the whole
    draw, bitwise: smollm at data 2, gemma and arctic (its experts drawn
    by span) at data 2 x model 2."""
    from repro_torch.dist.group import Mesh2D
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import (init_shards, shard_params,
                                           train_placements)

    out = {}
    for arch, mg in (("smollm-135m", None), ("gemma-7b", mesh.model),
                     ("arctic-480b", mesh.model)):
        model = build_model(_smoke(arch), "cpu")
        got = init_shards(model, torch.Generator().manual_seed(3), mg,
                          mesh.data, fsdp=True)
        whole = model.init(torch.Generator().manual_seed(3))
        want = shard_params(whole, train_placements(model, mg, mesh.data,
                                                    True),
                            Mesh2D(mesh.data, mg))
        out[arch] = _bytes(got) == _bytes(want) and \
            [x.shape for x in _flat(got)] == [x.shape for x in _flat(want)]
    return out


def _ck_state():
    """A smollm-smoke train state on one device: the parameters from a
    seed, the moments random, step 3."""
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_map

    cfg = _smoke("smollm-135m")
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(6)
    rnd = lambda p: torch.randn(p.shape, generator=gen)  # noqa: E731
    opt = adamw.AdamWState(step=3, m=tree_map(rnd, params),
                           v=tree_map(rnd, params), master=None)
    return {"params": params, "opt": opt}


def _checkpoint_moves(world, world_data, mesh, path):
    """The checkpoint cases (each move checked bit for bit against slices
    cut from the whole state): the FSDP data-2 state saved by each column
    of the mesh, the plain state saved by rank 0; restore onto FSDP data 4
    and onto plain data 2, reshard FSDP 2 -> 4 and 2 -> 1."""
    import torch.distributed as dist

    from repro_torch.ft.checkpoint import restore, save
    from repro_torch.ft.manager import reshard
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import state_shardings, train_placements

    state = _ck_state()
    model = build_model(_smoke("smollm-135m"), "cpu")
    col = world.index % 2
    sh = {n: state_shardings(train_placements(model, data=g, fsdp=True),
                             state["opt"])
          for n, g in ((2, mesh.data), (4, world_data))}
    local2 = reshard(state, sh[2], data_group=mesh.data)
    local4 = reshard(state, sh[4], data_group=world_data)
    fsdp_dir = os.path.join(path, f"fsdp_col{col}")
    save(fsdp_dir, local2, 3, shardings=sh[2], data_group=mesh.data)
    if world.index == 0:
        save(os.path.join(path, "plain"), state, 3)
    dist.barrier(group=world.pg)
    out = {}
    out["restore_fsdp4"] = _bytes(restore(
        fsdp_dir, local4, shardings=sh[4], data_group=world_data)["params"],
        local4["opt"].m) == _bytes(local4["params"], local4["opt"].m)
    back = restore(fsdp_dir, state)
    out["restore_plain"] = _bytes(back["params"], back["opt"].v) == \
        _bytes(state["params"], state["opt"].v) and back["opt"].step == 3
    moved = reshard(local2, sh[4], data_group=world_data, current=sh[2],
                    current_data_group=mesh.data)
    out["reshard_2_4"] = _bytes(moved["params"], moved["opt"].v) == \
        _bytes(local4["params"], local4["opt"].v)
    one = reshard(local2, None, current=sh[2], current_data_group=mesh.data)
    out["reshard_2_1"] = _bytes(one["params"], one["opt"].m) == \
        _bytes(state["params"], state["opt"].m)
    out["split"] = (local2["params"]["embed"]["w"].shape[0],
                    local4["opt"].m["seg0_attn_mlp"][0]["mlp"]["w_in"]
                    .shape[1])
    return out


def _resume(data, path, params, uninterrupted):
    """2 FSDP steps of smollm from ``params``, a checkpoint through the
    async ``CheckpointManager``, a restore into a fresh draw and step 2:
    (the step restored, its loss, the uninterrupted run's step-2 loss)."""
    import torch.distributed as dist

    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.dist.group import Mesh2D
    from repro_torch.train.trainer import (make_train_step, shard_params,
                                           state_shardings, train_placements)

    model = build_model(_smoke("smollm-135m"), "cpu")
    tc = _tcfg()
    dims, mesh = train_placements(model, data=data, fsdp=True), \
        Mesh2D(data, None)
    step = make_train_step(model, tc, data=data, fsdp=True)
    p = shard_params(params, dims, mesh)
    o = adamw.init(tc.optimizer, p)
    for i in range(2):
        p, o, _, _ = step(p, o, _batch(model.cfg, i))
    shards = state_shardings(dims, o)
    mgr = CheckpointManager(os.path.join(path, "run"), keep=2)
    mgr.save({"params": p, "opt": o}, 2, shards, data_group=data)
    mgr.wait()
    dist.barrier(group=data.pg)
    fresh = shard_params(model.init(torch.Generator().manual_seed(9)), dims,
                         mesh)
    like = {"params": fresh, "opt": adamw.init(tc.optimizer, fresh)}
    got, at = mgr.restore_latest(like, shards, data_group=data)
    _, _, met, _ = step(got["params"], got["opt"], _batch(model.cfg, at))
    return at, float(met["loss"]), uninterrupted[2]


def _on_pairs(case):
    """Whether a case runs in the 2-rank spawn (data 2, no model group)."""
    _, D, M, _, _ = CASES[case]
    return D == 2 and M == 1


def _rank_body(world, params, path):
    """The rank cases of one spawn. On 2 ranks (one data group): the
    gather Function, the data-2 train cases, the resumed run. On 4 ranks:
    the gather Function over all 4, the data-4 and data 2 x model 2
    train cases on its data group and its 2 x 2 mesh, ``init_shards``
    and the checkpoint moves between data 2 and 4."""
    from repro_torch.dist.group import mesh_groups

    out = {}
    pairs = world.size == 2
    if pairs:
        data = DataGroup.of(world)
        out["gather"] = _gather_function(data, 0)
    else:
        mesh = mesh_groups(world, 2)
        world_data = DataGroup.of(world)
        out["gather"] = _gather_function(world_data, 0)
    for case, (arch, D, M, mb, fields) in CASES.items():
        if _on_pairs(case) != pairs:
            continue
        if not pairs:
            data = mesh.data if D == 2 else world_data
        mg = None if pairs or M == 1 else mesh.model
        out[case] = {fsdp: _train(arch, fields, params[case], data, mg, mb,
                                  fsdp) for fsdp in (False, True)}
    if pairs:
        out["resumed"] = _resume(data, path, params["smollm"],
                                 out["smollm"][True]["losses"])
    else:
        out["init_shards"] = _init_shards(mesh)
        out["ck"] = _checkpoint_moves(world, world_data, mesh, path)
    return out


@functools.lru_cache(maxsize=None)
def _jax_model(arch, fields):
    """The reference's smoke model and parameters, and the parameters
    converted to the port's layout (``fields``: the config's replaced
    fields, as sorted items)."""
    import jax

    from repro.models.model import build_model
    from repro_torch.convert import params_from_jax

    jmodel = build_model(_smoke(arch, dict(fields), "jax"))
    jp = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _jax_params(case):
    arch, _, _, _, fields = CASES[case]
    return _jax_model(arch, tuple(sorted(fields.items())))[2]


@functools.lru_cache(maxsize=None)
def _jax_loss(case):
    """The reference's single-device loss on the global batch of step 0."""
    import jax
    import jax.numpy as jnp

    arch, _, _, _, fields = CASES[case]
    jmodel, jp, _ = _jax_model(arch, tuple(sorted(fields.items())))
    b = {k: jnp.asarray(v) for k, v in
         _batch(_smoke(arch, fields, "jax"), 0, "jax").items()}
    return float(jax.jit(jmodel.loss)(jp, b)[0])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{2: every rank's results of the 2-rank spawn, 4: of the 4-rank
    one}: both spawns run on threads while this process compiles the
    reference's losses."""
    params = {case: _jax_params(case) for case in CASES}
    root = tmp_path_factory.mktemp("fsdp")
    box = {}

    def spawn(n):
        try:
            box[n] = run_ranks(_rank_body, n, backend="gloo", device="cpu",
                               timeout_s=DEADLINE_S,
                               args=(params, str(root / f"world{n}")))
        except BaseException as e:          # re-raised below
            box[f"err{n}"] = e

    threads = [threading.Thread(target=spawn, args=(n,)) for n in (2, 4)]
    for t in threads:
        t.start()
    try:
        for case in CASES:
            _jax_loss(case)
    finally:
        for t in threads:
            t.join()
    for n in (2, 4):
        if f"err{n}" in box:
            raise box[f"err{n}"]
    box["root"] = root
    return box


@pytest.mark.parametrize("n", [2, 4])
def test_gather_function_forward_and_f32_backward(ranks, n):
    """Forward: bitwise the whole leaf on every rank. Backward: the sum of
    the ranks' gradients, this rank's slice, in ``grad_to`` (bitwise at 2
    ranks, whose sum has one order; 1e-6 at 4). A bf16 slice: the
    gradient is f32 and bitwise ``_psum_flat_``'s slice of the same bf16
    gradients at 2 ranks, where the sum rounded to bf16 (what autograd
    would return to the bf16 slice itself) differs."""
    whole = np.random.default_rng(0).normal(size=(8, 12)).astype(np.float32)
    cots = [np.random.default_rng(1 + r).normal(size=(8, 12))
            .astype(np.float32) for r in range(n)]
    total = cots[0].copy()
    for c in cots[1:]:
        total += c
    for r, got in enumerate(ranks[n]):
        rec = got["gather"]
        for dim in (0, 1):
            w, g = rec[dim]
            assert np.array_equal(w, whole)
            want = np.split(total, n, axis=dim)[r]
            if n == 2:
                assert np.array_equal(g, want)
            else:
                np.testing.assert_allclose(g, want, rtol=1e-6, atol=1e-6)
        wdt, gdt, g, flat = rec["bf16"]
        assert wdt == torch.bfloat16 and gdt == torch.float32
        if n == 2:
            assert np.array_equal(g, flat)
            # what autograd would hand a bf16 slice (the sum rounded to
            # bf16) loses bits the f32 slice keeps
            g16 = torch.from_numpy(g).bfloat16().float().numpy()
            assert not np.array_equal(g16, g)


@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_steps_match_the_data_parallel_steps(ranks, case):
    """3 steps under FSDP from the same parameters and batches as the
    port's data-parallel step: losses and gathered parameters within
    1e-4, grad norms within 1e-5, the step-0 loss within 1e-6 of the
    reference's single-device loss on the global batch; the leaves held
    whole and the optimizer step bitwise equal across the ranks, the
    split leaves and their moments this rank's slices."""
    ref_loss = _jax_loss(case)
    recs = [r[case] for r in ranks[2 if _on_pairs(case) else 4]]
    for rec in recs:
        dp, fs = rec[False], rec[True]
        np.testing.assert_allclose(fs["losses"], dp["losses"], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(fs["norms"], dp["norms"], rtol=1e-5,
                                   atol=1e-5)
        assert len(fs["params"]) == len(dp["params"])
        for a, b in zip(fs["params"], dp["params"]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(fs["losses"][0], ref_loss, rtol=1e-6,
                                   atol=1e-6)
        assert fs["losses"][0] == dp["losses"][0]
        assert fs["sliced"]
        assert fs["whole"] == recs[0][True]["whole"]
        assert fs["losses"] == recs[0][True]["losses"]
    assert recs[0][True]["losses"][-1] < recs[0][True]["losses"][0]


def test_init_shards_under_fsdp_is_shard_params_of_the_whole_draw(ranks):
    for rec in ranks[4]:
        assert rec["init_shards"] == {"smollm-135m": True, "gemma-7b": True,
                                      "arctic-480b": True}


@pytest.mark.parametrize("what", ["restore_fsdp4", "restore_plain",
                                  "reshard_2_4", "reshard_2_1"])
def test_fsdp_checkpoint_moves_between_layouts(ranks, what):
    for rec in ranks[4]:
        assert rec["ck"][what] is True
        assert rec["ck"]["split"] == (256 // 2, 96 // 4)


def test_fsdp_checkpoint_is_the_data_parallel_one(ranks):
    """The FSDP data-2 state's file (written by each column's rank 0)
    holds the keys and arrays of the plain ``--data 2`` file of the same
    state, bit for bit."""
    from repro_torch.ft.checkpoint import latest_step

    base = ranks["root"] / "world4"
    plain = np.load(base / "plain" / "step_00000003" / "arrays.npz")
    for col in (0, 1):
        d = base / f"fsdp_col{col}"
        assert latest_step(d) == 3
        got = np.load(d / "step_00000003" / "arrays.npz")
        assert sorted(got.files) == sorted(plain.files)
        for k in plain.files:
            assert np.array_equal(got[k], plain[k]), k


def test_fsdp_resume_continues_the_uninterrupted_losses(ranks):
    for rec in ranks[2]:
        at, loss, want = rec["resumed"]
        assert at == 2 and loss == want


# ------------------------------------------------------------------ #
# what raises, the CLI
# ------------------------------------------------------------------ #
def test_compress_grads_with_fsdp_builds_and_a_seq_group_raises():
    """Nothing raises any more for ``compress_grads`` with ``fsdp``: the
    step builds at data 2 (its int8 wire sums each rank's slices, held
    bitwise to the plain data-parallel int8 step in
    ``tests/test_torch_compress_split.py``), and with one data rank fsdp
    is a no-op, the plain step. A sequence group with a data group still
    raises."""
    from repro_torch.dist.group import SeqGroup
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import make_train_step

    model = build_model(_smoke("smollm-135m"), "cpu")
    data = DataGroup(None, 0, 2, torch.device("cpu"))
    make_train_step(model, _tcfg(compress=True), data=data, fsdp=True)
    make_train_step(model, _tcfg(compress=True),
                    data=DataGroup(None, 0, 1, torch.device("cpu")),
                    fsdp=True)
    with pytest.raises(ValueError, match="not both"):
        make_train_step(model, _tcfg(compress=True), data=data, fsdp=True,
                        group=SeqGroup(None, 0, 2, torch.device("cpu")))


CLI = ["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--seq", "32",
       "--batch", "4", "--lr", "5e-3", "--data-branch", "2", "--data-docs",
       "4", "--log-every", "1", "--steps", "3", "--dist-backend", "gloo"]


def _losses(out):
    return {int(line.split()[1]): float(line.split()[3])
            for line in out.splitlines() if line.startswith("step ")}


def test_cli_fsdp_prints_the_data_parallel_losses(capfd):
    """``--data 2 --fsdp`` (and with ``--model 2``) prints ``--data 2``'s
    losses within 1e-5, and the placements once."""
    from repro_torch.launch.train import main

    plain = main(CLI + ["--data", "2"])
    want = _losses(capfd.readouterr().out)
    assert sorted(want) == [0, 1, 2]
    for extra in ([], ["--model", "2"]):
        got = main(CLI + ["--data", "2", "--fsdp"] + extra)
        out = capfd.readouterr().out
        assert "fsdp" in out.splitlines()[0]
        assert out.count("# placements over 2 data x") == 1
        assert "seg0_attn_mlp/*/attn/wq: split dim 0 over data" in out
        losses = _losses(out)
        assert sorted(losses) == [0, 1, 2]
        for i in want:
            assert abs(losses[i] - want[i]) <= 1e-5
        assert abs(got - plain) <= 1e-5
