"""The int8 gradient wire under a model group and under the FSDP
fallback, on gloo CPU ranks, f32.

* The wire's numbers at 2, 3 and 4 model ranks: each rank's int8 values,
  scales, dequantized values and residual (``compression._q8_flat`` and
  ``compress_decompress`` with ``model=``) are bitwise its slices of what
  one rank holding the whole tensors computes. The tree has a layer list
  whose leaves share a scale, a vocab-split head (dim 0), a column-split
  projection (dim 1), expert stacks split over experts, whole leaves that
  every rank holds alike (``Split.model_sum`` leaves after their sum) and
  an all-zero leaf. The whole tensors' int8 values and scales are the
  reference's ``repro.dist.compression._q8`` on its stacked tensors.
* ``compressed_psum_with_residual(..., model=)`` at (data 2, model 2):
  the sum is the slice of the data-2 wire's sum on the whole tensors
  bitwise, within 1e-6 of ``jax.vmap(compressed_psum_with_residual,
  axis_name="data")`` (the order of the sum differs), the residual its
  row bitwise.
* ``compressed_psum_with_residual(..., split=)`` (the FSDP wire) at data
  2 and 4: each rank's sums bitwise its slices of the gather's sums, the
  residual whole and equal, the wire counted: ONE int8 ``all_to_all`` of
  ``(n - 1)(W + F / n)`` received values and one f32 gather of the
  scales.
* 3 train steps of ``make_train_step(..., data=, fsdp=True)`` with
  ``compress_grads`` against the same steps without ``fsdp``, at data 2
  and 4 from the same draw: the losses, each rank's slices of the
  parameters, the leaves held whole and the residual bitwise; and at
  (data 2, model 2) against the data-2 compressed steps, losses within
  1e-4 (TP reorders the gradients' sums, which may flip a value on a
  rounding boundary by one int8 step).
* The CLI: ``--model 2 --compress-grads``, ``--data 2 --model 2
  --compress-grads`` and ``--data 2 --fsdp --compress-grads`` run 3 steps
  with falling losses, the first two within 1e-4 of ``--compress-grads``
  and ``--data 2 --compress-grads``, the third equal to the latter.

One 4-rank spawn runs every rank case (deadline 120 s); the spawned ranks
import this module, so it imports JAX only inside the functions that run
it.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.dist import compression as C
from repro_torch.dist.group import run_ranks

DEADLINE_S = 120.0
LAYERS = 2
# name -> (whole shape, split dim over the model group or None)
TOP = {"head": ((48, 8), 0), "bias": ((36,), None), "zero": ((5, 12), 1)}
PER_LAYER = {"wq": ((8, 24), 1), "experts": ((12, 4, 6), 0),
             "lam": ((24,), None), "w_in": ((24, 12), None)}
STEPS = 3


def _arrays(seed):
    """Seeded f32 whole tensors, a spread of magnitudes: the top-level
    leaves by name, then each per-layer leaf stacked (LAYERS, *shape)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, _) in {**TOP, **{
            k: ((LAYERS, *s), d) for k, (s, d) in PER_LAYER.items()}}.items():
        out[name] = (rng.normal(size=shape)
                     * 10.0 ** rng.integers(-3, 2)).astype(np.float32)
    out["zero"][:] = 0.0
    return out


def _tree(arrs, m=0, n=1):
    """The port's tree of model rank ``m`` of ``n``: each split leaf's
    slice, the whole leaves as they are (copies: ``compress_decompress``
    overwrites its inputs)."""
    def cut(x, d):
        t = torch.tensor(x)
        return t if d is None or n == 1 else \
            t.chunk(n, d)[m].contiguous()
    return {**{k: cut(arrs[k], d) for k, (_, d) in TOP.items()},
            "layers": [{k: cut(arrs[k][i], d)
                        for k, (_, d) in PER_LAYER.items()}
                       for i in range(LAYERS)]}


def _dims():
    """The tree of split dims (None: whole)."""
    return {**{k: d for k, (_, d) in TOP.items()},
            "layers": [{k: d for k, (_, d) in PER_LAYER.items()}
                       for _ in range(LAYERS)]}


def _flat(tree):
    from repro_torch.tree import tree_leaves
    return [x.detach().float().numpy().copy() for x in tree_leaves(tree)]


def _q8(tree, model=None):
    """(int8 values, scales) of the tree's leaves end to end."""
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves(tree)
    ids, n_groups = C.scale_groups(tree)
    _, q, s, _ = C._q8_flat(leaves, torch.tensor(ids), n_groups, model)
    return q.numpy().copy(), s.numpy().copy()


# ------------------------------------------------------------------ #
# the ranks
# ------------------------------------------------------------------ #
def _wire_cases(world):
    """Every wire case on this rank: model groups of 2, 3 and 4 (rank 3
    outside the group of 3), the (data 2, model 2) mesh, the FSDP wire
    at data 2 (the mesh's data groups) and data 4."""
    import torch.distributed as dist

    from repro_torch.dist.group import DataGroup, ModelGroup, mesh_groups

    r, out = world.index, {}
    x, ef = _arrays(1), _arrays(2)
    for n in (2, 3, 4):
        pg = dist.new_group(list(range(n)))
        if r >= n:
            continue
        mg = ModelGroup(pg, r, n, world.device, world.backend)
        q, s = _q8(_tree(x, r, n), mg)
        dq, res = C.compress_decompress(_tree(x, r, n), _tree(ef, r, n),
                                        model=mg)
        out[("model", n)] = dict(q=q, s=s, dq=_flat(dq), res=_flat(res))
    mesh = mesh_groups(world, 2)
    d, m = mesh.data.index, mesh.model.index
    tot, res = C.compressed_psum_with_residual(
        _tree(_arrays(10 + d), m, 2), mesh.data, mesh.model)
    out["mesh"] = dict(tot=_flat(tot), res=_flat(res))
    sent = []
    real = {k: getattr(DataGroup, k) for k in ("all_gather", "all_to_all")}

    def spy(name):
        def call(self, t):
            sent.append((name, str(t.dtype), t.numel()))
            return real[name](self, t)
        return call

    for name in real:
        setattr(DataGroup, name, spy(name))
    try:
        for key, data in (("fsdp2", mesh.data),
                          ("fsdp4", DataGroup.of(world))):
            del sent[:]
            xr = _tree(_arrays(20 + data.index))
            tot, res = C.compressed_psum_with_residual(xr, data,
                                                       split=_dims())
            out[key] = dict(tot=_flat(tot), res=_flat(res),
                            sent=list(sent))
            tot, _ = C.compressed_psum_with_residual(xr, data)
            out[key]["gather"] = _flat(tot)
    finally:
        for name, fn in real.items():
            setattr(DataGroup, name, fn)
    return out


def _smoke(arch="smollm-135m"):
    from repro_torch.configs import get_smoke
    return dataclasses.replace(get_smoke(arch), param_dtype="float32",
                               compute_dtype="float32")


def _tcfg():
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import Schedule
    from repro_torch.train.trainer import TrainConfig
    return TrainConfig(optimizer=adamw.AdamWConfig(lr=5e-3),
                       schedule=Schedule(warmup_steps=2, total_steps=STEPS),
                       compress_grads=True)


def _batch(cfg, i):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    return SyntheticLM(cfg, DataConfig(32, 8, seed=0, branch=2,
                                       n_docs=4)).batch(i)


def _steps(data=None, model_group=None, fsdp=False):
    """3 compressed steps from the seed-0 draw: (losses, params, ef,
    placements or None)."""
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import (init_shards, make_train_step,
                                           train_placements)

    cfg = _smoke()
    model = build_model(cfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    split = fsdp or model_group is not None
    params = init_shards(model, gen, model_group, data, fsdp) if split \
        else model.init(gen)
    opt = adamw.init(_tcfg().optimizer, params)
    step = make_train_step(model, _tcfg(), data=data,
                           model_group=model_group, fsdp=fsdp)
    losses, ef = [], None
    for i in range(STEPS):
        params, opt, metrics, ef = step(params, opt, _batch(cfg, i), ef)
        losses.append(float(metrics["loss"]))
    place = train_placements(model, model_group, data, fsdp) if split \
        else None
    return losses, params, ef, place


def _train_cases(world):
    """The FSDP int8 steps against the data-parallel int8 steps at data
    2 (the mesh's data groups) and 4, and the (data 2, model 2) steps."""
    from repro_torch.dist.group import DataGroup, Mesh2D, mesh_groups
    from repro_torch.train.trainer import shard_params

    mesh = mesh_groups(world, 2)
    out = {}
    for key, data in (("data2", mesh.data), ("data4", DataGroup.of(world))):
        l_dp, p_dp, ef_dp, _ = _steps(data)
        l_fs, p_fs, ef_fs, place = _steps(data, fsdp=True)
        out[key] = dict(
            losses=(l_dp, l_fs),
            params=(_flat(shard_params(p_dp, place, Mesh2D(data, None))),
                    _flat(p_fs)),
            ef=(_flat(ef_dp), _flat(ef_fs)),
            split=sum(s.data is not None for s in _leaves(place)))
    l_tp, p_tp, _, place = _steps(mesh.data, mesh.model)
    l_dp, p_dp, _, _ = _steps(mesh.data)
    out["data2_model2"] = dict(
        losses=(l_dp, l_tp),
        params=(_flat(shard_params(p_dp, place, Mesh2D(None, mesh.model))),
                _flat(p_tp)))
    return out


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def _rank(world):
    return dict(wire=_wire_cases(world), train=_train_cases(world))


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(_rank, 4, backend="gloo", device="cpu",
                     timeout_s=DEADLINE_S)


# ------------------------------------------------------------------ #
# the whole-tensor references
# ------------------------------------------------------------------ #
def _slice_flat(flat, arrs_tree_fn, m, n):
    """The whole tree's flat values ``flat`` (leaf order, end to end)
    cut into model rank ``m``'s slices of ``n``, end to end."""
    whole = arrs_tree_fn()
    out, off = [], 0
    from repro_torch.tree import tree_leaves, tree_map
    dims = tree_leaves(tree_map(lambda d, t: (d, tuple(t.shape)),
                                _dims(), whole))
    for d, shape in dims:
        k = int(np.prod(shape))
        v = flat[off: off + k].reshape(shape)
        off += k
        out.append(v if d is None else np.array_split(v, n, d)[m])
    return out


@pytest.mark.parametrize("n", [2, 3, 4])
def test_model_group_wire_is_the_whole_tensors_slice(ranks, n):
    """int8 values, scales, dequantized values and residual of each rank
    equal the one-rank whole-tensor wire's, sliced, bit for bit."""
    x, ef = _arrays(1), _arrays(2)
    q, s = _q8(_tree(x))
    dq, res = C.compress_decompress(_tree(x), _tree(ef))
    for m in range(n):
        got = ranks[m]["wire"][("model", n)]
        assert got["s"].tobytes() == s.tobytes()
        want_q = _slice_flat(q, lambda: _tree(x), m, n)
        assert got["q"].tobytes() == np.concatenate(
            [w.reshape(-1) for w in want_q]).tobytes()
        for name, whole in (("dq", dq), ("res", res)):
            want = _slice_flat(np.concatenate(
                [w.reshape(-1) for w in _flat(whole)]), lambda: _tree(x),
                m, n)
            for a, b in zip(got[name], want):
                assert a.tobytes() == np.ascontiguousarray(b).tobytes()
    assert ("model", 3) not in ranks[3]["wire"]


def test_whole_tensor_q8_is_the_references():
    """The whole tensors' int8 values and scales are the reference's
    ``_q8`` on its stacked tensors (a layer list's leaves stacked)."""
    import jax.numpy as jnp

    from repro.dist import compression as J

    x = _arrays(1)
    q, s = _q8(_tree(x))
    names = list(TOP) + list(PER_LAYER)
    jq = {k: J._q8(jnp.asarray(x[k])) for k in names}
    assert s.tobytes() == np.asarray(
        [np.asarray(jq[k][1]) for k in names], np.float32).tobytes()
    want = [np.asarray(jq[k][0]) for k in TOP] + [
        np.asarray(jq[k][0])[i] for i in range(LAYERS) for k in PER_LAYER]
    assert q.tobytes() == np.concatenate(
        [w.reshape(-1) for w in want]).tobytes()


@functools.lru_cache(maxsize=None)
def _jax_mesh_psum():
    import jax
    import jax.numpy as jnp

    from repro.dist import compression as J

    names = list(TOP) + list(PER_LAYER)
    per = [_arrays(10 + d) for d in range(2)]
    stacked = {k: jnp.asarray(np.stack([p[k] for p in per])) for k in names}
    pairs = jax.vmap(lambda t: {k: J.compressed_psum_with_residual(v, "data")
                                for k, v in t.items()},
                     axis_name="data")(stacked)
    return [{k: (np.asarray(v[0][d]), np.asarray(v[1][d]))
             for k, v in pairs.items()} for d in range(2)]


def _port_order(per_name):
    """Values by reference name (layers stacked) in the port's leaf
    order."""
    return [per_name[k] for k in TOP] + [
        per_name[k][i] for i in range(LAYERS) for k in PER_LAYER]


def test_mesh_wire_is_the_data_wire_slice_and_the_references(ranks):
    """At (data 2, model 2) each rank's sum is bitwise its slice of the
    data-2 sum over the whole tensors (the same dequantized parts in the
    same order), within 1e-6 of the reference's vmapped psum; its
    residual its data row's, sliced, bit for bit."""
    parts = [C.compress_decompress(_tree(_arrays(10 + d))) for d in range(2)]
    total = [a + b for a, b in zip(_flat(parts[0][0]), _flat(parts[1][0]))]
    jx = _jax_mesh_psum()
    def flat(xs):
        return np.concatenate([v.reshape(-1) for v in xs])

    for r in range(4):
        d, m = r // 2, r % 2
        got = ranks[r]["wire"]["mesh"]
        want_tot = _slice_flat(flat(total), lambda: _tree(_arrays(0)), m, 2)
        want_res = _slice_flat(flat(_flat(parts[d][1])),
                               lambda: _tree(_arrays(0)), m, 2)
        jtot = _slice_flat(flat(_port_order(
            {k: v[0] for k, v in jx[d].items()})), lambda: _tree(_arrays(0)),
            m, 2)
        for a, b, j in zip(got["tot"], want_tot, jtot):
            assert a.tobytes() == np.ascontiguousarray(b).tobytes()
            np.testing.assert_allclose(a, j, rtol=1e-6, atol=1e-6)
        for a, b in zip(got["res"], want_res):
            assert a.tobytes() == np.ascontiguousarray(b).tobytes()


@pytest.mark.parametrize("key,n", [("fsdp2", 2), ("fsdp4", 4)])
def test_fsdp_wire_is_the_gathers_slice(ranks, key, n):
    """The split wire's sums are each rank's slices (along the split
    dims) of the gather wire's sums, bit for bit; the residual is whole;
    one int8 all_to_all and one f32 scale gather cross."""
    dims = [d for d, _ in _leaves_with(_dims())]
    shapes = [tuple(x.shape) for x in _leaves(_tree(_arrays(0)))]
    W = sum(int(np.prod(s)) for s, d in zip(shapes, dims) if d is None)
    F = sum(int(np.prod(s)) for s, d in zip(shapes, dims) if d is not None)
    n_groups = C.scale_groups(_tree(_arrays(0)))[1]
    for r in range(4):
        got = ranks[r]["wire"][key]
        idx = r // 2 if key == "fsdp2" else r
        for a, g, d in zip(got["tot"], got["gather"], dims):
            b = g if d is None else np.array_split(g, n, d)[idx]
            assert a.tobytes() == np.ascontiguousarray(b).tobytes()
        assert [x.shape for x in got["res"]] == shapes
        assert got["sent"] == [("all_to_all", "torch.int8", n * (W + F // n)),
                               ("all_gather", "torch.float32", n_groups)]
        wb = C.wire_bytes(W + F, n_groups, n, split_values=F)
        assert wb["int8_all_to_all"] == (n - 1) * (W + F // n + 4 * n_groups)


def _leaves_with(dims):
    from repro_torch.tree import tree_leaves, tree_map
    return tree_leaves(tree_map(lambda d: (d, None), dims))


@pytest.mark.parametrize("key", ["data2", "data4"])
def test_fsdp_int8_steps_are_the_data_parallel_int8_steps(ranks, key):
    """3 FSDP int8 steps: the losses, every rank's slices of the
    parameters and its whole residual bitwise the data-parallel int8
    steps'; some leaf really splits."""
    for r in range(4):
        got = ranks[r]["train"][key]
        assert got["split"] > 0
        a, b = got["losses"]
        assert a == b and a[-1] < a[0]
        for x, y in zip(*got["params"]):
            assert x.tobytes() == y.tobytes()
        for x, y in zip(*got["ef"]):
            assert x.tobytes() == y.tobytes()


def test_tensor_parallel_int8_steps_follow_the_data_parallel_ones(ranks):
    """(data 2, model 2) int8 steps within 1e-4 of the data-2 int8 steps'
    losses; the parameter slices within one step of the learning rate
    (5e-3): TP reorders the gradients' sums by ~1e-8, which can flip a
    value that sits on a rounding boundary by one int8 step, and AdamW's
    first steps move a parameter by about lr whatever its gradient's
    size; the model ranks' losses equal."""
    for r in range(4):
        got = ranks[r]["train"]["data2_model2"]
        np.testing.assert_allclose(got["losses"][1], got["losses"][0],
                                   rtol=1e-4, atol=1e-4)
        for x, y in zip(*got["params"]):
            np.testing.assert_allclose(y, x, rtol=0, atol=5e-3)
    assert ranks[0]["train"]["data2_model2"]["losses"] == \
        ranks[1]["train"]["data2_model2"]["losses"]


# ------------------------------------------------------------------ #
# the CLI
# ------------------------------------------------------------------ #
CLI = ["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--seq", "32",
       "--batch", "4", "--lr", "5e-3", "--data-branch", "2", "--data-docs",
       "4", "--log-every", "1", "--steps", "3", "--dist-backend", "gloo",
       "--compress-grads"]


def _losses(out):
    return [float(line.split()[3]) for line in out.splitlines()
            if line.startswith("step ")]


@pytest.mark.parametrize("extra,ref,exact", [
    (["--model", "2"], [], False),
    (["--data", "2", "--model", "2"], ["--data", "2"], False),
    (["--data", "2", "--fsdp"], ["--data", "2"], True)])
def test_cli_compress_grads_with_model_and_fsdp(capfd, extra, ref, exact):
    from repro_torch.launch.train import main

    main(CLI + ref)
    want = _losses(capfd.readouterr().out)
    main(CLI + extra)
    out = capfd.readouterr().out
    got = _losses(out)
    assert len(got) == 3 and got[-1] < got[0]
    assert "compress_grads" in out
    if exact:
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
