"""Sequence-parallel training of the port against the JAX package, on the
CPU, f32.

* ``shard_plan`` is bit-equal to the reference's on every field (and
  ``stats(16)`` equal) for the reference's sharded families at 2, 4 and 8
  shards.
* The shard-local passes on a ``StackedGroup`` (every shard in one
  process) equal the reference's ``_make_local_fwd`` / ``_make_local_bwd``
  under ``jax.vmap(..., axis_name="seq")``: out/m/l within 1e-5, dq/dk/dv
  within 1e-4, reordered schedules and a dynamic plan included.
* ``_build_views`` / ``_return_views`` are an adjoint pair (f64
  dot-product test).
* The stride exchange of a reordered schedule (dilation > 1, dilated
  sinks): on a ``StackedGroup`` ``to_work`` is the single-device
  ``working_stream`` cut per shard, bit for bit (padding included: the
  "dilated" family pads 128 positions to 256 working slots, so at 4
  shards ranks 2 and 3 hold only padding, and at 2 shards rank 1 does),
  ``from_work`` undoes it, and the pair is an exact adjoint (f64
  dot-product test).
* ``sharded_attention`` on 2- and 4-rank gloo groups equals JAX's
  unsharded ``blockwise_attention`` (and ``dynamic_attention``) within
  1e-4 in the output and the three gradients, reordered schedules
  included.
* ``Model.loss`` under a 2-rank group equals JAX's unsharded loss within
  1e-5 and its gradients within 1e-4, through the sharded route (the
  dense, MoE and recurrent families: recurrentgemma's griffin group with
  its local attention, mamba2's SSD blocks; the smoke smollm at dilation
  2 on the reordered route); 3 train steps under the group give JAX's
  losses within 1e-4 with parameters bitwise equal across the ranks.

The reference's own sharded tests need an 8-device mesh, which fails on
this JAX; its per-shard pieces run under ``jax.vmap`` on one CPU device,
and its unsharded paths are the bar its sharded tests hold. The spawned
ranks import this module, so it imports JAX only inside the functions
that run it. Every spawn has a deadline of 120 s.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import patterns as TP
from repro_torch.core.blockwise import working_stream as t_working_stream
from repro_torch.core.scheduler import build_plan as t_build_plan
from repro_torch.core.scheduler import schedule as t_schedule
from repro_torch.dist import sharded_plan as tspm
from repro_torch.dist.group import SeqGroup, StackedGroup, run_ranks

torch.set_num_threads(2)
DEADLINE_S = 120.0
FWD_TOL = dict(rtol=1e-5, atol=1e-5)      # out, m, l: f32, another order
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)     # the reference's sharded bar
B, D = 2, 16

# The reference's sharded families (tests/test_distributed.py): pattern
# constructor, its arguments, the sequence length, and the shard count of
# the per-shard pass tests (window == n_local needs 8).
FAMILIES = {
    "longformer": ("longformer", (8,), dict(n_global=2), 128, 4),
    "longformer_causal": ("longformer", (8,), dict(n_global=2, causal=True),
                          128, 4),
    "dilated": ("dilated_window", (4, 3), {}, 128, 4),
    "reordered_global": ("causal_sliding_window", (5,),
                         dict(n_sinks=2, dilation=2), 128, 4),
    "vil_2d": ("vil", ((16, 16), (5, 5), 1), {}, 257, 4),
    "vil_73": ("vil", ((8, 9), (3, 5), 1), {}, 73, 2),
    "window_eq_nlocal": ("causal_sliding_window", (16,), {}, 128, 8),
    "sinks": ("causal_sliding_window", (12,), dict(n_sinks=3), 128, 4),
    "g_gt_nlocal": ("causal_sliding_window", (8,), dict(n_sinks=24), 128, 8),
    "g_gt_nlocal_rows": ("longformer", (8,), dict(n_global=24), 128, 8),
    # wider windows, whose tables outgrow the never-drop set at blocks of
    # 16: the dynamic cases
    "sinks_wide": ("causal_sliding_window", (40,), dict(n_sinks=3), 128, 4),
    "longformer_wide": ("longformer", (40,), dict(n_global=2), 128, 4),
    # reordered schedules beside the reference's two: the smoke smollm's
    # attention at dilation 2, and dilated sinks under a dynamic plan
    "smollm_smoke_d2": ("causal_sliding_window", (16,),
                        dict(n_sinks=2, dilation=2), 128, 4),
    "sinks_dilated": ("causal_sliding_window", (8,),
                      dict(n_sinks=4, dilation=2), 128, 4),
}


def _pattern(name, module="torch"):
    ctor, args, kw, _, _ = FAMILIES[name]
    if module == "torch":
        return getattr(TP, ctor)(*args, **kw)
    from repro.core import patterns as JP
    return getattr(JP, ctor)(*args, **kw)


def _plans(name, S, block=None):
    """The port's and the reference's plans and sharded plans, blocks by
    the reference's ``_auto_block`` unless ``block`` is given."""
    from repro.core.scheduler import build_plan as j_build_plan
    from repro.core.scheduler import schedule as j_schedule
    from repro.dist import sharded_plan as jspm

    N = FAMILIES[name][3]
    ts, js = t_schedule(_pattern(name), N), j_schedule(_pattern(name, "jax"),
                                                      N)
    b = block or jspm._auto_block(js.n_work, S, None)
    tplan = t_build_plan(ts, b, b, S * b)
    jplan = j_build_plan(js, b, b, S * b)
    return tspm.shard_plan(tplan, S), jspm.shard_plan(jplan, S)


# ------------------------------------------------------------------ #
# the IR
# ------------------------------------------------------------------ #
ARRAYS = ("tables", "flags", "view_map", "g_owner_idx", "g_owned", "pos_q",
          "pos_k", "t_row_tile", "t_q_blocks", "t_flags")
SCALARS = ("n_shards", "nq_l", "nkb_l", "gtiles", "halo_dists",
           "halo_counts", "halo_real", "view_tiles", "n_gt")


@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_shard_plan_bit_equal_to_jax(name, S):
    tsp, jsp = _plans(name, S)
    for f in SCALARS:
        assert getattr(tsp, f) == getattr(jsp, f), f
    for f in ARRAYS:
        a, b = getattr(tsp, f), np.asarray(getattr(jsp, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f
    assert len(tsp.send_idx) == len(jsp.send_idx)
    for a, b in zip(tsp.send_idx, jsp.send_idx):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tsp.stats(16) == jsp.stats(16)
    assert tspm.shard_plan(tsp.plan, S) is tsp            # lru_cache


def test_shard_plan_rejects_an_indivisible_grid():
    plan = t_build_plan(t_schedule(_pattern("sinks"), 128), 32, 32)
    with pytest.raises(ValueError, match="divisible by n_shards=3"):
        tspm.shard_plan(plan, 3)


@pytest.mark.parametrize("n_work,S,req,want", [
    (128, 8, None, 16), (257, 4, None, 64), (4096, 2, 256, 128),
    (64, 4, 32, 16), (8, 2, None, 8)])
def test_auto_block_matches_jax(n_work, S, req, want):
    from repro.dist.sharded_plan import _auto_block
    assert tspm._auto_block(n_work, S, req) == _auto_block(n_work, S, req) \
        == want


# ------------------------------------------------------------------ #
# the shard-local passes on a StackedGroup
# ------------------------------------------------------------------ #
def _stacked_inputs(name, S, jsp, seed=0):
    """q, k, v, cotangent in the working stream, stacked per shard:
    (S, B, n_local, D) numpy f32."""
    import jax.numpy as jnp

    from repro.core.blockwise import working_stream

    N = FAMILIES[name][3]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(4):
        x = rng.normal(size=(B, N, D)).astype(np.float32)
        w = np.asarray(working_stream(jnp.asarray(x), jsp.plan.sched,
                                      jsp.plan))
        out.append(np.ascontiguousarray(
            w.reshape(B, S, -1, D).transpose(1, 0, 2, 3)))
    return out


def _j_dyn(dyn):
    from repro.core.dynamic import DynamicConfig
    return None if dyn is None else DynamicConfig(**dataclasses.asdict(dyn))


@functools.lru_cache(maxsize=None)
def _jax_local(name, S, block=None, dyn=None):
    """The reference's local forward and backward under ``jax.vmap(...,
    axis_name="seq")`` (jitted: the same arithmetic, compiled once):
    (inputs, (out, m, l), delta, (dq, dk, dv))."""
    import jax

    from repro.dist import sharded_plan as jspm

    _, jsp = _plans(name, S, block)
    qs, ks, vs, dos = _stacked_inputs(name, S, jsp)
    scale = D ** -0.5
    fwd = jax.jit(jax.vmap(jspm._make_local_fwd(
        jsp, "seq", scale, "blockwise", _j_dyn(dyn)), axis_name="seq"))
    out, m, l = (np.asarray(x) for x in fwd(qs, ks, vs))
    delta = (dos * out).sum(-1)
    bwd = jax.jit(jax.vmap(jspm._make_local_bwd(
        jsp, "seq", scale, "blockwise", _j_dyn(dyn)), axis_name="seq"))
    grads = tuple(np.asarray(x) for x in bwd(dos, delta, m, l, qs, ks, vs))
    return (qs, ks, vs, dos), (out, m, l), delta, grads


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.mark.parametrize("name", list(FAMILIES))
def test_local_forward_matches_jax_vmap(name):
    S = FAMILIES[name][4]
    tsp, _ = _plans(name, S)
    (qs, ks, vs, _), want, _, _ = _jax_local(name, S)
    got = tspm._make_local_fwd(tsp, StackedGroup(S), D ** -0.5)(
        *_t(qs, ks, vs))
    for what, a, b in zip(("out", "m", "l"), got, want):
        np.testing.assert_allclose(a.numpy(), b, err_msg=what, **FWD_TOL)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_local_backward_matches_jax_vmap(name):
    S = FAMILIES[name][4]
    tsp, _ = _plans(name, S)
    (qs, ks, vs, dos), (_, m, l), delta, want = _jax_local(name, S)
    got = tspm._make_local_bwd(tsp, StackedGroup(S), D ** -0.5)(
        *_t(dos, delta, m, l, qs, ks, vs))
    for what, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b, err_msg=what, **GRAD_TOL)


# A dynamic plan: blocks of 16 so the candidate tables are wider than the
# never-drop set; keep is that set's worst row, below the table width.
DYN_CASES = {"sinks_wide": 2, "longformer_wide": 2}


def _dyn_cfg(name, S):
    from repro_torch.core.dynamic import DynamicConfig, _resolve_window

    tsp, _ = _plans(name, S, block=16)
    need = int(tspm._sharded_always_keep(
        tsp, _resolve_window(DynamicConfig(keep=1), 16, 16)).sum(-1).max())
    assert need < tsp.tables.shape[2], (need, tsp.tables.shape)
    return DynamicConfig(keep=need)


@pytest.mark.parametrize("name", list(DYN_CASES))
def test_local_passes_dynamic_match_jax_vmap(name):
    S = DYN_CASES[name]
    dyn = _dyn_cfg(name, S)
    tsp, _ = _plans(name, S, block=16)
    (qs, ks, vs, dos), want_f, delta, want_g = _jax_local(name, S, 16, dyn)
    got_f = tspm._make_local_fwd(tsp, StackedGroup(S), D ** -0.5, dyn)(
        *_t(qs, ks, vs))
    for what, a, b in zip(("out", "m", "l"), got_f, want_f):
        np.testing.assert_allclose(a.numpy(), b, err_msg=what, **FWD_TOL)
    got_g = tspm._make_local_bwd(tsp, StackedGroup(S), D ** -0.5, dyn)(
        *_t(dos, delta, want_f[1], want_f[2], qs, ks, vs))
    for what, a, b in zip(("dq", "dk", "dv"), got_g, want_g):
        np.testing.assert_allclose(a.numpy(), b, err_msg=what, **GRAD_TOL)


@pytest.mark.parametrize("name,S", [("longformer", 4), ("vil_2d", 4),
                                    ("g_gt_nlocal_rows", 8)])
def test_exchange_is_an_exact_adjoint_pair(name, S):
    """<build(k, v), (a, b)> == <(k, v), return(a, b)> in f64, padded halo
    slots and global slots included (a padded slot carries the sender's
    local tile 0 forward and its gradient back to it)."""
    tsp, _ = _plans(name, S)
    assert sum(tsp.halo_counts) > 0
    rng = np.random.default_rng(S)
    n_l, n_v = tsp.nkb_l * tsp.plan.block_k, tsp.view_tiles * tsp.plan.block_k
    k, v = _t(*(rng.normal(size=(S, B, n_l, D)) for _ in range(2)))
    a, b = _t(*(rng.normal(size=(S, B, n_v, D)) for _ in range(2)))
    g = StackedGroup(S)
    kv_view = tspm._build_views(tsp, g, k, v)
    dk, dv = tspm._return_views(tsp, g, a, b)
    assert kv_view[0].dtype == dk.dtype == torch.float64
    lhs = float((kv_view[0] * a).sum() + (kv_view[1] * b).sum())
    rhs = float((k * dk).sum() + (v * dv).sum())
    assert abs(lhs - rhs) <= 1e-10 * max(1.0, abs(lhs)), (lhs, rhs)


def test_exchange_fills_padded_halo_slots_with_finite_values():
    """Slots past a shard's need hold what the sender gathered (its local
    tile 0), never uninitialized memory."""
    tsp, _ = _plans("vil_2d", 4)
    assert any(r < sum(tsp.halo_counts) for r in tsp.halo_real)
    S, n_l = 4, tsp.nkb_l * tsp.plan.block_k
    k = torch.full((S, B, n_l, D), float("nan"))
    k[:, :, : tsp.plan.block_k] = 1.0           # only local tile 0 finite
    kv, _ = tspm._build_views(tsp, StackedGroup(S), k, k.clone())
    tiles = kv.reshape(S, B, tsp.view_tiles, tsp.plan.block_k, D)
    n_pad = 0
    for s in range(S):
        pad = np.nonzero(tsp.view_map[s] < 0)[0]
        n_pad += len(pad)
        assert bool(torch.isfinite(tiles[s, :, pad]).all())
    assert n_pad > 0


# ------------------------------------------------------------------ #
# the stride exchange on a StackedGroup
# ------------------------------------------------------------------ #
def _stack(x, S):
    """(B, N, ...) -> (S, B, N / S, ...): every rank's slice."""
    return x.reshape(x.shape[0], S, -1, *x.shape[2:]).transpose(0, 1) \
        .contiguous()


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", ["dilated", "reordered_global",
                                  "smollm_smoke_d2"])
def test_to_work_is_the_working_stream_per_shard(name, S):
    tsp, _ = _plans(name, S)
    N = FAMILIES[name][3]
    rng = np.random.default_rng(S)
    x = torch.from_numpy(rng.normal(size=(B, N, D)).astype(np.float32))
    m = torch.from_numpy(rng.normal(size=(B, N)).astype(np.float32))
    g = StackedGroup(S)
    got_x, = tspm.to_work(tsp, g, _stack(x, S))
    got_m, = tspm.to_work(tsp, g, _stack(m, S))
    for got, full in ((got_x, x), (got_m, m)):
        assert torch.equal(got, _stack(t_working_stream(
            full, tsp.plan.sched, tsp.plan), S))
    back, = tspm.from_work(tsp, g, got_x)
    assert torch.equal(back, _stack(x, S))
    # several tensors of one shape cross in one buffer, each in its type
    a, b = tspm.to_work(tsp, g, _stack(x, S), _stack(x, S).double())
    assert a.dtype == torch.float32 and b.dtype == torch.float64
    assert torch.equal(a, got_x) and torch.equal(b, got_x.double())


def test_stride_exchange_padding_only_ranks():
    """The "dilated" family pads 128 positions to 256 working slots: at 4
    shards ranks 2 and 3, at 2 shards rank 1, receive nothing and send
    their rows to the lower ranks; the splits are uneven."""
    for S, empty in ((4, (2, 3)), (2, (1,))):
        ex = tspm.stride_exchange(_plans("dilated", S)[0].plan, S)
        assert ex.n_in == 128 // S and ex.n_out == 256 // S
        for j in empty:
            assert ex.counts[:, j].sum() == 0
            assert ex.recv_rows[j].size == 0
        assert ex.counts.sum() == 128
        assert sorted(np.concatenate(ex.send_rows).tolist()) == sorted(
            list(range(128 // S)) * S)


@pytest.mark.parametrize("name,S", [("dilated", 4), ("dilated", 2),
                                    ("reordered_global", 4)])
def test_stride_exchange_is_an_exact_adjoint_pair(name, S):
    """<to_work(x), y> == <x, from_work(y)> in f64, padding slots
    included (to_work leaves them zero, from_work drops them)."""
    tsp, _ = _plans(name, S)
    N = FAMILIES[name][3]
    rng = np.random.default_rng(N + S)
    x, y = _t(rng.normal(size=(S, B, N // S, D)),
              rng.normal(size=(S, B, tsp.plan.n_pad // S, D)))
    g = StackedGroup(S)
    xw, = tspm.to_work(tsp, g, x)
    yb, = tspm.from_work(tsp, g, y)
    assert xw.dtype == yb.dtype == torch.float64
    lhs, rhs = float((xw * y).sum()), float((x * yb).sum())
    assert abs(lhs - rhs) <= 1e-10 * max(1.0, abs(lhs)), (lhs, rhs)


# ------------------------------------------------------------------ #
# the op on gloo ranks
# ------------------------------------------------------------------ #
# (pattern name, N, blocks, dynamic keep): causal and bidirectional with
# global rows, global rows spanning shards (g 24 > n_local at 4 ranks),
# window == n_local, a dynamic plan (keep 3 of 5 steps), and the
# reordered schedules: dilation 3 with padding (at 4 ranks ranks 2 and 3
# hold only padding), dilated sinks, and a dynamic plan over dilated
# sinks (keep 4 of up to 5 steps). Blocks None: the port's
# ``_auto_block`` (the one that pads "dilated" to 256), JAX's op at 16.
OP_CASES = {
    "longformer": ("longformer", 128, 16, None),
    "longformer_causal": ("longformer_causal", 128, 16, None),
    "sinks": ("sinks", 128, 16, None),
    "rows_span_shards": ("g_gt_nlocal_rows", 64, 16, None),
    "window_eq_nlocal": ("window_eq_nlocal", 64, 16, None),
    "dynamic": ("sinks_wide", 128, 16, 3),
    "dilated": ("dilated", 128, None, None),
    "reordered_global": ("reordered_global", 128, None, None),
    "dynamic_reordered": ("sinks_dilated", 128, 16, 4),
}


def _op_inputs(case):
    rng = np.random.default_rng(len(case))
    N = OP_CASES[case][1]
    return [rng.normal(size=(B, N, D)).astype(np.float32) for _ in range(4)]


@functools.lru_cache(maxsize=None)
def _jax_op(case):
    """JAX's unsharded op, fwd and the three gradients of sum(out * cot)."""
    import jax
    import jax.numpy as jnp

    from repro.core.blockwise import blockwise_attention
    from repro.core.dynamic import DynamicConfig, dynamic_attention

    name, _, blk, keep = OP_CASES[case]
    pat = _pattern(name, "jax")
    blk = blk or 16
    q, k, v, cot = (jnp.asarray(x) for x in _op_inputs(case))

    def f(a, b, c):
        if keep is None:
            return blockwise_attention(a, b, c, pat, block_q=blk,
                                       block_k=blk)
        return dynamic_attention(a, b, c, pat, DynamicConfig(keep=keep),
                                 block_q=blk, block_k=blk)

    out = jax.jit(f)(q, k, v)
    grads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(f(a, b, c) * cot),
                             argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), tuple(np.asarray(g) for g in grads)


def _op_rank(group, case):
    from repro_torch.core.dynamic import DynamicConfig

    name, N, blk, keep = OP_CASES[case]
    n = N // group.size
    sl = slice(group.index * n, (group.index + 1) * n)
    q, k, v, cot = (torch.from_numpy(x[:, sl].copy()).requires_grad_()
                    for x in _op_inputs(case))
    dyn = None if keep is None else DynamicConfig(keep=keep)
    out = tspm.sharded_attention(q, k, v, _pattern(name), group, block_q=blk,
                                 block_k=blk, dynamic=dyn)
    grads = torch.autograd.grad((out * cot.detach()).sum(), (q, k, v))
    return out.detach().numpy(), [g.numpy() for g in grads]


# ------------------------------------------------------------------ #
# the model and the train step on gloo ranks
# ------------------------------------------------------------------ #
MODELS = ("smollm-135m", "longformer-4k", "recurrentgemma-9b",
          "mamba2-370m", "smollm-135m:dilated")
# The MoE family under a group, in two layouts: "<arch>" routes 16
# dispatch groups of 16 tokens, every group on one shard; "<arch>:cross"
# 2 groups of 128 tokens (two whole sequences), each split over both
# shards (batch 4 > G / n = 1). "<arch>:dilated" has its attention at
# dilation 2 (a reordered schedule).
MOE_ARCHS = ("arctic-480b", "kimi-k2-1t-a32b")
MOE_MODELS = tuple(a + v for a in MOE_ARCHS for v in ("", ":cross"))
SEQ, BATCH, STEPS = 64, 4, 3
# the dilated smollm at seq 128: each rank's working slice is one residue
# class of 64 slots, rank 1's first query block fetches a halo tile from
# rank 0 (at 64 the one halo tile is a global tile), and the sinks land
# in a global tile on each rank
SEQ_OF = {"smollm-135m:dilated": 128}


def _cfg(name, module="torch"):
    """The smoke config of ``name`` (``<arch>``, ``<arch>:cross`` with 2
    dispatch groups, or ``<arch>:dilated``) from the port or the
    reference."""
    from repro_torch.configs import with_dilation
    if module == "torch":
        from repro_torch.configs import get_smoke
    else:
        from repro.configs import get_smoke
    arch, _, variant = name.partition(":")
    cfg = get_smoke(arch)
    if variant == "cross":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch_groups=2))
    if variant == "dilated":
        cfg = with_dilation(cfg, 2)
    return cfg


def _batch(arch, i):
    from repro.data.pipeline import DataConfig, SyntheticLM
    ds = SyntheticLM(_cfg(arch, "jax"), DataConfig(
        SEQ_OF.get(arch, SEQ), BATCH, seed=0, branch=2, n_docs=4))
    return ds.batch(i)


def _tcfg(module):
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
                       schedule=Schedule(**kw))


def _attention_layers(arch) -> int:
    """The attention layers of ``arch``'s smoke program: one a griffin
    group (its local attention), none in an ``ssm`` or ``rec_mlp``
    segment."""
    from repro_torch.models.transformer import ATTN_KINDS, make_program
    return sum(n for kind, n in make_program(_cfg(arch))
               if kind in ATTN_KINDS + ("griffin",))


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    """JAX's unsharded smoke model: the port's parameters converted from
    its init, loss, metrics and grads on batch 0, and 3 train-step
    losses."""
    import jax
    import jax.numpy as jnp

    from repro.models.model import build_model as j_build
    from repro.optim import adamw as j_adamw
    from repro.train.trainer import make_train_step as j_make_step
    from repro_torch.convert import params_from_jax

    jmodel = j_build(_cfg(arch, "jax"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    b0 = {k: jnp.asarray(v) for k, v in _batch(arch, 0).items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(jparams, b0)
    jt = _tcfg("jax")
    step = jax.jit(j_make_step(jmodel, jt))
    p, o, losses = jparams, j_adamw.init(jt.optimizer, jparams), []
    for i in range(STEPS):
        p, o, met, _ = step(p, o, {k: jnp.asarray(v)
                                   for k, v in _batch(arch, i).items()})
        losses.append(float(met["loss"]))
    np_tree = functools.partial(jax.tree.map, np.asarray)
    return dict(params=params_from_jax(np_tree(jparams), "cpu"),
                loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=params_from_jax(np_tree(grads), "cpu"), losses=losses)


@functools.lru_cache(maxsize=None)
def _port_model(arch):
    """The port's unsharded loss and flat gradients on batch 0, from the
    converted reference parameters."""
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_leaves, tree_map

    model = build_model(_cfg(arch), "cpu")
    leaves = tree_map(lambda p: p.clone().requires_grad_(),
                      _jax_model(arch)["params"])
    loss, _ = model.loss(leaves, {k: torch.from_numpy(v)
                                  for k, v in _batch(arch, 0).items()})
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    return float(loss), torch.cat([g.reshape(-1) for g in grads]).numpy()


def _model_rank(group, arch, params):
    from repro_torch.dist import sharded_plan
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import _seq_slice, make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    calls = []
    real = sharded_plan.sharded_attention

    def spy(q, k, v, pattern, *a, **kw):
        calls.append(t_schedule(pattern, q.shape[1] * group.size).reordered)
        return real(q, k, v, pattern, *a, **kw)

    sharded_plan.sharded_attention = spy
    model = build_model(_cfg(arch), "cpu")
    batch = _seq_slice({k: torch.from_numpy(v)
                        for k, v in _batch(arch, 0).items()}, group)
    leaves = tree_map(lambda p: p.clone().requires_grad_(), params)
    loss, metrics = model.loss(leaves, batch, group=group)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    flat = torch.cat([g.reshape(-1) for g in grads])
    group.psum_(flat)
    sharded_plan.sharded_attention = real
    tt = _tcfg("torch")
    step = make_train_step(model, tt, group=group)
    p, o, losses = params, adamw.init(tt.optimizer, params), []
    for i in range(STEPS):
        p, o, met, _ = step(p, o, _batch(arch, i))
        losses.append(float(met["loss"]))
    state = torch.cat([x.reshape(-1) for x in tree_leaves(p)]
                      + [x.reshape(-1) for x in tree_leaves(o.m)]
                      + [x.reshape(-1) for x in tree_leaves(o.v)])
    return dict(loss=float(metrics["loss"]), local=float(loss.detach()),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=flat.numpy(), calls=calls, losses=losses,
                state=state.numpy(), step=o.step)


def _rank_body(group, op_cases, models):
    out = {"op": {c: _op_rank(group, c) for c in op_cases}}
    out["model"] = {a: _model_rank(group, a, p) for a, p in models.items()}
    return out


@pytest.fixture(scope="module")
def ranks():
    """One spawn per group size: S=2 runs every op case and every model
    (the dense, recurrent and MoE families, the MoE in both layouts), S=4
    the op cases."""
    models = {a: _jax_model(a)["params"] for a in MODELS + MOE_MODELS}
    return {S: run_ranks(_rank_body, S, backend="gloo", device="cpu",
                         timeout_s=DEADLINE_S,
                         args=(tuple(OP_CASES), models if S == 2 else {}))
            for S in (2, 4)}


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("case", list(OP_CASES))
def test_sharded_attention_matches_jax_unsharded(ranks, case, S):
    want_out, want_g = _jax_op(case)
    N = OP_CASES[case][1]
    n = N // S
    for r, res in enumerate(ranks[S]):
        out, grads = res["op"][case]
        sl = slice(r * n, (r + 1) * n)
        np.testing.assert_allclose(out, want_out[:, sl], err_msg="out",
                                   **GRAD_TOL)
        for what, a, b in zip("qkv", grads, want_g):
            np.testing.assert_allclose(a, b[:, sl], err_msg=f"d{what}",
                                       **GRAD_TOL)


@pytest.mark.parametrize("arch", MODELS + MOE_MODELS)
def test_model_loss_and_grads_under_group_match_jax(ranks, arch):
    """Loss within 1e-5 (the group's total, on every rank; the ranks'
    local shares add up to it; 1e-4 for the MoE family, with its aux
    metrics the reference's, each counted once over the group),
    gradients summed over the ranks within 1e-4 of JAX's unsharded ones
    (and of the unsharded port's for the MoE family), and the sharded
    route taken once per attention layer and its remat replay (once per
    griffin group's local attention; never in mamba2's program), on the
    reordered route exactly where the attention is dilated)."""
    from repro_torch.tree import tree_leaves

    ref = _jax_model(arch)
    tol = GRAD_TOL if arch in MOE_MODELS else FWD_TOL
    res = [r["model"][arch] for r in ranks[2]]
    for r in res:
        np.testing.assert_allclose(r["loss"], ref["loss"], **tol)
        assert r["calls"] == [arch.endswith(":dilated")] * (
            2 * _attention_layers(arch)), r["calls"]
        assert r["metrics"].keys() == ref["metrics"].keys()
        for key, want in ref["metrics"].items():
            np.testing.assert_allclose(r["metrics"][key], want, **tol,
                                       err_msg=key)
    np.testing.assert_allclose(sum(r["local"] for r in res), ref["loss"],
                               **tol)
    want = np.concatenate([g.reshape(-1).numpy()
                           for g in tree_leaves(ref["grads"])])
    for r in res:
        np.testing.assert_allclose(r["grads"], want, **GRAD_TOL)
        if arch in MOE_MODELS:
            np.testing.assert_allclose(r["grads"], _port_model(arch)[1],
                                       **GRAD_TOL)
    assert res[0]["grads"].tobytes() == res[1]["grads"].tobytes()


@pytest.mark.parametrize("arch", MODELS + MOE_MODELS)
def test_train_steps_under_group_match_jax(ranks, arch):
    """3 steps: losses within 1e-4 of JAX's train step, the parameters and
    the optimizer state bitwise equal on both ranks."""
    ref = _jax_model(arch)
    res = [r["model"][arch] for r in ranks[2]]
    for r in res:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-4,
                                   atol=1e-4)
        assert r["step"] == STEPS
    assert res[0]["state"].tobytes() == res[1]["state"].tobytes()
    assert res[0]["losses"] == res[1]["losses"]


# ------------------------------------------------------------------ #
# what raises
# ------------------------------------------------------------------ #
def _fake_group(S=2):
    """A group object for the argument checks, which raise before any
    collective."""
    return SeqGroup(None, 0, S, torch.device("cpu"))


def test_sharded_attention_needs_a_whole_multiple():
    q = torch.zeros(B, 40, D)                   # N 80, blocks 32: 64 | N?
    with pytest.raises(ValueError, match="multiple of n_shards"):
        tspm.sharded_attention(q, q, q, _pattern("sinks"), _fake_group(),
                               block_q=32, block_k=32)
    with pytest.raises(TypeError, match="SeqGroup"):
        tspm.sharded_attention(q, q, q, _pattern("sinks"), StackedGroup(2))


def test_dense_ref_under_a_group_raises():
    from repro_torch.core.attention import hybrid_attention
    q = torch.zeros(1, 2, 32, D)
    with pytest.raises(ValueError, match="dense_ref"):
        hybrid_attention(q, q, q, _pattern("sinks"), impl="dense_ref",
                         group=_fake_group())


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "whisper-base"])
def test_vlm_and_enc_dec_run_under_a_group(arch):
    """The VLM and encoder-decoder families run ``Model.loss(...,
    group=)`` under a stand-in group of 2 (one process:
    ``launch_lint.RecSeqGroup`` computes each collective as if the other
    rank held this one's tensors): a finite loss, a gradient for every
    leaf, and each decoder layer's halo exchanged forward and back
    (``tests/test_torch_seq_families.py`` holds the numbers on gloo
    ranks)."""
    from repro_torch.analysis import launch_lint as ll
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import _seq_slice
    from repro_torch.tree import tree_leaves, tree_map

    cfg = _cfg(arch)
    log: list = []
    group = ll.rec_group(ll.RecSeqGroup, 2, log)
    model = build_model(cfg, "cpu")
    params = tree_map(lambda p: p.requires_grad_(),
                      model.init(torch.Generator().manual_seed(0)))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        cfg, DataConfig(SEQ, 2, seed=0)).batch(0).items()}
    loss, metrics = model.loss(params, _seq_slice(batch, group), group=group)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert torch.isfinite(loss) and torch.isfinite(metrics["loss"])
    assert all(torch.isfinite(g).all() for g in grads)
    assert ll.check_seq_halos(log, arch, ll.attention_layers(cfg)) == []


def test_a_kind_outside_seq_kinds_raises():
    """Every program of the 11 archs is admitted under a group; a block
    kind outside ``SEQ_KINDS`` (the local-window kind, which runs only
    inside a griffin group) still raises."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.models import transformer as T

    for arch in ARCHS:
        cfg = get_config(arch)
        for kind, _ in T.make_program(cfg):
            T.check_sequence_parallel(cfg, kind, _fake_group())
    assert "attn_mlp_local" not in T.SEQ_KINDS
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, "
                       "'multi-GPU'"):
        T.check_sequence_parallel(_cfg("recurrentgemma-9b"),
                                  "attn_mlp_local", _fake_group())


@pytest.mark.parametrize("arch", ["arctic-480b", "kimi-k2-1t-a32b"])
def test_moe_under_a_group_matches_unsharded(ranks, arch):
    """The MoE family runs under a group: in both layouts (every dispatch
    group on one shard, and groups split over the shards) the group's
    loss and the gradients summed over the ranks are the unsharded port's
    within 1e-4, and so is every rank's dispatch (its dropped share adds
    up)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.model import build_model
    model = build_model(_cfg(arch), "cpu")
    for kind, _ in model.program:
        T.check_sequence_parallel(model.cfg, kind, _fake_group())
    for name in (arch, arch + ":cross"):
        loss, grads = _port_model(name)
        res = [r["model"][name] for r in ranks[2]]
        for r in res:
            np.testing.assert_allclose(r["loss"], loss, **GRAD_TOL)
            np.testing.assert_allclose(r["grads"], grads, **GRAD_TOL)
        np.testing.assert_allclose(
            res[0]["metrics"]["dropped_frac"],
            _jax_model(name)["metrics"]["dropped_frac"], rtol=0, atol=1e-7)


def test_group_of_one_is_the_unsharded_path():
    """A group of size 1 takes the single-device op: equal outputs."""
    from repro_torch.core.attention import hybrid_attention
    rng = np.random.default_rng(0)
    q, k, v = _t(*(rng.normal(size=(1, 2, 64, D)).astype(np.float32)
                   for _ in range(3)))
    a = hybrid_attention(q, k, v, _pattern("sinks"), block_q=32, block_k=32)
    b = hybrid_attention(q, k, v, _pattern("sinks"), block_q=32, block_k=32,
                         group=_fake_group(1))
    assert torch.equal(a, b)
