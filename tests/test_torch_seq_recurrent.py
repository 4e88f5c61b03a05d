"""The recurrent blocks under a sequence group, on gloo CPU ranks, f32,
against the unsharded port and the JAX reference.

Each check runs at S = 2 and S = 4 shards (one module-scoped spawn per
group size runs every case), so the rank-order composition crosses more
than one earlier shard:

* the RG-LRU carry (``_rglru_core(seq=)``: the shard's scan from zero plus
  its running decay times the composed entering state) against the
  unsharded ``linear_scan`` and the reference's ``associative_scan``,
  and each shard's piece against the reference's ``_rglru_core(p, xr,
  h0)`` with ``h0`` the composed entering state;
* the SSD carry (``ssd_chunked(seq=)``) against the unsharded port's and
  the reference's ``ssd_chunked``, sliced, and ``ssd_chunked(s0=)`` in
  one process;
* the conv halo (``SeqGroup.halo``) against the reference's
  ``_causal_conv(state=)``;
* ``rglru_apply(seq=)`` and ``ssm_apply(seq=)`` against the reference's
  blocks on the whole sequence;
* the halo and the summed gather as exact adjoint pairs (f64);
* the errors: a shard of the SSD not a multiple of its chunk, a halo
  wider than a shard.

Tolerances: forward values 1e-5 (abs and rel; the same f32 algorithm
with another association of the scan), gradients 1e-4 (the reference's
gradient bar), the adjoint identities 1e-10 relative in f64. The spawned
ranks import this module, so it imports JAX only inside the functions
that run it. Every spawn has a deadline of 120 s.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.dist.group import SeqGroup, run_ranks

torch.set_num_threads(2)
DEADLINE_S = 120.0
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
SHARDS = (2, 4)
B, T = 2, 48            # the scans and the conv: 24 and 12 rows a shard
DR, W = 16, 4           # RG-LRU channels; the conv's width (halo W - 1)
H, N, P, Q = 3, 4, 5, 4  # SSD heads, state, head dim, chunk
BLOCK_T = 64            # the blocks: a multiple of 4 shards x chunk 16


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _own(x, r, S, axis=1):
    """Shard ``r`` of ``S``'s contiguous slice of ``x`` along ``axis``."""
    n = x.shape[axis] // S
    return np.take(x, range(r * n, (r + 1) * n), axis=axis)


def _inputs():
    """Every case's inputs, numpy f32 (f64 for the adjoint pairs), from
    one seed."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    lam = np.log(np.expm1(-np.log(np.linspace(0.9, 0.999, DR)) / 8.0))
    return dict(
        rg=dict(w_a=(rng.normal(size=(DR, DR)) * 0.3).astype(f32),
                w_i=(rng.normal(size=(DR, DR)) * 0.3).astype(f32),
                lam=lam.astype(f32)),
        xr=rng.normal(size=(B, T, DR)).astype(f32),
        rg_cot=rng.normal(size=(B, T, DR)).astype(f32),
        ssd=(rng.normal(size=(B, T, H, P)).astype(f32),
             rng.normal(size=(B, T, N)).astype(f32),
             rng.normal(size=(B, T, N)).astype(f32),
             (-rng.uniform(0.05, 0.5, size=(B, T, H))).astype(f32)),
        ssd_cot=rng.normal(size=(B, T, H, P)).astype(f32),
        conv=(rng.normal(size=(B, T, 6)).astype(f32),
              (rng.normal(size=(W, 6)) * 0.5).astype(f32)),
        conv_cot=rng.normal(size=(B, T, 6)).astype(f32),
        halo=(rng.normal(size=(B, T, 6)), rng.normal(size=(B, W - 1, 6))),
        gather=(rng.normal(size=(4, 7)),),
        block_x={a: rng.normal(size=(B, BLOCK_T, 64)).astype(f32)
                 for a in ("recurrentgemma-9b", "mamba2-370m")})


# ------------------------------------------------------------------ #
# the ranks
# ------------------------------------------------------------------ #
def _leaf(x, group):
    return torch.from_numpy(_own(x, group.index, group.size).copy()) \
        .requires_grad_()


def _rglru_rank(group, inp):
    """The shard's h, the state the carry composed for it, and the
    gradients of sum(h * cot) for xr's slice and the (summed) gates."""
    from repro_torch.models import rglru as TRG

    carried = []
    real = SeqGroup.carry

    def spy(self, decay, state):
        out = real(self, decay, state)
        carried.append(out.detach().clone())
        return out

    SeqGroup.carry = spy
    try:
        p = {k: _t(v).requires_grad_() for k, v in inp["rg"].items()}
        xr = _leaf(inp["xr"], group)
        h, last = TRG._rglru_core(p, xr, seq=group)
    finally:
        SeqGroup.carry = real
    cot = _t(_own(inp["rg_cot"], group.index, group.size).copy())
    grads = torch.autograd.grad((h * cot).sum(), [xr, *p.values()])
    gp = [group.psum_(g.contiguous().clone()) for g in grads[1:]]
    return dict(h=h.detach().numpy(), last=last.detach().numpy(),
                h_in=carried[0].numpy(), dxr=grads[0].numpy(),
                dp=[g.numpy() for g in gp])


def _ssd_rank(group, inp):
    from repro_torch.models import ssm as TSSM

    leaves = [_leaf(x, group) for x in inp["ssd"]]
    y, s_end, total = TSSM.ssd_chunked(*leaves, Q, seq=group,
                                       return_state=True)
    cot = _t(_own(inp["ssd_cot"], group.index, group.size).copy())
    grads = torch.autograd.grad((y * cot).sum(), leaves)
    return dict(y=y.detach().numpy(), s_end=s_end.detach().numpy(),
                total=total.detach().numpy(),
                grads=[g.numpy() for g in grads])


def _conv_rank(group, inp):
    from repro_torch.models import ssm as TSSM

    x = _leaf(inp["conv"][0], group)
    w = _t(inp["conv"][1])
    halo = group.halo(x, W - 1)
    y, _ = TSSM._causal_conv(x, w, state=halo)
    cot = _t(_own(inp["conv_cot"], group.index, group.size).copy())
    dx, = torch.autograd.grad((y * cot).sum(), [x])
    return dict(y=y.detach().numpy(), halo=halo.detach().numpy(),
                dx=dx.numpy())


def _adjoint_rank(group, inp):
    """<f(x), y> and <x, f^T(y)> on this rank for the halo and the summed
    gather, in f64."""
    x = _leaf(inp["halo"][0], group)
    y = _t(inp["halo"][1]) * (group.index + 1)
    out = group.halo(x, W - 1)
    gx, = torch.autograd.grad(out, [x], y)
    g = _t(inp["gather"][0])
    xg = g[group.index:group.index + 1].clone().requires_grad_()
    yg = g[:group.size] * (group.index + 2) - 1.0
    outg = group.gather(xg, 0, summed=True)
    ggx, = torch.autograd.grad(outg, [xg], yg)
    return dict(halo=(float((out * y).sum()), float((x * gx).sum())),
                gather=(float((outg * yg).sum()), float((xg * ggx).sum())))


def _blocks_rank(group, inp, blocks):
    """``rglru_apply(seq=)`` and ``ssm_apply(seq=)`` on this shard's
    slice, their outputs and the input gradient of sum(out)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import rglru as TRG
    from repro_torch.models import ssm as TSSM

    out = {}
    for arch, params in blocks.items():
        cfg = get_smoke(arch)
        x = _leaf(inp["block_x"][arch], group)
        fn = TRG.rglru_apply if arch == "recurrentgemma-9b" else \
            TSSM.ssm_apply
        y = fn(params, x, cfg, seq=group)
        dx, = torch.autograd.grad(y.sum(), [x])
        out[arch] = (y.detach().numpy(), dx.numpy())
    return out


def _rank_body(group, inp, blocks):
    return dict(rglru=_rglru_rank(group, inp), ssd=_ssd_rank(group, inp),
                conv=_conv_rank(group, inp),
                adjoint=_adjoint_rank(group, inp),
                blocks=_blocks_rank(group, inp, blocks))


@functools.lru_cache(maxsize=None)
def _block_params(arch):
    """The first recurrent block's parameters of the smoke model (the
    RG-LRU of recurrentgemma's first griffin group, mamba2's first SSD
    block), as the reference's (JAX) and the port's (converted)."""
    import jax

    from repro.configs import get_smoke as j_smoke
    from repro.models.model import build_model as j_build
    from repro_torch.convert import params_from_jax

    jp = j_build(j_smoke(arch)).init(jax.random.PRNGKey(0))
    key = next(k for k in jp if k.startswith("seg0_"))
    jblock = jax.tree.map(lambda a: a[0], jp[key])
    tblock = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")[key][0]
    part = "ssm"
    if arch == "recurrentgemma-9b":
        jblock, tblock, part = jblock["r1"], tblock["r1"], "rec"
    return jblock[part], tblock[part]


@pytest.fixture(scope="module")
def ranks():
    inp = _inputs()
    blocks = {a: _block_params(a)[1] for a in inp["block_x"]}
    return inp, {S: run_ranks(_rank_body, S, backend="gloo", device="cpu",
                              timeout_s=DEADLINE_S, args=(inp, blocks))
                 for S in SHARDS}


def _part(recs, part):
    """Every rank's record of one case."""
    return [rec[part] for rec in recs]


def _unsharded_rglru(inp):
    """The port's unsharded h and its gradients of sum(h * cot)."""
    from repro_torch.models import rglru as TRG

    p = {k: _t(v).requires_grad_() for k, v in inp["rg"].items()}
    xr = _t(inp["xr"]).requires_grad_()
    h, _ = TRG._rglru_core(p, xr)
    grads = torch.autograd.grad((h * _t(inp["rg_cot"])).sum(),
                                [xr, *p.values()])
    return h.detach().numpy(), [g.numpy() for g in grads]


def _unsharded_ssd(inp):
    from repro_torch.models import ssm as TSSM

    leaves = [_t(x).requires_grad_() for x in inp["ssd"]]
    y, s_end, total = TSSM.ssd_chunked(*leaves, Q, return_state=True)
    grads = torch.autograd.grad((y * _t(inp["ssd_cot"])).sum(), leaves)
    return y.detach().numpy(), s_end.detach().numpy(), \
        total.detach().numpy(), [g.numpy() for g in grads]


# ------------------------------------------------------------------ #
# the RG-LRU carry
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("S", SHARDS)
def test_rglru_carry_matches_unsharded_scan(ranks, S):
    """Every shard's h (and its last state) equals its slice of the
    unsharded ``linear_scan`` and of the reference's
    ``associative_scan``."""
    import jax.numpy as jnp

    from repro.models import rglru as JRG

    inp, res = ranks
    want, _ = _unsharded_rglru(inp)
    jh, jlast = JRG._rglru_core({k: jnp.asarray(v) for k, v in
                                 inp["rg"].items()}, jnp.asarray(inp["xr"]))
    for r, rec in enumerate(_part(res[S], "rglru")):
        np.testing.assert_allclose(rec["h"], _own(want, r, S), **TOL)
        np.testing.assert_allclose(rec["h"], _own(np.asarray(jh), r, S),
                                   **TOL)
    np.testing.assert_allclose(res[S][-1]["rglru"]["last"],
                               np.asarray(jlast), **TOL)


@pytest.mark.parametrize("S", SHARDS)
def test_rglru_shard_matches_reference_with_entering_state(ranks, S):
    """Each shard's piece is the reference's ``_rglru_core(p, xr, h0)``
    on the shard's slice with ``h0`` the state the carry composed for it
    (zeros on shard 0), and that state is the unsharded state at the
    shard's start."""
    import jax.numpy as jnp

    from repro.models import rglru as JRG

    inp, res = ranks
    want, _ = _unsharded_rglru(inp)
    jp = {k: jnp.asarray(v) for k, v in inp["rg"].items()}
    n = T // S
    for r, rec in enumerate(_part(res[S], "rglru")):
        start = np.zeros((B, DR), np.float32) if r == 0 \
            else want[:, r * n - 1]
        np.testing.assert_allclose(rec["h_in"], start, **TOL)
        jh, _ = JRG._rglru_core(jp, jnp.asarray(_own(inp["xr"], r, S)),
                                jnp.asarray(rec["h_in"]))
        np.testing.assert_allclose(rec["h"], np.asarray(jh), **TOL)


@pytest.mark.parametrize("S", SHARDS)
def test_rglru_carry_gradients_match_unsharded(ranks, S):
    """The gradients through the carry: each shard's slice of dxr, and
    the gates' gradients summed over the shards, equal the unsharded
    scan's."""
    inp, res = ranks
    _, (dxr, *dp) = _unsharded_rglru(inp)
    for r, rec in enumerate(_part(res[S], "rglru")):
        np.testing.assert_allclose(rec["dxr"], _own(dxr, r, S), **GRAD_TOL)
        for a, b in zip(rec["dp"], dp):
            np.testing.assert_allclose(a, b, **GRAD_TOL)


@pytest.mark.parametrize("T_", [1, 2, 13, 64])
def test_linear_scan_running_products(T_):
    """``linear_scan(prods=True)``'s ``P`` is the running product of
    ``a`` (its last pass included), ``h`` the scan without it."""
    from repro_torch.models import rglru as TRG

    g = torch.Generator().manual_seed(T_)
    a = torch.rand((2, T_, 3), generator=g, dtype=torch.float64)
    b = torch.randn((2, T_, 3), generator=g, dtype=torch.float64)
    h, prods = TRG.linear_scan(a, b, prods=True)
    assert torch.equal(h, TRG.linear_scan(a, b))
    torch.testing.assert_close(prods, torch.cumprod(a, dim=1), rtol=1e-12,
                               atol=1e-12)


# ------------------------------------------------------------------ #
# the SSD carry
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("S", SHARDS)
def test_ssd_carry_matches_unsharded(ranks, S):
    """Every shard's y equals its slice of the unsharded port's and of
    the reference's ``ssd_chunked``; the last shard's end state is the
    unsharded end state, and the shards' total log-decays sum to the
    unsharded one."""
    import jax.numpy as jnp

    from repro.models import ssm as JSSM

    inp, res = ranks
    y, s_end, total, _ = _unsharded_ssd(inp)
    jy = np.asarray(JSSM.ssd_chunked(*(jnp.asarray(x) for x in inp["ssd"]),
                                     Q))
    for r, rec in enumerate(_part(res[S], "ssd")):
        np.testing.assert_allclose(rec["y"], _own(y, r, S), **TOL)
        np.testing.assert_allclose(rec["y"], _own(jy, r, S), **TOL)
    np.testing.assert_allclose(res[S][-1]["ssd"]["s_end"], s_end, **TOL)
    np.testing.assert_allclose(
        sum(rec["total"] for rec in _part(res[S], "ssd")), total, **TOL)


@pytest.mark.parametrize("S", SHARDS)
def test_ssd_carry_gradients_match_unsharded(ranks, S):
    """dx, dB, dC and da through the carry: each shard's slice of the
    unsharded gradients."""
    inp, res = ranks
    *_, grads = _unsharded_ssd(inp)
    for r, rec in enumerate(_part(res[S], "ssd")):
        for what, a, b in zip(("x", "B", "C", "a"), rec["grads"], grads):
            np.testing.assert_allclose(a, _own(b, r, S), err_msg=what,
                                       **GRAD_TOL)


@pytest.mark.parametrize("cut", [Q, 5 * Q])
def test_ssd_entering_state_continues_the_sequence(cut):
    """``ssd_chunked(s0=)`` in one process: the sequence cut at a chunk
    boundary, its second part run from the first part's end state, is
    the whole sequence's run (port and reference)."""
    import jax.numpy as jnp

    from repro.models import ssm as JSSM
    from repro_torch.models import ssm as TSSM

    inp = _inputs()
    xs = [_t(x) for x in inp["ssd"]]
    y0, s0, t0 = TSSM.ssd_chunked(*(x[:, :cut] for x in xs), Q,
                                  return_state=True)
    y1, s1, t1 = TSSM.ssd_chunked(*(x[:, cut:] for x in xs), Q, s0=s0,
                                  return_state=True)
    y, s_end, total = TSSM.ssd_chunked(*xs, Q, return_state=True)
    got = torch.cat([y0, y1], dim=1).numpy()
    np.testing.assert_allclose(got, y.numpy(), **TOL)
    jy = np.asarray(JSSM.ssd_chunked(*(jnp.asarray(x) for x in inp["ssd"]),
                                     Q))
    np.testing.assert_allclose(got, jy, **TOL)
    np.testing.assert_allclose(s1.numpy(), s_end.numpy(), **TOL)
    np.testing.assert_allclose((t0 + t1).numpy(), total.numpy(), **TOL)


# ------------------------------------------------------------------ #
# the conv halo and the blocks
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("S", SHARDS)
def test_conv_halo_matches_reference_state(ranks, S):
    """The halo is the previous shard's last W-1 rows (zeros on shard 0),
    the conv over it the reference's ``_causal_conv(state=)`` on the
    shard and the shard's slice of the unsharded conv; the gradient is
    the unsharded conv's."""
    import jax.numpy as jnp

    from repro.models import ssm as JSSM
    from repro_torch.models import ssm as TSSM

    inp, res = ranks
    x, w = inp["conv"]
    n = T // S
    xt = _t(x).requires_grad_()
    y, _ = TSSM._causal_conv(xt, _t(w))
    dx, = torch.autograd.grad((y * _t(inp["conv_cot"])).sum(), [xt])
    for r, rec in enumerate(_part(res[S], "conv")):
        prev = np.zeros((B, W - 1, x.shape[2]), np.float32) if r == 0 \
            else x[:, r * n - (W - 1):r * n]
        np.testing.assert_array_equal(rec["halo"], prev)
        jy, _ = JSSM._causal_conv(jnp.asarray(_own(x, r, S)),
                                  jnp.asarray(w), state=jnp.asarray(prev))
        np.testing.assert_allclose(rec["y"], np.asarray(jy), **TOL)
        np.testing.assert_allclose(rec["y"], _own(y.detach().numpy(), r, S),
                                   **TOL)
        np.testing.assert_allclose(rec["dx"], _own(dx.numpy(), r, S),
                                   **GRAD_TOL)


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-370m"])
def test_block_under_group_matches_reference(ranks, arch, S):
    """``rglru_apply(seq=)`` / ``ssm_apply(seq=)`` on each shard: its
    slice of the reference's block on the whole sequence (the halo, the
    conv, the scan's carry, the gating), and the input gradient of
    sum(out) the unsharded port's slice."""
    import jax.numpy as jnp

    from repro.configs import get_smoke as j_smoke
    from repro.models import rglru as JRG
    from repro.models import ssm as JSSM
    from repro_torch.configs import get_smoke
    from repro_torch.models import rglru as TRG
    from repro_torch.models import ssm as TSSM

    inp, res = ranks
    jp, tp = _block_params(arch)
    x = inp["block_x"][arch]
    jfn, tfn = (JRG.rglru_apply, TRG.rglru_apply) \
        if arch == "recurrentgemma-9b" else (JSSM.ssm_apply, TSSM.ssm_apply)
    want = np.asarray(jfn(jp, jnp.asarray(x), j_smoke(arch)))
    xt = _t(x).requires_grad_()
    dx, = torch.autograd.grad(tfn(tp, xt, get_smoke(arch)).sum(), [xt])
    for r, rec in enumerate(res[S]):
        y, gx = rec["blocks"][arch]
        np.testing.assert_allclose(y, _own(want, r, S), **TOL)
        np.testing.assert_allclose(gx, _own(dx.numpy(), r, S), **GRAD_TOL)


# ------------------------------------------------------------------ #
# adjoint pairs and errors
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("what", ["halo", "gather"])
def test_collective_is_an_exact_adjoint_pair(ranks, what, S):
    """Summed over the ranks, <f(x), y> == <x, f^T(y)> in f64: the
    halo's backward is the reverse ``ppermute`` into the rows it sent,
    the summed gather's the ``reduce_scatter`` of every rank's
    cotangent."""
    _, res = ranks
    lhs = sum(rec["adjoint"][what][0] for rec in res[S])
    rhs = sum(rec["adjoint"][what][1] for rec in res[S])
    assert abs(lhs - rhs) <= 1e-10 * max(1.0, abs(lhs)), (lhs, rhs)


def _fake_group(S=2):
    """A group object for the argument checks, which raise before any
    collective."""
    return SeqGroup(None, 0, S, torch.device("cpu"))


def test_ssm_shard_not_a_multiple_of_the_chunk_raises():
    """A shard's tokens (T / n) must be a multiple of the SSD chunk: the
    error names both."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import ssm as TSSM

    cfg = get_smoke("mamba2-370m")            # chunk 16
    x = torch.zeros(1, 24, cfg.d_model)
    with pytest.raises(ValueError, match=r"24 tokens .* SSD chunk 16"):
        TSSM.ssm_apply(None, x, cfg, seq=_fake_group())


def test_halo_wider_than_a_shard_raises():
    with pytest.raises(ValueError, match="at least the halo's rows"):
        _fake_group().halo(torch.zeros(1, 2, 4), 3)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-370m"])
def test_recurrent_programs_run_under_a_group(arch):
    """``check_sequence_parallel`` admits every segment kind of the
    recurrent programs (griffin, rec_mlp, ssm); a trailing ``rec_mlp``
    segment too."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as TT

    cfg = get_smoke(arch)
    for n_layers in (cfg.n_layers, cfg.n_layers + 1):
        c = dataclasses.replace(cfg, n_layers=n_layers)
        for kind, _ in TT.make_program(c):
            TT.check_sequence_parallel(c, kind, _fake_group(4))
