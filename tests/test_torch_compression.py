"""int8 gradient compression of the port against the JAX package, on the
CPU.

* ``_q8`` / ``_dq`` bit-equal to the reference's (q and scale) on random,
  all-zero and bf16 tensors; ``compress_decompress`` and its error-
  feedback state bit-equal over 5 steps on a tree with a layer list (the
  port's per-layer list is the reference's stacked axis: one scale per
  stacked tensor).
* The reference's two property tests (``tests/test_substrates.py``):
  error feedback is unbiased over 50 steps, and one quantization errs by
  at most half a step.
* ``compressed_psum`` / ``compressed_psum_with_residual`` on 2- and 4-rank
  gloo groups against ``jax.vmap(repro.dist.compression.compressed_psum,
  axis_name="data")`` within 1e-6 (the order of the sum differs), equal on
  every rank, with the wire counted: one int8 gather of every leaf's
  values and one f32 gather of the scales.

The spawned ranks import this module, so it imports JAX only inside the
functions that run it. Every spawn has a deadline of 120 s.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.dist import compression as C
from repro_torch.dist.group import DataGroup, run_ranks
from repro_torch.tree import tree_leaves

DEADLINE_S = 120.0
TOP = ((64, 24), (130,))          # top-level leaves
STACKED = ((3, 5, 7), (16,))      # per-layer leaves, the last all zero
LAYERS = 3


def _arrays(seed, rank=0):
    """Seeded f32 arrays: the top-level leaves, then each stacked leaf as
    (LAYERS, *shape)."""
    rng = np.random.default_rng(seed * 100 + rank)
    out = [(rng.normal(size=s) * 10.0 ** rng.integers(-3, 2))
           .astype(np.float32) for s in TOP + tuple(
               (LAYERS, *s) for s in STACKED)]
    out[-1][:] = 0.0
    return out


def _tree(arrs, cast=torch.from_numpy):
    """The port's tree: the top-level leaves and a list of per-layer
    dicts."""
    return {"w": cast(arrs[0]), "b": cast(arrs[1]),
            "layers": [{"k": cast(arrs[2][i]), "z": cast(arrs[3][i])}
                       for i in range(LAYERS)]}


def _jtree(arrs, cast):
    """The reference's tree: the same leaves, the layers stacked."""
    return {"w": cast(arrs[0]), "b": cast(arrs[1]),
            "layers": {"k": cast(arrs[2]), "z": cast(arrs[3])}}


def _unstack(jt):
    """The reference's leaves in the port's leaf order, as numpy."""
    return [np.asarray(jt["w"]), np.asarray(jt["b"]),
            *(np.asarray(jt["layers"][n][i]) for i in range(LAYERS)
              for n in ("k", "z"))]


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


# ------------------------------------------------------------------ #
# one participant
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("kind", ["random", "zero", "bf16", "tie"])
def test_q8_bit_equal_to_jax(kind):
    import jax.numpy as jnp

    from repro.dist import compression as J

    x = _arrays(1)[0]
    if kind == "zero":
        x = np.zeros_like(x)
    if kind == "tie":      # scale 1.0 and exact halves: half to even
        x = np.append(np.arange(-50, 50) + 0.5, 127.0).astype(np.float32)
    if kind == "bf16":
        tx = _bf16(x)
        jx = jnp.asarray(tx.float().numpy()).astype(jnp.bfloat16)
    else:
        tx, jx = torch.from_numpy(x), jnp.asarray(x)
    tq, ts = C._q8(tx)
    jq, js = J._q8(jx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    assert np.array_equal(C._dq(tq, ts).numpy(),
                          np.asarray(J._dq(jq, js)))


def test_compress_decompress_bit_equal_over_steps():
    """Five steps of a tree (f32 and bf16 leaves, a layer list) with the
    error feedback threaded: every output and residual bit-equal to the
    reference's on its stacked tree."""
    import jax.numpy as jnp

    from repro.dist import compression as J

    def bf16_w(tree, cast):
        tree["b"] = cast(tree["b"])
        return tree

    t_ef = j_ef = None
    for step in range(5):
        arrs = _arrays(10 + step)
        arrs[1] = _bf16(arrs[1]).float().numpy()     # exact in bf16
        t_g = bf16_w(_tree(arrs), lambda t: t.to(torch.bfloat16))
        j_g = bf16_w(_jtree(arrs, jnp.asarray),
                     lambda a: a.astype(jnp.bfloat16))
        t_out, t_ef = C.compress_decompress(t_g, t_ef)
        j_out, j_ef = J.compress_decompress(j_g, j_ef)
        for tt, jt in ((t_out, j_out), (t_ef, j_ef)):
            got = [x for x in (tt["w"], tt["b"], *(
                layer[n] for layer in tt["layers"] for n in ("k", "z")))]
            want = _unstack(jt)
            assert [x.dtype for x in got][:2] == [
                torch.float32,
                torch.bfloat16 if tt is t_out else torch.float32]
            for a, b in zip(got, want):
                assert a.float().numpy().tobytes() == \
                    b.astype(np.float32).tobytes()


def test_int8_error_feedback_unbiased():
    """The reference's property: with error feedback the accumulated
    update converges to the accumulated gradient."""
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
    ef, total = None, torch.zeros(64)
    for _ in range(50):
        out, ef = C.compress_decompress({"g": g_true}, ef)
        total = total + out["g"]
    np.testing.assert_allclose((total / 50).numpy(), g_true.numpy(),
                               atol=2e-2)


def test_int8_without_ef_is_lossy_but_bounded():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(128,)).astype(np.float32))
    q, s = C._q8(x)
    assert float((C._dq(q, s) - x).abs().max()) <= float(s) * 0.5 + 1e-6


def test_flat_quantization_equals_per_tensor():
    """The wire's flat quantization (one pass over the concatenation)
    gives each tensor's ``_q8`` values and scale, bit for bit: a top-level
    leaf's own, a layer list's over its stacked leaves."""
    arrs = _arrays(3)
    tree = _tree(arrs)
    leaves = tree_leaves(tree)
    ids, n_groups = C.scale_groups(tree)
    assert n_groups == 4 and ids == [0, 1] + [2, 3] * LAYERS
    _, q, scales, per = C._q8_flat(leaves, torch.tensor(ids), n_groups)
    whole = [torch.from_numpy(a) for a in arrs]
    off = 0
    for x, i in zip(leaves, ids):
        lq, ls = C._q8(whole[i])
        assert scales[i].item() == ls.item()
        assert torch.equal(per[off: off + x.numel()], ls.expand(x.numel()))
        assert torch.equal(q[off: off + x.numel()],
                           torch.clamp(torch.round(x.reshape(-1) / ls),
                                       -127, 127).to(torch.int8))
        off += x.numel()
    assert torch.equal(q[:arrs[0].size], C._q8(whole[0])[0].reshape(-1))
    with pytest.raises(TypeError, match="f32"):
        C._q8_flat([_bf16(arrs[0])], torch.tensor([0]), 1)


# ------------------------------------------------------------------ #
# the wire on gloo ranks
# ------------------------------------------------------------------ #
def _psum_rank(group, seed):
    data = DataGroup.of(group)
    sent = []
    real = DataGroup.all_gather

    def spy(self, t):
        sent.append((str(t.dtype), t.numel()))
        return real(self, t)

    DataGroup.all_gather = spy
    tree = _tree(_arrays(seed, data.index))
    total = C.compressed_psum(tree, data)
    total2, resid = C.compressed_psum_with_residual(tree, data)
    DataGroup.all_gather = real
    return dict(total=_flat(total), total2=_flat(total2),
                resid=_flat(resid), sent=sent)


def _flat(tree):
    return [x.numpy() for x in tree_leaves(tree)]


@functools.lru_cache(maxsize=None)
def _jax_psum(n, seed):
    import jax
    import jax.numpy as jnp

    from repro.dist import compression as J

    per = [_arrays(seed, r) for r in range(n)]
    stacked = _jtree([np.stack([p[i] for p in per])
                      for i in range(len(per[0]))], jnp.asarray)
    tot = jax.vmap(lambda t: jax.tree.map(
        lambda x: J.compressed_psum(x, "data"), t), axis_name="data")(stacked)
    pairs = jax.vmap(lambda t: jax.tree.map(
        lambda x: J.compressed_psum_with_residual(x, "data"), t),
        axis_name="data")(stacked)
    is_pair = lambda t: isinstance(t, tuple)  # noqa: E731
    tot2 = jax.tree.map(lambda t: t[0], pairs, is_leaf=is_pair)
    resid = jax.tree.map(lambda t: t[1], pairs, is_leaf=is_pair)
    row = lambda t, r: _unstack(jax.tree.map(lambda x: x[r], t))  # noqa: E731
    return [(row(tot, r), row(tot2, r), row(resid, r)) for r in range(n)]


@pytest.fixture(scope="module")
def psum_ranks():
    return {n: run_ranks(_psum_rank, n, backend="gloo", device="cpu",
                         timeout_s=DEADLINE_S, args=(7,))
            for n in (2, 4)}


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_psum_matches_jax_vmap(psum_ranks, n):
    want = _jax_psum(n, 7)
    res = psum_ranks[n]
    for r, rec in enumerate(res):
        tot, tot2, resid = want[r]
        for i in range(len(tot)):
            np.testing.assert_allclose(rec["total"][i], tot[i], rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(rec["total2"][i], tot2[i],
                                       rtol=1e-6, atol=1e-6)
            # this rank's residual is its own: bit-equal to its row
            assert rec["resid"][i].tobytes() == resid[i].tobytes()
            # every rank sums the same parts in the same order
            assert rec["total"][i].tobytes() == \
                res[0]["total"][i].tobytes()
            assert rec["total2"][i].tobytes() == rec["total"][i].tobytes()


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_wire_moves_int8_and_scales(psum_ranks, n):
    """Each call gathers the int8 values of every leaf at once and one
    f32 scale per tensor (a layer list's stacked leaves share one): (n -
    1)(N + 4L) bytes received a rank, against a ring f32 all_reduce's
    2(n - 1)/n · 4N."""
    N = sum(int(np.prod(s)) for s in TOP) + LAYERS * sum(
        int(np.prod(s)) for s in STACKED)
    L = len(TOP) + len(STACKED)
    for rec in psum_ranks[n]:
        assert rec["sent"] == [("torch.int8", N), ("torch.float32", L)] * 2
    got = (n - 1) * sum(numel * (1 if dt == "torch.int8" else 4)
                        for dt, numel in psum_ranks[n][0]["sent"][:2])
    wb = C.wire_bytes(N, L, n)
    assert got == wb["int8_gather"] == (n - 1) * (N + 4 * L)
    assert wb["f32_ring_all_reduce"] == 2 * (n - 1) * 4 * N // n


def test_wire_bytes_ratio_is_n_over_8():
    """At smollm-135m's gradient (134515008 values in the reference's 11
    stacked tensors) the int8 gather receives about n/8 of a ring f32
    all_reduce's bytes: 4x fewer at 2 ranks, 2x at 4, parity at 8."""
    for n, want in ((2, 0.25), (4, 0.5), (8, 1.0)):
        wb = C.wire_bytes(134_515_008, 11, n)
        assert abs(wb["int8_gather"] / wb["f32_ring_all_reduce"] - want) \
            < 1e-4
