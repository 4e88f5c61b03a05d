"""The VLM and encoder-decoder families under a sequence group, on gloo
CPU ranks, f32, against the unsharded port and the JAX reference.

qwen2-vl-2b and whisper-base at their smoke shapes (2 layers; qwen2-vl:
M-RoPE sections (2, 3, 3), GQA 4 on 2; whisper: 32 audio frames) at seq
128, a multiple of 4 shards x blocks of 32, batch 2. One module-scoped
spawn per group size (S = 2 and 4) runs three cases:

* ``qwen2-vl-2b:grid``: a vision grid of 8 x 10 slots (rows 8..87 and
  16..95) that spans the shard boundaries, with given M-RoPE positions
  whose t/h/w components differ over the grid (text before it at
  ``(i, i, i)``, the grid at ``(s, s + row, s + col)``, text after it from
  the grid's largest position on); at S = 4 the last shard holds no
  vision slot;
* ``qwen2-vl-2b:default``: the same vision slots, no positions (each
  rank's default M-RoPE positions are its global slice);
* ``whisper-base``: the encoder whole on every rank, the decoder sharded.

Each rank slices the batch with ``trainer._seq_slice``, runs
``Model.loss(..., group=)`` and sums its gradients over the group. The
group's loss and the summed gradients, ``enc/*`` and ``vision_proj``
included, are held to the unsharded port's and to the reference's
``Model.loss`` under ``jax.grad`` on the whole sequence (the port's
parameters converted from the reference's with ``params_from_jax``).
The reference's per-shard pieces hold on their own: ``rope`` with M-RoPE
sections on a shard's positions, ``cross_attn_apply`` on a shard's query
rows against the whole encoder output.

Tolerances: loss and gradients 1e-4 (abs and rel; the reference's
gradient bar), the per-shard pieces 1e-5. The spawned ranks import this
module, so it imports JAX only inside the functions that run it. Every
spawn has a deadline of 120 s.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.dist.group import run_ranks

torch.set_num_threads(2)
DEADLINE_S = 120.0
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
SHARDS = (2, 4)
SEQ, BATCH = 128, 2
CASES = ("qwen2-vl-2b:grid", "qwen2-vl-2b:default", "whisper-base")
GRID = (8, 10)              # the vision grid's rows and columns
GRID_AT = (8, 16)           # its first slot in each batch row


def _arch(case):
    return case.partition(":")[0]


def _cfg(case, module="torch"):
    if module == "torch":
        from repro_torch.configs import get_smoke
    else:
        from repro.configs import get_smoke
    return get_smoke(_arch(case))


def _grid_positions():
    """(3, B, SEQ) M-RoPE positions and the (B, SEQ) vision mask: text
    before the grid at ``(i, i, i)``, the grid's slot (r, c) at ``(s, s +
    r, s + c)`` with ``s`` its first slot, text after it from the grid's
    largest position + 1 on, in all three components."""
    rows, cols = GRID
    pos = np.zeros((3, BATCH, SEQ), np.int32)
    mask = np.zeros((BATCH, SEQ), bool)
    for b, s in enumerate(GRID_AT):
        pos[:, b, :s] = np.arange(s)
        r, c = np.divmod(np.arange(rows * cols), cols)
        pos[0, b, s:s + rows * cols] = s
        pos[1, b, s:s + rows * cols] = s + r
        pos[2, b, s:s + rows * cols] = s + c
        mask[b, s:s + rows * cols] = True
        after = s + max(rows, cols)
        pos[:, b, s + rows * cols:] = after + np.arange(
            SEQ - s - rows * cols)
    return pos, mask


@functools.lru_cache(maxsize=None)
def _batch(case):
    """The case's whole batch, numpy, from one seed."""
    cfg = _cfg(case)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    out = {"tokens": toks[:, :SEQ], "labels": toks[:, 1:]}
    if cfg.encoder_decoder:
        out["audio_embeds"] = rng.normal(
            size=(BATCH, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    if cfg.n_vision_tokens:
        pos, mask = _grid_positions()
        out["vision_embeds"] = rng.normal(
            size=(BATCH, SEQ, cfg.d_model)).astype(np.float32)
        out["vision_mask"] = mask
        if case.endswith(":grid"):
            out["positions"] = pos
    return out


@functools.lru_cache(maxsize=None)
def _jax(case):
    """The reference's parameters (converted for the port), loss and
    gradients on the whole batch."""
    import jax
    import jax.numpy as jnp

    from repro.models.model import build_model as j_build
    from repro_torch.convert import params_from_jax

    jmodel = j_build(_cfg(case, "jax"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in _batch(case).items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(jparams, batch)
    np_tree = functools.partial(jax.tree.map, np.asarray)
    return dict(params=params_from_jax(np_tree(jparams), "cpu"),
                loss=float(loss), grads=params_from_jax(np_tree(grads),
                                                         "cpu"))


@functools.lru_cache(maxsize=None)
def _port(case):
    """The port's unsharded loss, gradients and encoder output."""
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_leaves, tree_map

    model = build_model(_cfg(case), "cpu")
    leaves = tree_map(lambda p: p.clone().requires_grad_(),
                      _jax(case)["params"])
    batch = {k: torch.from_numpy(v) for k, v in _batch(case).items()}
    loss, _ = model.loss(leaves, batch)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    enc = model._encode(leaves, batch).detach().numpy() \
        if model.cfg.encoder_decoder else None
    return float(loss.detach()), [g.numpy() for g in grads], enc


def _names(tree):
    from repro_torch.tree import tree_flatten_with_path
    return ["/".join(p) for p, _ in tree_flatten_with_path(tree)[0]]


# ------------------------------------------------------------------ #
# the ranks
# ------------------------------------------------------------------ #
def _case_rank(group, case, params, batch):
    """One case on this rank: the sliced batch, the loss under the group,
    the gradients (this rank's share and their sum over the group), the
    sharded route's calls and what the rank's forward saw: the positions
    its segments took, its encoder output."""
    from repro_torch.dist import sharded_plan
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model, build_model
    from repro_torch.train.trainer import _seq_slice
    from repro_torch.tree import tree_leaves, tree_map

    seen = {"calls": 0, "positions": [], "enc": []}
    real_sa, real_seg, real_enc = (sharded_plan.sharded_attention,
                                   T.segment_apply, Model._encode)

    def sa(*a, **kw):
        seen["calls"] += 1
        return real_sa(*a, **kw)

    def seg(*a, **kw):
        if kw.get("positions") is not None:
            seen["positions"].append(kw["positions"].clone().numpy())
        return real_seg(*a, **kw)

    def enc(self, *a, **kw):
        out = real_enc(self, *a, **kw)
        seen["enc"].append(out.detach().clone().numpy())
        return out

    sharded_plan.sharded_attention, T.segment_apply, Model._encode = \
        sa, seg, enc
    try:
        model = build_model(_cfg(case), "cpu")
        local = _seq_slice({k: torch.from_numpy(v) for k, v in batch.items()},
                           group)
        leaves = tree_map(lambda p: p.clone().requires_grad_(), params)
        loss, metrics = model.loss(leaves, local, group=group)
        grads = torch.autograd.grad(loss, tree_leaves(leaves))
    finally:
        sharded_plan.sharded_attention, T.segment_apply, Model._encode = \
            real_sa, real_seg, real_enc
    share = [g.clone().numpy() for g in grads]
    flat = group.psum_(torch.cat([g.reshape(-1) for g in grads]))
    return dict(loss=float(metrics["loss"]), local=float(loss.detach()),
                share=share, grads=flat.numpy(), calls=seen["calls"],
                positions=seen["positions"], enc=seen["enc"],
                vision_slots=int(local["vision_mask"].sum())
                if "vision_mask" in local else None)


def _rank_body(group, cases):
    return {case: _case_rank(group, case, params, batch)
            for case, (params, batch) in cases.items()}


@pytest.fixture(scope="module")
def ranks():
    cases = {c: (_jax(c)["params"], _batch(c)) for c in CASES}
    return {S: run_ranks(_rank_body, S, backend="gloo", device="cpu",
                         timeout_s=DEADLINE_S, args=(cases,))
            for S in SHARDS}


def _flat(leaves):
    return np.concatenate([np.asarray(g).reshape(-1) for g in leaves])


# ------------------------------------------------------------------ #
# the model under the group
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("case", CASES)
def test_loss_and_grads_under_group_match_jax_and_unsharded(ranks, case,
                                                           S):
    """The group's loss (on every rank; the ranks' shares add up to it)
    and the gradients summed over the ranks within 1e-4 of the unsharded
    port's and of JAX's whole-sequence ``jax.grad``, leaf by leaf,
    ``enc/*`` and ``vision_proj`` included; the summed gradients bitwise
    equal on every rank; the sharded route taken by each decoder layer's
    self attention and its remat replay, never by whisper's encoder."""
    from repro_torch.tree import tree_leaves

    ref, (p_loss, p_grads, _) = _jax(case), _port(case)
    names = _names(ref["grads"])
    want = [g.numpy() for g in tree_leaves(ref["grads"])]
    res = [r[case] for r in ranks[S]]
    key = "enc/" if case == "whisper-base" else "vision_proj/"
    extra = [i for i, n in enumerate(names) if n.startswith(key)]
    assert extra and all(np.abs(want[i]).sum() > 0 for i in extra)
    for r in res:
        np.testing.assert_allclose(r["loss"], ref["loss"], **GRAD_TOL)
        np.testing.assert_allclose(r["loss"], p_loss, **GRAD_TOL)
        assert r["calls"] == 2 * _cfg(case).n_layers, r["calls"]
    np.testing.assert_allclose(sum(r["local"] for r in res), p_loss,
                               **GRAD_TOL)
    got = res[0]["grads"]
    assert all(r["grads"].tobytes() == got.tobytes() for r in res)
    at = 0
    for name, w, p in zip(names, want, p_grads):
        g = got[at:at + w.size].reshape(w.shape)
        at += w.size
        np.testing.assert_allclose(g, p, err_msg=name, **GRAD_TOL)
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD_TOL)
    assert at == got.size


@pytest.mark.parametrize("S", SHARDS)
def test_whisper_encodes_every_frame_on_every_rank(ranks, S):
    """whisper's encoder output is the unsharded one's, bitwise, on every
    rank (it takes no group: every rank encodes all 32 frames), and each
    rank's decoder slice reaches the encoder: every rank's own share of
    the ``enc/*`` gradients is nonzero."""
    from repro_torch.tree import tree_leaves

    want = _port("whisper-base")[2]
    names = _names(_jax("whisper-base")["grads"])
    assert len(tree_leaves(_jax("whisper-base")["grads"])) == len(names)
    for r in ranks[S]:
        rec = r["whisper-base"]
        assert len(rec["enc"]) == 1
        assert rec["enc"][0].shape == want.shape
        assert rec["enc"][0].tobytes() == want.tobytes()
        enc = [g for n, g in zip(names, rec["share"]) if n.startswith("enc/")]
        assert enc and all(np.abs(g).sum() > 0 for g in enc)


@pytest.mark.parametrize("S", SHARDS)
def test_vision_merge_is_local_and_a_shard_without_slots_adds_zero(ranks, S):
    """The vision grid spans the shard boundaries; each rank merges its own
    slots. A rank with no vision slot (the last of 4) adds exactly zero to
    ``vision_proj``'s gradient, the others a nonzero share, and the shares
    sum to the unsharded gradient."""
    names = _names(_jax("qwen2-vl-2b:grid")["grads"])
    i = names.index("vision_proj/w")
    n = SEQ // S
    mask = _batch("qwen2-vl-2b:grid")["vision_mask"]
    shares = []
    for r, rec in enumerate(ranks[S]):
        rec = rec["qwen2-vl-2b:grid"]
        slots = int(mask[:, r * n:(r + 1) * n].sum())
        assert rec["vision_slots"] == slots
        g = rec["share"][i]
        assert (np.abs(g).sum() > 0) == (slots > 0), (r, slots)
        shares.append(g)
    if S == 4:
        assert ranks[S][3]["qwen2-vl-2b:grid"]["vision_slots"] == 0
    # the grid crosses every boundary it covers: some row's slots lie on
    # both sides of one
    assert any(mask[:, b - 1].any() and mask[:, b].any()
               for b in range(n, SEQ, n))
    np.testing.assert_allclose(sum(shares), _port("qwen2-vl-2b:grid")[1][i],
                               **GRAD_TOL)


@pytest.mark.parametrize("S", SHARDS)
def test_default_mrope_positions_are_global(ranks, S):
    """With no ``positions`` in the batch each rank's segments take its
    global slice, ``index * S_local + arange(S_local)`` in all three
    components; given positions arrive sliced on axis 2."""
    n = SEQ // S
    given = _batch("qwen2-vl-2b:grid")["positions"]
    for r, rec in enumerate(ranks[S]):
        want = np.broadcast_to(np.arange(r * n, (r + 1) * n), (3, BATCH, n))
        got = rec["qwen2-vl-2b:default"]["positions"]
        assert len(got) == 1
        np.testing.assert_array_equal(got[0], want)
        got = rec["qwen2-vl-2b:grid"]["positions"]
        np.testing.assert_array_equal(got[0], given[:, :, r * n:(r + 1) * n])


# ------------------------------------------------------------------ #
# the reference's per-shard pieces, in one process
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("S", SHARDS)
def test_mrope_on_a_shard_slice_matches_jax(S):
    """The port's ``rope`` with M-RoPE sections on each shard's rows and
    positions slice equals the reference's on the whole sequence, sliced,
    and the reference's on the same slice (rotation is position-local)."""
    import jax.numpy as jnp

    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    cfg = _cfg("qwen2-vl-2b")
    rng = np.random.default_rng(S)
    x = rng.normal(size=(BATCH, SEQ, cfg.n_heads, cfg.hd)).astype(np.float32)
    pos, _ = _grid_positions()
    whole = np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos),
                               cfg.rope_theta, cfg.mrope_sections))
    n = SEQ // S
    for r in range(S):
        sl = slice(r * n, (r + 1) * n)
        got = TL.rope(torch.from_numpy(x[:, sl].copy()),
                      torch.from_numpy(pos[:, :, sl].copy()),
                      cfg.rope_theta, cfg.mrope_sections).numpy()
        part = np.asarray(JL.rope(jnp.asarray(x[:, sl]),
                                  jnp.asarray(pos[:, :, sl]),
                                  cfg.rope_theta, cfg.mrope_sections))
        np.testing.assert_allclose(got, whole[:, sl], **TOL)
        np.testing.assert_allclose(got, part, **TOL)


@pytest.mark.parametrize("S", SHARDS)
def test_cross_attn_on_shard_rows_matches_jax(S):
    """The port's ``cross_attn_apply`` on each shard's query rows against
    the whole encoder output equals the reference's on the same rows and
    the reference's on every row, sliced (the rows attend independently:
    no collective)."""
    import jax.numpy as jnp

    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    cfg = _cfg("whisper-base")
    params = _jax("whisper-base")["params"]["seg0_xattn"][0]["xattn"]
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    rng = np.random.default_rng(10 + S)
    x = rng.normal(size=(BATCH, SEQ, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(BATCH, cfg.n_audio_frames, cfg.d_model)
                     ).astype(np.float32)
    whole, _ = JL.cross_attn_apply(jp, jnp.asarray(x), jnp.asarray(enc),
                                   _cfg("whisper-base", "jax"))
    n = SEQ // S
    for r in range(S):
        sl = slice(r * n, (r + 1) * n)
        got = TL.cross_attn_apply(params, torch.from_numpy(x[:, sl].copy()),
                                  torch.from_numpy(enc), cfg).numpy()
        part, _ = JL.cross_attn_apply(jp, jnp.asarray(x[:, sl]),
                                      jnp.asarray(enc),
                                      _cfg("whisper-base", "jax"))
        np.testing.assert_allclose(got, np.asarray(part), **TOL)
        np.testing.assert_allclose(got, np.asarray(whole)[:, sl], **TOL)


# ------------------------------------------------------------------ #
# the trainer's slice
# ------------------------------------------------------------------ #
def test_seq_slice_takes_each_entrys_own_axis():
    """``_seq_slice`` cuts ``positions`` (3, B, S) on axis 2, the (B, S)
    and (B, S, d) entries on axis 1, leaves ``audio_embeds`` (B, frames,
    d) whole, and raises for an entry it does not know and for a sequence
    the group does not divide."""
    from repro_torch.dist.group import SeqGroup
    from repro_torch.train.trainer import _seq_axis, _seq_slice

    B, S, d, F = 2, 8, 3, 6
    batch = {"tokens": torch.arange(B * S).reshape(B, S),
             "labels": torch.arange(B * S).reshape(B, S) + 1,
             "mask": torch.ones(B, S, dtype=torch.bool),
             "vision_mask": torch.arange(B * S).reshape(B, S) % 3 == 0,
             "vision_embeds": torch.randn(B, S, d),
             "positions": torch.arange(3 * B * S).reshape(3, B, S),
             "audio_embeds": torch.randn(B, F, d)}
    assert {k: _seq_axis(k) for k in batch} == {
        "tokens": 1, "labels": 1, "mask": 1, "vision_mask": 1,
        "vision_embeds": 1, "positions": 2, "audio_embeds": None}
    for r in range(4):
        got = _seq_slice(batch, SeqGroup(None, r, 4, torch.device("cpu")))
        sl = slice(2 * r, 2 * r + 2)
        assert torch.equal(got["positions"], batch["positions"][:, :, sl])
        for k in ("tokens", "labels", "mask", "vision_mask",
                  "vision_embeds"):
            assert torch.equal(got[k], batch[k][:, sl]), k
        assert got["audio_embeds"] is batch["audio_embeds"]
    with pytest.raises(KeyError, match="segment_ids"):
        _seq_slice({"segment_ids": batch["tokens"]},
                   SeqGroup(None, 0, 2, torch.device("cpu")))
    with pytest.raises(ValueError, match="not divisible"):
        _seq_slice(batch, SeqGroup(None, 0, 3, torch.device("cpu")))
