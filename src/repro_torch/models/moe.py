"""Mixture-of-Experts FFN with capacity dispatch.

The port of :mod:`repro.models.moe`, on one device, over a data group
(``data=``), expert-parallel over a model group (``model=``: split over
the experts, or over their ffn where the group does not divide them, or
whole) and sequence-parallel (``seq=``) (:func:`moe_apply`). Sort-based
dispatch,
dropless up to the capacity factor: tokens are split into
``dispatch_groups`` groups; per group each token picks its ``top_k``
experts, the (token, expert) entries are sorted by expert (a stable sort,
so ties keep token order as ``jnp.argsort``), each entry's rank within
its expert is its slot, and entries ranked at or past the capacity ``C``
are dropped. The reference's sharding hints (``constrain``) do nothing on
one device and have no counterpart here.

The two MoE architectures:
  * arctic-480b: 128 experts top-2 **+ dense residual** (a dense FFN in
    parallel with the MoE output, ``attn_moe_dense``),
  * kimi-k2:     384 experts top-8, one shared expert, one leading dense
    layer (``attn_moe``).

Every group's slots go through the experts together: the dispatch buffer
is ``(E, G·C, d)`` and each expert product is one batched product over
E, ``(E, G·C, d) x (E, d, f)`` (the reference runs the ``(E, C, d)``
einsums once per group under ``vmap``; the numbers are the same up to the
f32 accumulation order). So a step reads every expert's weights, however
few tokens it routes.

Aux losses: the Switch load balance and the router z-loss, with the
reference's coefficients, and the share of dropped (token, expert)
entries.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import split_axes
from repro_torch.models.layers import dense_init, dt, mlp_apply, mlp_init


def _experts(gen, E: int, d_in: int, d_out: int, dtype, device,
             span=None):
    """An ``(E, d_in, d_out)`` stack of ``dense_init`` weights, drawn
    expert by expert into a stack preallocated in ``dtype`` (one expert's
    f32 draw at a time, not the whole stack's). ``span`` ``(lo, hi)``:
    keep only experts ``lo..hi-1`` (an expert-parallel rank's), drawing
    and dropping the others, so the generator's stream is the whole
    stack's."""
    lo, hi = (0, E) if span is None else span
    w = torch.empty((hi - lo, d_in, d_out), dtype=dtype, device=device)
    for e in range(E):
        one = dense_init(gen, d_in, d_out, dtype, device)
        if lo <= e < hi:
            w[e - lo] = one
    return w


def expert_split(cfg: ModelConfig, n: int) -> Optional[str]:
    """How a model group of ``n`` ranks splits the expert stacks: over
    ``"experts"`` where ``n`` divides ``n_experts``, else over ``"ffn"``
    where ``n`` divides ``d_ff_expert``, else not at all (``None``): the
    reference's ``_mesh_clean`` drops a mesh axis that does not divide its
    dim (:func:`repro_torch.dist.sharding.leaf_placement` places the
    leaves by the same rule)."""
    if n <= 1:
        return None
    split = split_axes(cfg, n, cfg.moe.d_ff_expert)
    return "experts" if "experts" in split else \
        "ffn" if "ffn" in split else None


def expert_span(cfg: ModelConfig, model) -> Optional[tuple]:
    """The experts ``(lo, hi)`` a rank of the model group ``model`` holds
    where the group splits them (:func:`expert_split`): ``E / n`` of them,
    contiguous, in rank order. ``None`` where it does not: every rank
    holds all E experts, their stacks split over ffn or whole."""
    if expert_split(cfg, model.size) != "experts":
        return None
    per = cfg.moe.n_experts // model.size
    return model.index * per, (model.index + 1) * per


def moe_init(gen, cfg: ModelConfig, device, span=None):
    """The MoE parameters: the f32 router, the expert stacks in the param
    dtype and kimi's shared expert. ``span`` ``(lo, hi)``: the expert
    stacks hold only those experts (:func:`expert_span`), drawn from the
    same stream as the whole stacks."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.n_experts
    p = {"router": dense_init(gen, d, E, torch.float32, device),
         "w_in": _experts(gen, E, d, f, dt(cfg), device, span),
         "w_out": _experts(gen, E, f, d, dt(cfg), device, span)}
    if cfg.act in ("swiglu", "geglu"):
        p["w_gate"] = _experts(gen, E, d, f, dt(cfg), device, span)
    if m.n_shared_experts:
        p["shared"] = mlp_init(gen, cfg, device, d_ff=f * m.n_shared_experts)
    return p


def n_groups(cfg: ModelConfig, T: int) -> int:
    """The dispatch group count for T tokens: ``REPRO_MOE_GROUPS`` (the
    environment variable the reference reads, so A/B runs line up) or
    ``dispatch_groups``, halved until it divides T."""
    G = int(os.environ.get("REPRO_MOE_GROUPS", cfg.moe.dispatch_groups))
    while G > 1 and T % G:
        G //= 2
    return G


def capacity(cfg: ModelConfig, Tg: int) -> int:
    """Slots per expert and group: ``int(Tg·k/E·cf)`` (Python's
    truncation first) rounded up to a multiple of 8, at least 8."""
    m = cfg.moe
    C = int(Tg * m.top_k / m.n_experts * m.capacity_factor)
    return max(8, -(-C // 8) * 8)


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` on the last axis: the k largest, ties to the
    lower index (a stable descending sort; ``torch.topk`` leaves the order
    of ties unspecified). Returns (values, indices)."""
    _, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    idx = idx[..., :k]
    return probs.gather(-1, idx), idx


def _expert_ffn(p, buf: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """buf: (E, n, d) -> (E, n, d), each expert's SwiGLU / GeGLU / GELU
    (tanh-approximate, as ``jax.nn.gelu``) as batched products over E."""
    h = torch.bmm(buf, p["w_in"].to(buf.dtype))
    if cfg.act == "swiglu":
        h = F.silu(torch.bmm(buf, p["w_gate"].to(buf.dtype))) * h
    elif cfg.act == "geglu":
        h = F.gelu(torch.bmm(buf, p["w_gate"].to(buf.dtype)),
                   approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, p["w_out"].to(buf.dtype))


def _slots(probs: torch.Tensor, k: int, C: int):
    """Group-local routing. probs: (G, Tg, E). Returns the renormalised
    gates (G, Tg, k) f32 and, per (token, choice) entry in token order,
    its slot in the ``(E, G·C)`` dispatch buffer (G, Tg·k) int64 and
    whether it was kept (G, Tg·k) bool."""
    G, Tg, E = probs.shape
    gates, expert_idx = top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    flat_e = expert_idx.reshape(G, Tg * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(-1, order)
    experts = torch.arange(E, device=probs.device).expand(G, E).contiguous()
    starts = torch.searchsorted(sorted_e, experts)               # left
    pos = torch.arange(Tg * k, device=probs.device) \
        - starts.gather(-1, sorted_e)
    keep = pos < C
    group = torch.arange(G, device=probs.device)[:, None]
    slot = sorted_e * (G * C) + group * C + pos.clamp(0, C - 1)
    # back from expert order to token order
    return (gates, torch.empty_like(slot).scatter_(-1, order, slot),
            torch.empty_like(keep).scatter_(-1, order, keep))


def _own_tokens(B: int, S: int, seq, device) -> torch.Tensor:
    """The global flat indices (B, S·n flattened) of the (B, S) tokens
    this rank of the sequence group ``seq`` holds: its contiguous slice of
    every sequence, in rank order."""
    tl = torch.arange(B * S, device=device)
    return (tl // S) * (S * seq.size) + seq.index * S + tl % S


def _own_groups(B: int, S: int, seq, Tg: int) -> int:
    """How many dispatch groups of ``Tg`` tokens hold any of this rank's
    tokens (:func:`_own_tokens`): the groups its buffer keeps. From the
    shapes alone, so no host read."""
    mine = set()
    for b in range(B):
        lo = b * S * seq.size + seq.index * S
        mine.update(range(lo // Tg, (lo + S - 1) // Tg + 1))
    return len(mine)


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig, data=None, model=None,
              seq=None):
    """x: (B, S, d) -> (y, aux). ``aux``: ``load_balance``, ``router_z``
    (both scaled by their coefficients) and ``dropped_frac``, f32 scalars.

    Routing is an f32 product and softmax (TF32 must stay off, or near
    ties flip experts). The kept entries are written into their slots of
    a zeroed ``(E·G·C + 1, d)`` buffer, the dropped ones into its last
    row, which the experts never read: the buffer holds exactly the
    reference's ``.at[e, pos].add`` of the kept rows plus zeros.

    ``data`` (a :class:`~repro_torch.dist.group.DataGroup` of n ranks):
    x is this rank's rows of the global batch, and the groups are aligned
    with the batch split, as the reference's: the G dispatch groups are
    :func:`n_groups` of the GLOBAL token count, and this rank runs its
    G / n of them (raises unless n divides G), so every group routes as
    on one device. The aux terms are this rank's shares, which add up over
    the ranks to the global batch's: the top-1 counts are summed over the
    group (one ``all_reduce`` a layer, no gradient) and the load balance
    weighs this rank's prob sums by them; the router z and the dropped
    share are this rank's sums over the global counts.

    ``seq`` (a :class:`~repro_torch.dist.group.SeqGroup` of n ranks): x
    is this rank's slice of every sequence. The f32 router logits of its
    tokens are gathered over the group (one ``all_gather`` a layer,
    :meth:`~repro_torch.dist.group.SeqGroup.gather`: backward, this rank's
    rows of the gradient), and every rank routes the whole batch's groups
    alike: the G groups, their ``Tg`` tokens and the capacity C are the
    unsharded run's, so every slot is too, whether or not a group's tokens
    sit on one shard. A rank then dispatches, runs the experts on and
    combines only its own tokens' kept entries, in a buffer of the groups
    that hold any of them; the experts work row by row, so no activation
    crosses the shards. Only its own rows of the gathered logits enter
    its loss differentiably (its gates, its prob sums), so the gather's
    backward is exact. The aux terms are this rank's shares, from the
    whole batch's top-1 counts (no collective of their own); the group
    sums its gradients.

    ``model`` (a :class:`~repro_torch.dist.group.ModelGroup` of N ranks;
    expert parallelism): x is the same on every rank, and the expert
    stacks split as :func:`expert_split` says. Over ``"experts"`` (N
    divides E), ``p`` holds this rank's E / N experts
    (:func:`expert_span`), its router columns and its slice of a shared
    expert's ffn. Every rank routes the same tokens alike: its logit
    columns are gathered into the whole (T, E) logits
    (:meth:`~repro_torch.dist.group.ModelGroup.gather`), so the softmax,
    top-k, slots and capacity run on the same bits everywhere. A rank
    dispatches only the kept entries of its own experts into an
    ``(E/N·G·C + 1, d)`` buffer, gathers its experts' output rows into a
    (T·k, d) tensor whose other rows are zero, and the group sums it (ONE
    ``all_reduce`` a layer forward, exact: each row is nonzero on one
    rank). Over ``"ffn"`` (N divides ``d_ff_expert``, not E), the router
    is whole and every rank routes and dispatches all E experts, each
    expert's products on this rank's ffn columns; the same one
    ``all_reduce`` sums the ranks' partial rows. Whole (N divides
    neither), every rank runs the whole MoE alike, with no collective,
    and every gradient is whole on every rank. Either way the gated
    combine runs alike on every rank, so the gates' gradient is whole
    everywhere (summing the gated ``y`` instead would leave it partial,
    and the router's gradient wrong). The aux terms come from the whole
    probs on every rank, with no collective of their own."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.n_experts, m.top_k
    T = B * S
    n = 1 if data is None else data.size
    xt = x.reshape(T, d)
    if model is not None and model.size == 1:
        model = None
    if seq is not None and seq.size == 1:
        seq = None
    split = None if model is None else expert_split(cfg, model.size)
    lo, hi = (0, E) if split != "experts" else expert_span(cfg, model)
    xe = xt
    if split is not None:
        # every later use of xe is this rank's share of the work: its
        # gradient is summed over the group once, here
        xe = model.enter(xt)

    # a whole router gives the whole gradient on every rank: fed by xt
    logits = (xe if split == "experts" else xt).float() @ p["router"]
    if split == "experts":
        logits = model.gather(logits, 1)                     # (T, E)
    T_all, own = T, None
    if seq is not None:
        T_all = T * seq.size
        own = _own_tokens(B, S, seq, x.device)
        routed = seq.gather(logits.view(B, S, E), 1).reshape(T_all, E)
    else:
        routed = logits
    probs = torch.softmax(routed, dim=-1)

    G = n_groups(cfg, T_all * n)
    if G % n:
        raise ValueError(f"{G} dispatch groups of {T_all * n} tokens do "
                         f"not split over the data group's {n} ranks")
    G //= n
    Tg = T_all // G
    C = capacity(cfg, Tg)
    gates, slot, keep = _slots(probs.reshape(G, Tg, E), k, C)
    gates, slot, keep = (a.reshape(T_all, k) for a in (gates, slot, keep))
    Gm = G
    if own is not None:
        gates, slot, keep = gates[own], slot[own], keep[own]
        # the buffer keeps only the groups that hold this rank's tokens
        Gm = _own_groups(B, S, seq, Tg)
        held = torch.zeros(G, dtype=torch.long, device=x.device)
        held = held.index_fill_(0, own // Tg, 1).cumsum_(0) - 1
        e, g = slot // (G * C), slot % (G * C) // C
        slot = e * (Gm * C) + held[g] * C + slot % C
    entries = xe[:, None, :].expand(T, k, d).reshape(T * k, d)
    # this rank's experts' slots are [lo·Gm·C, hi·Gm·C) (else all)
    n_slots = (hi - lo) * Gm * C
    local = slot - lo * Gm * C
    mine = keep & (local >= 0) & (local < n_slots)
    local = local.clamp(0, n_slots - 1)
    target = torch.where(mine, local, n_slots).reshape(-1)
    buf = xe.new_zeros((n_slots + 1, d)).index_copy(0, target, entries)
    out = _expert_ffn(p, buf[:n_slots].view(hi - lo, Gm * C, d), cfg)

    contrib = out.reshape(n_slots, d)[local.reshape(-1)] \
        * mine.reshape(-1, 1).to(x.dtype)
    if split is not None:
        contrib = model.reduce(contrib)
    y = torch.einsum("tkd,tk->td", contrib.view(T, k, d),
                     gates.to(x.dtype))

    # Switch load balance: E * sum_e (share routed to e) * (mean prob e)
    top1 = torch.argmax(probs, dim=-1)
    counts = torch.zeros(E, device=x.device).index_add_(
        0, top1, torch.ones(T_all, device=x.device))    # exact counts
    if data is not None:
        data.psum_(counts)
    frac = counts / (T_all * n)
    if own is None:
        lb = E * torch.sum(frac * probs.mean(0)) / n
        z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) / n
        dropped = (1.0 - keep.float().mean()) / n
    else:       # this rank's shares of the whole batch's terms
        lb = E * torch.sum(frac * probs[own].sum(0) / T_all)
        z = torch.sum(torch.logsumexp(logits, dim=-1) ** 2) / T_all
        dropped = (T * k - keep.sum()).float() / (T_all * k)
    aux = {"load_balance": m.load_balance_coef * lb,
           "router_z": m.router_z_coef * z,
           "dropped_frac": dropped}

    y = y.reshape(B, S, d)
    if m.n_shared_experts:
        y = y + mlp_apply(p["shared"], x, cfg, model,
                          d_ff=m.d_ff_expert * m.n_shared_experts)
    return y, aux
