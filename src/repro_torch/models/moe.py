"""Mixture-of-Experts FFN with capacity dispatch.

The port of :mod:`repro.models.moe`, on one device or expert-parallel
over a model group (:func:`moe_apply`'s ``model=``). Sort-based dispatch,
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

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
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


def check_expert_split(cfg: ModelConfig, n: int) -> None:
    """Raises ``NotImplementedError`` unless a model group of ``n`` ranks
    splits the experts evenly (``n`` divides ``E``)."""
    E = cfg.moe.n_experts
    if E % n:
        raise NotImplementedError(
            f"expert-parallel MoE splits {cfg.name}'s {E} experts evenly; a "
            f"model group of {n} does not divide them: ROADMAP queue 1, "
            f"'multi-GPU'")


def expert_span(cfg: ModelConfig, model) -> tuple:
    """The experts ``(lo, hi)`` a rank of the model group ``model`` holds:
    ``E / n`` of them, contiguous, in rank order
    (:func:`check_expert_split` first)."""
    check_expert_split(cfg, model.size)
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


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig, data=None, model=None):
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

    ``model`` (a :class:`~repro_torch.dist.group.ModelGroup` of N ranks,
    N dividing E; expert parallelism): ``p`` holds this rank's E / N
    experts (:func:`expert_span`), its router columns and its slice of a
    shared expert's ffn; x is the same on every rank. Every rank routes
    the same tokens alike: its logit columns are gathered into the whole
    (T, E) logits (:meth:`~repro_torch.dist.group.ModelGroup.gather`),
    so the softmax, top-k, slots and capacity run on the same bits
    everywhere. A rank dispatches only the kept entries of its own
    experts into an ``(E/N·G·C + 1, d)`` buffer, gathers its experts'
    output rows into a (T·k, d) tensor whose other rows are zero, and the
    group sums it (ONE ``all_reduce`` a layer forward, exact: each row is
    nonzero on one rank). The gated combine then runs alike on every
    rank, so the gates' gradient is whole everywhere (summing the gated
    ``y`` instead would leave it partial, and the router's gradient
    wrong). The aux terms come from the whole probs on every rank, with
    no collective of their own."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.n_experts, m.top_k
    T = B * S
    n = 1 if data is None else data.size
    xt = x.reshape(T, d)
    if model is not None and model.size == 1:
        model = None
    lo, hi = (0, E) if model is None else expert_span(cfg, model)
    if model is not None:
        # every later use of xt is this rank's share of the work: its
        # gradient is summed over the group once, here
        xt = model.enter(xt)

    logits = xt.float() @ p["router"]                         # (T, E)
    if model is not None:
        logits = model.gather(logits, 1)
    probs = torch.softmax(logits, dim=-1)

    G = n_groups(cfg, T * n)
    if G % n:
        raise ValueError(f"{G} dispatch groups of {T * n} tokens do not "
                         f"split over the data group's {n} ranks")
    G //= n
    Tg = T // G
    C = capacity(cfg, Tg)
    gates, slot, keep = _slots(probs.reshape(G, Tg, E), k, C)
    entries = xt[:, None, :].expand(T, k, d).reshape(T * k, d)
    # this rank's experts' slots are [lo·G·C, hi·G·C) (on one device all)
    n_slots = (hi - lo) * G * C
    local = slot - lo * G * C
    mine = keep & (local >= 0) & (local < n_slots)
    local = local.clamp(0, n_slots - 1)
    target = torch.where(mine, local, n_slots).reshape(-1)
    buf = xt.new_zeros((n_slots + 1, d)).index_copy(0, target, entries)
    out = _expert_ffn(p, buf[:n_slots].view(n_slots // (G * C), G * C, d),
                      cfg)

    contrib = out.reshape(n_slots, d)[local.reshape(-1)] \
        * mine.reshape(-1, 1).to(x.dtype)
    if model is not None:
        contrib = model.reduce(contrib)
    y = torch.einsum("tkd,tk->td", contrib.view(T, k, d),
                     gates.reshape(T, k).to(x.dtype))

    # Switch load balance: E * sum_e (share routed to e) * (mean prob e)
    top1 = torch.argmax(probs, dim=-1)
    counts = torch.zeros(E, device=x.device).index_add_(
        0, top1, torch.ones(T, device=x.device))        # exact counts
    if data is not None:
        data.psum_(counts)
    frac = counts / (T * n)
    lb = E * torch.sum(frac * probs.mean(0)) / n
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) / n
    aux = {"load_balance": m.load_balance_coef * lb,
           "router_z": m.router_z_coef * z,
           "dropped_frac": (1.0 - keep.float().mean()) / n}

    y = y.reshape(B, S, d)
    if m.n_shared_experts:
        y = y + mlp_apply(p["shared"], x, cfg, model,
                          d_ff=m.d_ff_expert * m.n_shared_experts)
    return y, aux
