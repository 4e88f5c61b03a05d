"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The port of :mod:`repro.models.rglru`. Gated linear recurrence:
``h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)`` with
``a_t = exp(-c * softplus(Lambda) * r_t)``, ``r/i = sigmoid(linear(x))``.

Training runs the recurrence as a log-depth parallel scan in plain torch
(:func:`linear_scan`, where the reference calls
``jax.lax.associative_scan``): ``ceil(log2 T)`` elementwise passes over
the whole sequence, never a loop over its tokens. Decode is one
multiply-add. The block wraps the recurrence Griffin-style: two input
branches (conv + RG-LRU, GeLU) merged multiplicatively; the GeLU is
tanh-approximate, as ``jax.nn.gelu``.

RecurrentGemma alternates (rec, rec, attn); the attention third runs local
sliding-window attention through the SALO kernels.

Sequence parallelism (``seq=``): each rank holds a contiguous slice of
every sequence. The conv takes the previous shard's last W-1 rows
(``SeqGroup.halo``), and the scan, run from zero on the shard, adds the
state entering it times its running decay, that state composed in rank
order from every earlier shard's decay product and end state
(``SeqGroup.carry``): the unsharded recurrence, as the reference's
partitioner carries ``associative_scan`` across shards.

Tensor parallelism (``model=``): where the group divides ``d_rnn``, a rank
holds its ``d_rnn / n`` columns of ``w_in`` and ``w_gate_branch`` and rows
of ``w_out`` (the reference's "ffn" placements), and runs the conv, the
scan and the gating on its channels. The gates ``r`` and ``i`` mix all
``d_rnn`` channels, so the rank's f32 input of them is gathered (a
summing gather: each rank takes its own columns of the whole ``w_a`` and
``w_i``), and the whole ``conv_w``, ``w_a``, ``w_i`` and ``lam`` get on
each rank only their columns' gradient, which the trainer sums over the
group (``Split.model_sum``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import split_axes
from repro_torch.models.layers import dense_init, dt
from repro_torch.models.ssm import _causal_conv

C_FACTOR = 8.0


def _d_rnn(cfg: ModelConfig) -> int:
    r = cfg.recurrent
    return r.d_rnn if r.d_rnn is not None else cfg.d_model


def rglru_init(gen: torch.Generator, cfg: ModelConfig, device):
    d = cfg.d_model
    dr = _d_rnn(cfg)
    W = cfg.recurrent.conv_width
    conv_w = torch.randn((W, dr), generator=gen, device=gen.device) * 0.1
    # Lambda init so a^c is in [0.9, 0.999] (paper §2.4): inverse softplus
    ac = torch.linspace(0.9, 0.999, dr, dtype=torch.float32)
    lam = torch.log(torch.expm1(-torch.log(ac) / C_FACTOR))
    return {
        "w_in": dense_init(gen, d, dr, dt(cfg), device),     # recurrent
        "w_gate_branch": dense_init(gen, d, dr, dt(cfg), device),  # gelu
        "w_out": dense_init(gen, dr, d, dt(cfg), device),
        "conv_w": conv_w.to(device=device, dtype=dt(cfg)),
        "w_a": dense_init(gen, dr, dr, dt(cfg), device),    # recurrence gate
        "w_i": dense_init(gen, dr, dr, dt(cfg), device),    # input gate
        "lam": lam.to(device),
    }


def linear_scan(a: torch.Tensor, b: torch.Tensor, prods: bool = False):
    """Inclusive scan of ``h_t = a_t * h_{t-1} + b_t`` (``h_{-1} = 0``)
    along axis 1: Hillis–Steele over the pairs ``(a, b)``, which compose
    as ``(a1, b1) then (a2, b2) = (a1 * a2, a2 * b1 + b2)``. Each pass
    combines every position with the one ``d`` before it, ``d`` doubling
    from 1 (``ceil(log2 T)`` passes). With ``prods``, returns ``(h, P)``:
    ``P_t`` the running product of ``a`` up to ``t`` (the last pass's
    products too, which ``h`` alone does not need)."""
    T = a.shape[1]
    d = 1
    while d < T:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if prods or 2 * d < T:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return (b, a) if prods else b


def _own(cfg: ModelConfig, model) -> slice:
    """This rank's ``d_rnn`` channels under ``model``; all of them where
    the group does not split ``d_rnn`` (or there is none)."""
    dr = _d_rnn(cfg)
    if model is None or "ffn" not in split_axes(cfg, model.size, dr):
        return slice(None)
    n = dr // model.size
    return slice(model.index * n, (model.index + 1) * n)


def _rglru_core(p, xr: torch.Tensor, h0=None, model=None, seq=None):
    """xr: (B, T, dr) post-conv, or this rank's (B, T, dr / n) channels
    under a ``model`` group that splits them. Returns (h, h_last), f32,
    over xr's channels. ``seq``: a sequence group, xr this shard's slice:
    the shard scans from zero, keeping the running products ``P`` of
    ``a``; the state entering it is composed from every earlier shard's
    (product, end state) (:meth:`~repro_torch.dist.group.SeqGroup
    .carry`) and added as ``h_t += P_t * h_in``, which costs one more
    pass of products, where folding ``h_in`` into the first step would
    cost a second scan."""
    xf = xr.float()
    w_a, w_i, lam, xg = p["w_a"], p["w_i"], p["lam"], xf
    if model is not None:         # the gates' columns of this rank
        n = xr.shape[-1]
        own = slice(model.index * n, (model.index + 1) * n)
        w_a, w_i, lam = w_a[:, own], w_i[:, own], lam[own]
        xg = model.gather(xf, -1, summed=True)
    r = torch.sigmoid(xg @ w_a.float())
    i = torch.sigmoid(xg @ w_i.float())
    log_a = -C_FACTOR * F.softplus(lam) * r               # (B,T,dr) <= 0
    a = torch.exp(log_a)
    gated = i * xf
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * gated
    if h0 is not None:  # fold the initial state into the first step
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    if seq is None:
        h = linear_scan(a, b)
    else:
        h, P = linear_scan(a, b, prods=True)
        h = h + P * seq.carry(P[:, -1], h[:, -1])[:, None]
    return h, h[:, -1]


def rglru_apply(p, x: torch.Tensor, cfg: ModelConfig,
                model=None, seq=None) -> torch.Tensor:
    """Griffin recurrent block, full sequence. x: (B,T,d) -> (B,T,d).
    Under a ``model`` group that splits ``d_rnn`` the weights are the
    rank's slices: x's gradient is summed over the group (``enter``) and
    the rank's partial output too (``reduce``), each in x's dtype. Under
    a ``seq`` group x is this shard's slice of the sequence: the conv
    reads the previous shard's last W-1 pre-conv rows (``seq.halo``) and
    the scan takes the state entering the shard (``_rglru_core``)."""
    own = _own(cfg, model)
    split = own != slice(None)
    seq = seq if seq is not None and seq.size > 1 else None
    if split:
        x = model.enter(x)
    xr = x @ p["w_in"].to(x.dtype)
    W = p["conv_w"].shape[0]
    halo = seq.halo(xr, W - 1) if seq is not None and W > 1 else None
    xr, _ = _causal_conv(xr, p["conv_w"][:, own].to(x.dtype), state=halo,
                         act=None)
    h, _ = _rglru_core(p, xr, model=model if split else None, seq=seq)
    gate = F.gelu(x @ p["w_gate_branch"].to(x.dtype), approximate="tanh")
    y = h.to(x.dtype) * gate
    out = y @ p["w_out"].to(x.dtype)
    return model.reduce(out) if split else out


def rglru_decode(p, x_t: torch.Tensor, conv_state: torch.Tensor,
                 h_state: torch.Tensor, cfg: ModelConfig):
    """One-token step. x_t: (B,1,d); conv_state: (B,W-1,dr); h_state:
    (B,dr) f32. Returns (y, conv_state, h_state), the states new
    tensors."""
    xr = x_t @ p["w_in"].to(x_t.dtype)
    xr, conv_state = _causal_conv(xr, p["conv_w"].to(x_t.dtype),
                                  state=conv_state, act=None)
    xr1 = xr[:, 0].float()
    r = torch.sigmoid(xr1 @ p["w_a"].float())
    i = torch.sigmoid(xr1 @ p["w_i"].float())
    a = torch.exp(-C_FACTOR * F.softplus(p["lam"]) * r)
    h_state = (a * h_state
               + torch.sqrt(torch.clamp(1 - a * a, min=1e-12)) * (i * xr1))
    gate = F.gelu(x_t @ p["w_gate_branch"].to(x_t.dtype), approximate="tanh")
    y = h_state[:, None, :].to(x_t.dtype) * gate
    return y @ p["w_out"].to(x_t.dtype), conv_state, h_state
