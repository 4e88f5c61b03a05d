"""Mamba2 SSD (state-space duality) block — chunked.

The port of :mod:`repro.models.ssm`. The SSD chunked algorithm
(arXiv:2405.21060 §6): an intra-chunk quadratic term (batched einsums)
plus an inter-chunk linear recurrence over per-chunk states — the
reference's ``lax.scan``, a Python loop over the ``T / chunk`` chunks here.
Attention-free: the paper's sparse attention does not apply to this
family. Plain torch on both devices; the block has no kernel of its own.

Decode carries (conv_state, ssd_state) and costs O(1) per token.

Sequence parallelism (``seq=``): each rank holds a contiguous slice of
every sequence (a multiple of the chunk). The conv takes the previous
shard's last W-1 pre-conv rows (``SeqGroup.halo``, the reference's
``_causal_conv(state=)``), and the SSD the state entering the shard,
composed in rank order from the earlier shards' total decays and end
states (``SeqGroup.carry``).

Tensor parallelism (``model=``): the reference splits ``w_in`` (d, 2
d_inner + 2N + H) on its columns and ``w_out`` (d_inner, d) on its rows
where the group divides each. A rank's columns of ``w_in`` do not line up
with the parts ``[z | x B C | dt]``, so the rank gathers the whole
projection ``h``; where both split and the group divides the heads, the
rank then runs the conv, the SSD and the gated norm for its ``H / n``
heads with ``B`` and ``C`` whole (the norm's mean of squares summed over
the group in f32), its rows of ``w_out`` on its channels, and the partial
outputs summed. The gather's backward sums the gradient over the group
(``B``, ``C`` and the whole leaves feed every rank's heads), and the
whole ``conv_w``, ``A_log``, ``D``, ``dt_bias`` and ``norm_scale`` get on
each rank only its share of their gradient, which the trainer sums
(``Split.model_sum``). Where the group divides only one of the two
widths, or not the heads, the SSD runs whole on every rank between the
split products; where it divides neither, the block runs unsplit with no
collective.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import split_axes
from repro_torch.models.layers import dense_init, dt


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    return d_inner, H, s.d_state, s.head_dim


def ssm_init(gen: torch.Generator, cfg: ModelConfig, device):
    s = cfg.ssm
    d = cfg.d_model
    d_inner, H, N, P = _dims(cfg)
    conv_ch = d_inner + 2 * N  # x, B, C share the causal conv (G=1 group)
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn((s.conv_width, conv_ch), generator=gen,
                         device=gen.device) * 0.1
    return {
        "w_in": dense_init(gen, d, 2 * d_inner + 2 * N + H, dt(cfg), device),
        "w_out": dense_init(gen, d_inner, d, dt(cfg), device),
        "conv_w": conv_w.to(device=device, dtype=dt(cfg)),
        "A_log": torch.zeros((H,), **f32),           # A = -exp(A_log) = -1
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "norm_scale": torch.zeros((d_inner,), **f32),
    }


def _split(cfg: ModelConfig, h: torch.Tensor):
    d_inner, H, N, P = _dims(cfg)
    return torch.split(h, [d_inner, d_inner + 2 * N, H], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, state=None,
                 act=F.silu):
    """Depthwise causal conv. xbc: (B, T, C); w: (W, C).

    state: (B, W-1, C) trailing context for decode; returns (y,
    new_state)."""
    W, T = w.shape[0], xbc.shape[1]
    if state is None:
        pad = xbc.new_zeros((xbc.shape[0], W - 1, xbc.shape[2]))
    else:
        pad = state
    xp = torch.cat([pad, xbc], dim=1)
    y = sum(xp[:, i:i + T] * w[i] for i in range(W))
    if act is not None:
        y = act(y)
    return y, xp[:, -(W - 1):]


def _gated_norm(p, y: torch.Tensor, z: torch.Tensor, eps: float,
                model=None, own: slice = slice(None)):
    """RMS norm of ``y * silu(z)`` over the channels. Under ``model``, y
    and z are this rank's channels ``own`` of them: the sum of squares is
    summed over the group (f32) before the mean."""
    yf = y.float() * F.silu(z.float())
    if model is None:
        var = (yf * yf).mean(dim=-1, keepdim=True)
    else:       # each rank's share of var's gradient is summed too
        var = model.reduce(model.enter((yf * yf).sum(dim=-1, keepdim=True))) \
            / (yf.shape[-1] * model.size)
    return (yf * torch.rsqrt(var + eps)
            * (1 + p["norm_scale"][own])).to(y.dtype)


def ssd_chunked(x: torch.Tensor, B_mat: torch.Tensor, C_mat: torch.Tensor,
                a: torch.Tensor, chunk: int, s0=None, seq=None,
                return_state: bool = False):
    """SSD scan. x: (B,T,H,P); B_mat/C_mat: (B,T,N); a: (B,T,H) log-decay
    <= 0. Returns y (B,T,H,P) in f32. Single B/C group broadcast over heads
    (G=1).

    ``s0``: the (B,H,N,P) f32 state entering the sequence (zeros by
    default). ``seq``: a sequence group, the inputs this shard's slice:
    ``s0`` is composed from the earlier shards' (exp of total log-decay,
    end state) (:meth:`~repro_torch.dist.group.SeqGroup.carry`). The
    recurrence is linear in its entering state, so the chunks run from
    zero and ``s0`` is added to each chunk's entering state times the
    decay before that chunk (the intra-chunk term never reads it): one
    pass of the chunk loop, one ``y_inter``. ``return_state``: returns
    ``(y, s_end, total)``, the end state (B,H,N,P) and the total
    log-decay (B,H), f32."""
    Bsz, T, H, P = x.shape
    N = B_mat.shape[-1]
    Q = chunk
    if T % Q:
        raise ValueError(f"sequence {T} is not a multiple of the SSD chunk "
                         f"{Q}")
    nc = T // Q

    xc = x.reshape(Bsz, nc, Q, H, P).float()
    Bc = B_mat.reshape(Bsz, nc, Q, N).float()
    Cc = C_mat.reshape(Bsz, nc, Q, N).float()
    Acum = torch.cumsum(a.reshape(Bsz, nc, Q, H).float(), dim=2)

    # Intra-chunk (quadratic within the chunk).
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)    # (B,nc,Q,Q)
    L = Acum[:, :, :, None, :] - Acum[:, :, None, :, :]  # (B,nc,Q,Q,H)
    iq = torch.arange(Q, device=x.device)
    causal = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    # The reference takes where(causal, exp(L), 0). Masking L to -inf
    # before the exp gives the same values, and keeps the gradient finite
    # where exp(L) of a masked (k > q) pair overflows to inf.
    L = torch.exp(L.masked_fill(~causal, float("-inf")))
    M = scores[..., None] * L                          # (B,nc,Q,Q,H)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", M, xc)

    # Per-chunk output states.
    decay_out = torch.exp(Acum[:, :, -1:, :] - Acum)  # (B,nc,Q,H)
    state_c = torch.einsum("bcqn,bcqh,bcqhp->bchnp", Bc, decay_out, xc)

    # Inter-chunk recurrence: each chunk reads the state entering it.
    chunk_decay = torch.exp(Acum[:, :, -1, :])         # (B,nc,H)
    s = x.new_zeros((Bsz, H, N, P), dtype=torch.float32)
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = s * chunk_decay[:, c, :, None, None] + state_c[:, c]
    s_in = torch.stack(s_in, dim=1)                    # (B,nc,H,N,P)

    total = None
    if s0 is not None or seq is not None or return_state:
        if s0 is not None and seq is not None:
            raise ValueError("ssd_chunked takes an entering state s0 or a "
                             "group that composes it, not both")
        ends = torch.cumsum(Acum[:, :, -1, :], dim=1)  # (B,nc,H)
        total = ends[:, -1]
        if seq is not None:
            s0 = seq.carry(torch.exp(total)[..., None, None], s)
        if s0 is not None:          # each chunk's decay since the start
            before = torch.cat([torch.zeros_like(ends[:, :1]),
                                ends[:, :-1]], dim=1)
            s_in = s_in + torch.exp(before)[..., None, None] * s0[:, None]
            s = s + torch.exp(total)[..., None, None] * s0

    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp", Cc, torch.exp(Acum),
                           s_in)
    y = (y_intra + y_inter).reshape(Bsz, T, H, P)
    return (y, s, total) if return_state else y


def ssm_apply(p, x: torch.Tensor, cfg: ModelConfig,
              model=None, seq=None) -> torch.Tensor:
    """Train path. x: (B, T, d) -> (B, T, d). ``model``: tensor
    parallelism, the weights this rank's slices (the module's header).
    ``seq``: sequence parallelism, x this shard's T tokens (a multiple of
    the SSD chunk): the conv reads the previous shard's last W-1 pre-conv
    rows (``seq.halo``) and the SSD the state entering the shard
    (``ssd_chunked(seq=)``); the gated norm and ``w_out`` are per
    token."""
    d_inner, H, N, P = _dims(cfg)
    B_, T, _ = x.shape
    seq = seq if seq is not None and seq.size > 1 else None
    if seq is not None and T % cfg.ssm.chunk:
        raise ValueError(
            f"{cfg.name} under a sequence group of {seq.size} shards: each "
            f"shard's {T} tokens (T / n of {T * seq.size}) must be a "
            f"multiple of the SSD chunk {cfg.ssm.chunk}")
    n = 1 if model is None else model.size
    cut_in = n > 1 and "ffn" in split_axes(cfg, n, 2 * d_inner + 2 * N + H)
    cut_out = n > 1 and "ffn" in split_axes(cfg, n, d_inner)
    if cut_in or cut_out:
        x = model.enter(x)
    h = x @ p["w_in"].to(x.dtype)
    if cut_in:
        h = model.gather(h, -1, summed=cut_out)
    z, xbc, dt_raw = _split(cfg, h)
    conv_w, lo, hi = p["conv_w"], 0, H
    by_heads = cut_out and H % n == 0
    if by_heads:            # this rank's heads; B and C whole
        lo, hi = model.index * H // n, (model.index + 1) * H // n
        ch = slice(lo * P, hi * P)
        z, dt_raw = z[..., ch], dt_raw[..., lo:hi]
        xbc = torch.cat([xbc[..., ch], xbc[..., d_inner:]], dim=-1)
        conv_w = torch.cat([conv_w[:, ch], conv_w[:, d_inner:]], dim=-1)
    di = (hi - lo) * P
    W = conv_w.shape[0]
    halo = seq.halo(xbc, W - 1) if seq is not None and W > 1 else None
    xbc, _ = _causal_conv(xbc, conv_w.to(x.dtype), state=halo)
    xi, Bm, Cm = torch.split(xbc, [di, N, N], dim=-1)
    delta = F.softplus(dt_raw.float() + p["dt_bias"][lo:hi])
    A = -torch.exp(p["A_log"][lo:hi])                  # (H,)
    xh = xi.reshape(B_, T, hi - lo, P)
    xdt = xh.float() * delta[..., None]
    a = delta * A                                      # (B,T,H) log decay
    y = ssd_chunked(xdt, Bm, Cm, a, cfg.ssm.chunk, seq=seq)
    y = y + p["D"][lo:hi][None, None, :, None] * xh.float()
    y = y.reshape(B_, T, di)
    if by_heads:
        y = _gated_norm(p, y, z, cfg.norm_eps, model, ch).to(x.dtype)
    else:
        y = _gated_norm(p, y, z, cfg.norm_eps).to(x.dtype)
        if cut_out:         # this rank's rows of w_out
            y = y.chunk(n, dim=-1)[model.index]
    out = y @ p["w_out"].to(x.dtype)
    return model.reduce(out) if cut_out else out


def ssm_decode(p, x_t: torch.Tensor, conv_state: torch.Tensor,
               ssd_state: torch.Tensor, cfg: ModelConfig):
    """One-token step. x_t: (B,1,d); conv_state: (B,W-1,C); ssd_state:
    (B,H,N,P) f32. Returns (y, conv_state, ssd_state), the states new
    tensors."""
    d_inner, H, N, P = _dims(cfg)
    B_ = x_t.shape[0]
    h = x_t @ p["w_in"].to(x_t.dtype)
    z, xbc, dt_raw = _split(cfg, h)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"].to(x_t.dtype),
                                   state=conv_state)
    xi, Bm, Cm = torch.split(xbc, [d_inner, N, N], dim=-1)
    delta = F.softplus(dt_raw.float() + p["dt_bias"])[:, 0]
    A = -torch.exp(p["A_log"])
    xh = xi.reshape(B_, 1, H, P)[:, 0].float()         # (B,H,P)
    a = torch.exp(delta * A)                           # (B,H)
    upd = torch.einsum("bn,bh,bhp->bhnp", Bm[:, 0].float(), delta, xh)
    ssd_state = ssd_state * a[:, :, None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].float(), ssd_state)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(B_, 1, d_inner)
    y = _gated_norm(p, y, z, cfg.norm_eps).to(x_t.dtype)
    return y @ p["w_out"].to(x_t.dtype), conv_state, ssd_state
