"""Mamba2 SSD (state-space duality) block — chunked.

The port of :mod:`repro.models.ssm`. The SSD chunked algorithm
(arXiv:2405.21060 §6): an intra-chunk quadratic term (batched einsums)
plus an inter-chunk linear recurrence over per-chunk states — the
reference's ``lax.scan``, a Python loop over the ``T / chunk`` chunks here.
Attention-free: the paper's sparse attention does not apply to this
family. Plain torch on both devices; the block has no kernel of its own.

Decode carries (conv_state, ssd_state) and costs O(1) per token.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
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


def _gated_norm(p, y: torch.Tensor, z: torch.Tensor, eps: float):
    yf = y.float() * F.silu(z.float())
    var = (yf * yf).mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * (1 + p["norm_scale"])).to(y.dtype)


def ssd_chunked(x: torch.Tensor, B_mat: torch.Tensor, C_mat: torch.Tensor,
                a: torch.Tensor, chunk: int) -> torch.Tensor:
    """SSD scan. x: (B,T,H,P); B_mat/C_mat: (B,T,N); a: (B,T,H) log-decay
    <= 0. Returns y (B,T,H,P) in f32. Single B/C group broadcast over heads
    (G=1)."""
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

    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp", Cc, torch.exp(Acum),
                           s_in)
    return (y_intra + y_inter).reshape(Bsz, T, H, P)


def ssm_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Train path. x: (B, T, d) -> (B, T, d)."""
    d_inner, H, N, P = _dims(cfg)
    B_, T, _ = x.shape
    h = x @ p["w_in"].to(x.dtype)
    z, xbc, dt_raw = _split(cfg, h)
    xbc, _ = _causal_conv(xbc, p["conv_w"].to(x.dtype))
    xi, Bm, Cm = torch.split(xbc, [d_inner, N, N], dim=-1)
    delta = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])                         # (H,)
    xh = xi.reshape(B_, T, H, P)
    xdt = xh.float() * delta[..., None]
    a = delta * A                                      # (B,T,H) log decay
    y = ssd_chunked(xdt, Bm, Cm, a, cfg.ssm.chunk)
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(B_, T, d_inner)
    y = _gated_norm(p, y, z, cfg.norm_eps).to(x.dtype)
    return y @ p["w_out"].to(x.dtype)


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
