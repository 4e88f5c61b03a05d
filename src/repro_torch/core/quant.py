"""Fixed-point quantization simulation (paper §6.4).

The port of :mod:`repro.core.quant`. SALO quantizes Q, K, V to **int8 with
4 fractional bits** (scale 2^-4, range [-8, 7.9375]) and produces 16-bit
outputs. :func:`fixed_point_q8` simulates that exact grid with a
straight-through gradient (quantization-aware finetuning);
:func:`dynamic_q8` is the per-tensor (or grouped) dynamic int8 variant;
:func:`quantized_attention` runs the hybrid attention op on either grid.

The serving stack stores the paged KV slab in this int8 format with
*per-page* dynamic scales (:func:`group_q8` / :func:`group_dequant`, used by
:mod:`repro_torch.serve.paged_cache`).

``torch.round`` rounds half to even, as ``jnp.round`` does, so every
payload here is bit-equal to the reference's.
"""
from __future__ import annotations

import torch

FRAC_BITS = 4
SCALE = 2.0 ** FRAC_BITS  # paper: 4-bit fraction
QMIN, QMAX = -128, 127


class _FixedPointQ8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        q = torch.clamp(torch.round(x * SCALE), QMIN, QMAX)
        return (q / SCALE).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g  # STE


def fixed_point_q8(x: torch.Tensor) -> torch.Tensor:
    """Round to the int8(4-frac) fixed-point grid. Shape-preserving; the
    gradient passes straight through."""
    return _FixedPointQ8.apply(x)


def dynamic_q8(x: torch.Tensor, axis=None):
    """Per-tensor (or grouped) dynamic int8: returns ``(int8, scale)``.

    ``axis=None`` computes ONE scale for the whole tensor (a 0-d scale).
    An int or tuple of ints names the axes reduced away when computing the
    scale; every other axis indexes an independent group, and ``scale``
    keeps the reduced axes as size 1 so it broadcasts against ``q`` in
    :func:`dequant`. The ``1e-8`` floor on the group amax keeps all-zero
    groups from producing a zero divisor (they quantize to zeros)."""
    if axis is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), QMIN, QMAX).to(torch.int8)
    return q, scale


def dequant(q: torch.Tensor, scale: torch.Tensor,
            dtype=torch.float32) -> torch.Tensor:
    """``q`` in ``dtype`` times ``scale``, in the promoted type of the two
    as in JAX (a 16-bit ``dtype`` with an f32 scale gives f32; torch alone
    would keep the 16-bit type against a 0-d scale)."""
    out = torch.promote_types(dtype, scale.dtype)
    return q.to(dtype).to(out) * scale.to(out)


def group_q8(x: torch.Tensor, n_group_axes: int):
    """Leading-axis-grouped int8: the first ``n_group_axes`` axes index
    quantization groups, the trailing axes are reduced into each group's
    scale. Returns ``(q int8 like x, scale f32 of shape
    x.shape[:n_group_axes])``."""
    if not 0 < n_group_axes < x.dim():
        raise ValueError(f"n_group_axes {n_group_axes} must lie in "
                         f"(0, {x.dim()})")
    axes = tuple(range(n_group_axes, x.dim()))
    q, scale = dynamic_q8(x.float(), axis=axes)
    return q, scale.reshape(x.shape[:n_group_axes])


def group_dequant(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`group_q8`: ``scale`` broadcasts over the trailing
    (non-group) axes of ``q``."""
    expand = scale.reshape(*scale.shape, *(1,) * (q.dim() - scale.dim()))
    return (q.float() * expand).to(dtype)


def quantized_attention(q, k, v, pattern, *, impl: str = "blockwise",
                        mode: str = "fixed", **kw):
    """Attention on the quantized grid (the paper's deployment numerics).

    mode='fixed'   int8 with 4-bit fraction (the ASIC's format)
    mode='dynamic' per-tensor dynamic int8
    """
    from repro_torch.core.attention import hybrid_attention

    if mode == "fixed":
        qq, kq, vq = fixed_point_q8(q), fixed_point_q8(k), fixed_point_q8(v)
    elif mode == "dynamic":
        qq = dequant(*dynamic_q8(q), dtype=q.dtype)
        kq = dequant(*dynamic_q8(k), dtype=k.dtype)
        vq = dequant(*dynamic_q8(v), dtype=v.dtype)
    else:
        raise ValueError(mode)
    return hybrid_attention(qq, kq, vq, pattern, impl=impl, **kw)
