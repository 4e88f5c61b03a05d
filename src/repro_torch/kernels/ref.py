"""Dense masked oracle for hybrid sparse attention.

O(n^2) memory — the ground truth the plan-driven engines are tested
against. Materializes the pattern mask from
:meth:`HybridSparsePattern.mask`. Differentiable through torch autograd.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.patterns import HybridSparsePattern
from repro_torch.core.renorm import NEG_INF


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pattern: HybridSparsePattern, *,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: (B, N, D) with B folding batch*heads."""
    B, N, D = q.shape
    scale = (D ** -0.5) if scale is None else scale
    mask = torch.from_numpy(pattern.mask(N)).to(q.device)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # Rows with no attended key (possible for exotic patterns): zero them.
    p = torch.where(mask.any(dim=-1)[None, :, None], p, 0.0)
    return torch.matmul(p, v.float()).to(q.dtype)
