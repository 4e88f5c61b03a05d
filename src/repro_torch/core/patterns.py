"""Hybrid sparse attention patterns (paper §2.3).

A pattern is the union of
  * a (possibly dilated) relative-offset window  a <= j - i <= b, (j-i) % d == 0
  * global tokens: a prefix of ``n_global`` tokens whose keys every query
    attends (global column) and whose queries attend every key (global row)
  * an optional causal constraint j <= i.

2-D patterns (ViL) are expressed on a flattened (H, W) grid: token i sits at
(i // W, i % W) and attends tokens within a (wh, ww) Chebyshev-box window.
The scheduler lowers 2-D windows into a union of 1-D bands (one per row
offset), exactly as SALO's data reordering does.

``mask()`` materializes the boolean attention mask — the oracle every other
implementation is tested against. O(n^2) memory; for tests and small shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class HybridSparsePattern:
    """Metadata the data scheduler receives (paper Fig. 3)."""

    # 1-D sliding/dilated window: relative offsets [a, b], stride `dilation`.
    window: Tuple[int, int] = (0, 0)
    dilation: int = 1
    # Leading `n_global` tokens are global.
    n_global: int = 0
    # Global rows: do global queries attend everything? (Longformer: yes.
    # StreamingLLM-style attention sinks: only the global *column* matters.)
    global_rows: bool = True
    # Causal masking on top of everything (LM decode/training).
    causal: bool = False
    # 2-D (ViL): grid (H, W) and window (wh, ww), both odd. Overrides `window`.
    grid2d: Optional[Tuple[int, int]] = None
    window2d: Optional[Tuple[int, int]] = None

    def __post_init__(self):
        a, b = self.window
        if a > b:
            raise ValueError(f"window lo {a} > hi {b}")
        if self.dilation < 1:
            raise ValueError("dilation must be >= 1")
        if (self.grid2d is None) != (self.window2d is None):
            raise ValueError("grid2d and window2d must be given together")
        if self.grid2d is not None:
            wh, ww = self.window2d
            if wh % 2 == 0 or ww % 2 == 0:
                raise ValueError("2-D windows must be odd-sized")
            if self.dilation != 1:
                raise ValueError("2-D windows do not compose with dilation")

    # ------------------------------------------------------------------ #
    @property
    def is_2d(self) -> bool:
        return self.grid2d is not None

    def seq_len(self) -> Optional[int]:
        """Implied sequence length for 2-D patterns (n_global + H*W)."""
        if self.is_2d:
            h, w = self.grid2d
            return self.n_global + h * w
        return None

    def window_size(self) -> int:
        a, b = self.window
        return (b - a) // self.dilation + 1

    # ------------------------------------------------------------------ #
    def mask(self, n: int, n_kv: Optional[int] = None) -> np.ndarray:
        """Dense boolean mask oracle, shape (n, n_kv). True = attend."""
        n_kv = n if n_kv is None else n_kv
        i = np.arange(n)[:, None]
        j = np.arange(n_kv)[None, :]
        g = self.n_global

        if self.is_2d:
            h, w = self.grid2d
            wh, ww = self.window2d
            if n != g + h * w or n_kv != g + h * w:
                raise ValueError(
                    f"2-D pattern implies n = {g + h * w}, got ({n}, {n_kv})")
            # Grid coordinates for non-global tokens (global tokens prepended).
            yi, xi = (i - g) // w, (i - g) % w
            yj, xj = (j - g) // w, (j - g) % w
            m = (np.abs(yj - yi) <= wh // 2) & (np.abs(xj - xi) <= ww // 2)
            m &= (i >= g) & (j >= g)
        else:
            a, b = self.window
            rel = j - i
            m = (rel >= a) & (rel <= b) & (rel % self.dilation == 0)

        # Global column: every query sees global keys.
        if g > 0:
            m = m | (j < g)
            # Global rows: global queries see every key.
            if self.global_rows:
                m = m | (i < g)
        if self.causal:
            m = m & (j <= i)
        return m

    def sparsity(self, n: int) -> float:
        """Fraction of attended entries (paper Table 2 'Sparsity')."""
        return float(self.mask(n).mean())


# ---------------------------------------------------------------------- #
# Pattern library — the paper's workloads plus the patterns the framework
# applies to the assigned LM architectures.
# ---------------------------------------------------------------------- #

def longformer(window_size: int = 512, n_global: int = 1,
               causal: bool = False) -> HybridSparsePattern:
    """Longformer-Base-4096 style: symmetric window + leading global tokens."""
    half = window_size // 2
    return HybridSparsePattern(window=(-half, half - 1 + window_size % 2),
                               n_global=n_global, causal=causal)


def causal_sliding_window(window_size: int, n_sinks: int = 0,
                          dilation: int = 1) -> HybridSparsePattern:
    """Causal LM pattern: attend the last `window_size` tokens (+ sinks).

    ``n_sinks`` leading global *keys* (StreamingLLM attention sinks) — the
    paper's global column with global_rows=False (row i<g is still causal).
    """
    return HybridSparsePattern(window=(-(window_size - 1) * dilation, 0),
                               dilation=dilation, n_global=n_sinks,
                               global_rows=False, causal=True)


def dilated_window(window_size: int, dilation: int,
                   causal: bool = False) -> HybridSparsePattern:
    half = window_size // 2
    return HybridSparsePattern(
        window=(-half * dilation, (window_size - 1 - half) * dilation),
        dilation=dilation, causal=causal)


def vil(grid: Tuple[int, int], window: Tuple[int, int] = (15, 15),
        n_global: int = 1) -> HybridSparsePattern:
    """ViL stage pattern: 2-D local window + global CLS token (paper Table 2)."""
    return HybridSparsePattern(grid2d=grid, window2d=window, n_global=n_global)


def full(causal: bool = False, n: int = 2 ** 30) -> HybridSparsePattern:
    """Dense attention expressed as a degenerate (huge-window) pattern."""
    return HybridSparsePattern(window=(-n, n), causal=causal)
