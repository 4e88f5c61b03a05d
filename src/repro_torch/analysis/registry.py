"""The registered verification targets: which patterns/plans the gate proves
(the port of :mod:`repro.analysis.registry`, the same targets).

One declarative list, mirrored after the benchmark workloads but sized for
an exhaustive pairwise proof (the prover materializes a (n_pad, n_pad)
coverage count per plan). Every entry is verified for forward coverage,
adjoint (transposed + packed) soundness and — where ``n_shards`` is
non-empty — shard-exchange soundness; causal 1-D entries additionally get
the never-drop proof and the dynamic full-keep replay, and chunk targets
the ChunkPlan prefill-slice proofs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core import patterns as P
from repro_torch.core.patterns import HybridSparsePattern


@dataclasses.dataclass(frozen=True)
class VerifyTarget:
    """One (pattern, geometry) pair the soundness gate must prove."""
    name: str
    pattern: HybridSparsePattern
    n: int
    block_q: int
    block_k: int
    n_shards: Tuple[int, ...] = ()      # shard counts to prove exchange for
    dynamic: bool = False               # never-drop + full-keep replay
    local_window: Optional[int] = None  # never-drop locality (None = auto)


@dataclasses.dataclass(frozen=True)
class ChunkTarget:
    """One serving prefill workload: every chunk slice of ``prompt`` gets
    the chunk coverage/view-completeness proof over the paged layout
    derived from ``pattern`` (page size ``page``, chunk length ``chunk``),
    plus the sharded-tables reconstruction for each entry of
    ``n_shards``."""
    name: str
    pattern: HybridSparsePattern
    prompt: int
    chunk: int
    page: int
    n_shards: Tuple[int, ...] = ()


def plan_targets() -> Tuple[VerifyTarget, ...]:
    return (
        VerifyTarget("longformer", P.longformer(64, n_global=8),
                     n=256, block_q=32, block_k=32, n_shards=(2, 4)),
        VerifyTarget("longformer-causal",
                     P.longformer(64, n_global=8, causal=True),
                     n=256, block_q=32, block_k=32, n_shards=(2,),
                     dynamic=True),
        VerifyTarget("vil-2d", P.vil((12, 12), (3, 3), n_global=1),
                     n=145, block_q=16, block_k=16, n_shards=(2,)),
        VerifyTarget("dilated", P.dilated_window(8, 2),
                     n=192, block_q=16, block_k=16, n_shards=(2,)),
        # dilation scatters the global tiles across residue groups after
        # data reordering — the exchange proof's hardest static case.
        VerifyTarget("reordered-global",
                     HybridSparsePattern(window=(-16, 16), dilation=2,
                                         n_global=6),
                     n=192, block_q=16, block_k=16, n_shards=(2,)),
        VerifyTarget("causal-sw-sinks", P.causal_sliding_window(32, n_sinks=8),
                     n=256, block_q=32, block_k=32, n_shards=(2, 4),
                     dynamic=True),
        VerifyTarget("causal-dilated",
                     P.causal_sliding_window(8, n_sinks=4, dilation=2),
                     n=128, block_q=16, block_k=16, dynamic=True),
    )


def chunk_targets() -> Tuple[ChunkTarget, ...]:
    return (
        ChunkTarget("chunk-sw-sinks", P.causal_sliding_window(16, n_sinks=2),
                    prompt=70, chunk=16, page=8, n_shards=(2,)),
        ChunkTarget("chunk-dilated",
                    P.causal_sliding_window(8, n_sinks=2, dilation=2),
                    prompt=52, chunk=12, page=8, n_shards=(2,)),
        ChunkTarget("chunk-short-prompt",
                    P.causal_sliding_window(16, n_sinks=2),
                    prompt=11, chunk=16, page=8),
    )
