"""repro_torch.analysis — static soundness verification and lint gates of
the port: the port of :mod:`repro.analysis`.

Three cooperating passes (run together by ``python -m
repro_torch.analysis.lint``):

* :mod:`repro_torch.analysis.plan_verify` — the plan soundness prover,
  over the port's own plans. For every
  concrete ExecutionPlan / TransposedPlan / PackedTransposedPlan /
  ChunkPlan / ShardedPlan it proves exact tile coverage against the
  pattern mask (no missing tiles, no double-counted tiles), adjoint
  soundness (transposed/packed tables are an exact permutation of the
  forward walk), shard-exchange soundness (per-shard tables plus the
  ppermute/psum schedule reconstruct exactly the unsharded tile set) and
  the dynamic never-drop invariant — with counterexamples naming the
  offending (q-block, kv-block) tile.
* :mod:`repro_torch.analysis.launch_lint` — what the reference's jaxpr
  effect linter checks that still means something on a GPU: the launch
  contract counted through the kernel registry's counters, and the
  dtypes of the collectives of a train step and a sharded decode step
  (the int8 gradient wire, the f32 merge of sharded partials, the f32
  gradient sum).
* :mod:`repro_torch.analysis.code_lint` — the stdlib-``ast`` lint
  (unused imports, mutable default arguments, shadowed builtins, bare
  excepts).

Which plans/patterns get verified is declared once, in
:mod:`repro_torch.analysis.registry`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class Finding:
    """One verified defect, with the counterexample that proves it.

    ``q_block``/``kv_block`` name the offending tile of the plan grid the
    pass was walking (the working/view tile universe of that plan) when
    the defect is tile-addressable; pure structural findings leave them
    ``None``.
    """
    pass_name: str                    # "coverage" | "adjoint" | "exchange" |
    #                                   "never-drop" | "chunk" | "jaxpr" | ...
    target: str                       # registry target / entry point name
    message: str
    q_block: Optional[int] = None
    kv_block: Optional[int] = None
    severity: str = "error"

    def counterexample(self) -> str:
        loc = ""
        if self.q_block is not None or self.kv_block is not None:
            loc = f" [counterexample: (q_block={self.q_block}, " \
                  f"kv_block={self.kv_block})]"
        return f"{self.severity}: {self.target}: {self.pass_name}: " \
               f"{self.message}{loc}"

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def render(findings: List[Finding]) -> str:
    return "\n".join(f.counterexample() for f in findings)


__all__ = ["Finding", "render"]
