"""Paper workload (Table 2 rows 2-3): ViL stages with 15x15 2-D windows.
stage1: 56x56 grid, hidden 192; stage2: 28x28 grid, hidden 384; 1 global
token each. These drive the paper-claims benchmarks (attention layer level,
as the paper evaluates)."""
from repro_torch.core.patterns import vil

VIL_STAGE1 = dict(grid=(56, 56), window=(15, 15), hidden=192, n_global=1,
                  pattern=vil((56, 56), (15, 15), 1))
VIL_STAGE2 = dict(grid=(28, 28), window=(15, 15), hidden=384, n_global=1,
                  pattern=vil((28, 28), (15, 15), 1))
