"""Paper workload (Table 2 row 1): Longformer-Base-4096 attention layer —
n=4096, window=512, hidden=768 (12 heads x 64), 1 global token,
sparsity 0.125. Used by the paper-claims benchmarks; also a full small LM
config for end-to-end runs."""
import dataclasses
from repro_torch.configs.base import ModelConfig, SALOConfig

CONFIG = ModelConfig(
    name="longformer-4k", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=50265, act="gelu",
    salo=SALOConfig(window=512, n_global=1, bidirectional=True,
                    global_rows=True))

SMOKE = dataclasses.replace(
    CONFIG, name="longformer-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=256,
    salo=SALOConfig(window=16, n_global=1, bidirectional=True,
                    global_rows=True, block_q=32, block_k=32),
    param_dtype="float32", compute_dtype="float32")
