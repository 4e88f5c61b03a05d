"""recurrentgemma-9b [hybrid] — RG-LRU + local attention 1:2; the closest
published arch to the paper's sliding-window workload.
[arXiv:2402.19427; unverified]"""
import dataclasses
from repro_torch.configs.base import ModelConfig, RecurrentConfig, SALOConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, head_dim=256, d_ff=12288,
    vocab_size=256000, act="geglu", tie_embeddings=True,
    recurrent=RecurrentConfig(local_window=2048),
    salo=SALOConfig(window=2048, n_global=4))

SMOKE = dataclasses.replace(
    CONFIG, name="rgemma-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=1, head_dim=16, d_ff=128, vocab_size=256,
    recurrent=RecurrentConfig(local_window=16),
    salo=SALOConfig(window=16, n_global=2, block_q=32, block_k=32),
    param_dtype="float32", compute_dtype="float32")
