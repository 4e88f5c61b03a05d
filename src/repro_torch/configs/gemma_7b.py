"""gemma-7b [dense] — GeGLU, head_dim=256. [arXiv:2403.08295; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig, SALOConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense", n_layers=28, d_model=3072,
    n_heads=16, n_kv_heads=16, head_dim=256, d_ff=24576,
    vocab_size=256000, act="geglu", tie_embeddings=True,
    logit_softcap=30.0, salo=SALOConfig(window=1024, n_global=4))

SMOKE = dataclasses.replace(
    CONFIG, name="gemma-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=32, d_ff=128, vocab_size=256,
    salo=SALOConfig(window=16, n_global=2, block_q=32, block_k=32),
    param_dtype="float32", compute_dtype="float32")
