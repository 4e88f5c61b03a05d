"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA. [arXiv:2412.08905; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig, SALOConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense", n_layers=32, d_model=3072,
    n_heads=24, n_kv_heads=8, d_ff=8192, vocab_size=200064,
    salo=SALOConfig(window=1024, n_global=4))

SMOKE = dataclasses.replace(
    CONFIG, name="phi4-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=256,
    salo=SALOConfig(window=16, n_global=2, block_q=32, block_k=32),
    param_dtype="float32", compute_dtype="float32")
