"""granite-3-8b [dense] — GQA. [hf:ibm-granite/granite-3.0-2b-base; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig, SALOConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=12800, vocab_size=49155,
    salo=SALOConfig(window=1024, n_global=4))

SMOKE = dataclasses.replace(
    CONFIG, name="granite-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=256,
    salo=SALOConfig(window=16, n_global=2, block_q=32, block_k=32),
    param_dtype="float32", compute_dtype="float32")
