"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8, shared
expert, leading dense layer. [arXiv:2501.kimi2; unverified]"""
import dataclasses
from repro_torch.configs.base import ModelConfig, MoEConfig, SALOConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=7168, vocab_size=163840,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048,
                  n_shared_experts=1, first_k_dense=1),
    salo=SALOConfig(window=1024, n_global=4))

SMOKE = dataclasses.replace(
    CONFIG, name="kimi-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                  n_shared_experts=1, first_k_dense=1),
    salo=SALOConfig(window=16, n_global=2, block_q=32, block_k=32),
    param_dtype="float32", compute_dtype="float32")
