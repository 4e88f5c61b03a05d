"""arctic-480b [moe] — 128 experts top-2 + dense residual.
[hf:Snowflake/snowflake-arctic-base; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig, MoEConfig, SALOConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe", n_layers=35, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=4864, vocab_size=32000,
    moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                  dense_residual=True),
    salo=SALOConfig(window=1024, n_global=4))

SMOKE = dataclasses.replace(
    CONFIG, name="arctic-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=256,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128,
                  dense_residual=True),
    salo=SALOConfig(window=16, n_global=2, block_q=32, block_k=32),
    param_dtype="float32", compute_dtype="float32")
