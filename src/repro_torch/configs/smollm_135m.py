"""smollm-135m [dense] — llama-arch small; also the ~100M end-to-end
training example. [hf:HuggingFaceTB/SmolLM-135M; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig, SALOConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense", n_layers=30, d_model=576,
    n_heads=9, n_kv_heads=3, d_ff=1536, vocab_size=49152,
    tie_embeddings=True, salo=SALOConfig(window=1024, n_global=4))

SMOKE = dataclasses.replace(
    CONFIG, name="smollm-smoke", n_layers=2, d_model=48, n_heads=3,
    n_kv_heads=1, d_ff=96, vocab_size=256,
    salo=SALOConfig(window=16, n_global=2, block_q=32, block_k=32),
    param_dtype="float32", compute_dtype="float32")
