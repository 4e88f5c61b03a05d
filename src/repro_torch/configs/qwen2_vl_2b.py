"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution (vision frontend stubbed:
input_specs supplies patch embeddings aligned to token slots).
[arXiv:2409.12191; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig, SALOConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm", n_layers=28, d_model=1536,
    n_heads=12, n_kv_heads=2, head_dim=128, d_ff=8960, vocab_size=151936,
    mrope_sections=(16, 24, 24), n_vision_tokens=1024,
    salo=SALOConfig(window=1024, n_global=4))

SMOKE = dataclasses.replace(
    CONFIG, name="qwen2vl-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
    mrope_sections=(2, 3, 3), n_vision_tokens=16,
    salo=SALOConfig(window=16, n_global=2, block_q=32, block_k=32),
    param_dtype="float32", compute_dtype="float32")
