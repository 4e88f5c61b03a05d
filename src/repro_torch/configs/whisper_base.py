"""whisper-base [audio] — enc-dec, conv frontend stubbed (input_specs
supplies precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
import dataclasses
from repro_torch.configs.base import ModelConfig, SALOConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio", n_layers=6, d_model=512,
    n_heads=8, n_kv_heads=8, d_ff=2048, vocab_size=51865, act="gelu",
    encoder_decoder=True, n_audio_frames=1500,
    salo=SALOConfig(window=512, n_global=4, bidirectional=True))

SMOKE = dataclasses.replace(
    CONFIG, name="whisper-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=256, n_audio_frames=32,
    salo=SALOConfig(window=16, n_global=2, bidirectional=True,
                    block_q=32, block_k=32),
    param_dtype="float32", compute_dtype="float32")
