"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]. SALO inapplicable (DESIGN.md §5)."""
import dataclasses
from repro_torch.configs.base import ModelConfig, SSMConfig, SALOConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm", n_layers=48, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=0, vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2),
    salo=SALOConfig(enabled=False), tie_embeddings=True)

SMOKE = dataclasses.replace(
    CONFIG, name="mamba2-smoke", n_layers=2, d_model=64, vocab_size=256,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=16),
    param_dtype="float32", compute_dtype="float32")
