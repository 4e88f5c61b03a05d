"""Config system: one frozen dataclass describes any supported architecture.

``--arch <id>`` resolves through :func:`repro_torch.configs.get_config`.
Every ported architecture gets a module ``configs/<id>.py`` exporting
``CONFIG`` (the exact published shape) and ``SMOKE`` (a reduced same-family
config for CPU tests). Shapes (seq x batch cells) live in ``SHAPES``.
A verbatim copy of the JAX package's config dataclasses, so a config reads
the same in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    n_shared_experts: int = 0      # kimi/deepseek-style shared expert
    first_k_dense: int = 0         # kimi: leading dense layers
    router_z_coef: float = 1e-3
    load_balance_coef: float = 1e-2
    # Dispatch locality: tokens are split into this many groups (aligned
    # with the DP sharding) and each group routes/sorts independently —
    # no global sort, no cross-shard scatter (models/moe.py).
    dispatch_groups: int = 16


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class RecurrentConfig:
    """RG-LRU (RecurrentGemma) settings; layers follow (rec, rec, attn)."""
    d_rnn: Optional[int] = None     # defaults to d_model
    conv_width: int = 4
    block_pattern: Tuple[str, ...] = ("rec", "rec", "attn")
    local_window: int = 2048


@dataclasses.dataclass(frozen=True)
class SALOConfig:
    """How the paper's technique is applied to this architecture."""
    enabled: bool = True
    window: int = 4096              # sliding window size (causal: lookback)
    n_global: int = 4               # global tokens / attention sinks
    dilation: int = 1
    bidirectional: bool = False     # encoders: symmetric window
    global_rows: bool = False       # Longformer-style global queries
    impl: str = "blockwise"         # blockwise | pallas | dense_ref
    block_q: int = 256
    block_k: int = 256
    # SALO windowed decode: read only window+sinks cache slots per step
    # (O(w) HBM traffic instead of O(n); core/attention.py decode path).
    decode_slice: bool = False
    # SALO ring cache: the KV cache itself has window+sinks slots — O(w)
    # memory at ANY context length (the paper's pattern as a cache layout).
    ring_cache: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    act: str = "swiglu"             # swiglu | geglu | gelu
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None   # gemma-style
    salo: SALOConfig = SALOConfig()
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    recurrent: Optional[RecurrentConfig] = None
    # enc-dec (whisper): n_layers applies to each side
    encoder_decoder: bool = False
    n_audio_frames: int = 1500      # stub frontend output length
    # vlm (qwen2-vl)
    mrope_sections: Optional[Tuple[int, int, int]] = None
    n_vision_tokens: int = 0        # stub patch embeddings per sample
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # remat policy for the layer scan: "none" | "full" | "dots"
    remat: str = "full"

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else (
            self.d_model // self.n_heads)

    def n_params(self) -> int:
        """Total parameter count (embedding included)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.hd
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads \
            + hd * self.n_heads * d
        mlp_mults = {"swiglu": 3, "geglu": 3, "gelu": 2}[self.act]
        dense_mlp = mlp_mults * d * f
        per_layer = attn + dense_mlp + 2 * d
        total = self.n_layers * per_layer
        if self.moe is not None:
            m = self.moe
            expert = mlp_mults * d * m.d_ff_expert
            moe_layers = self.n_layers - m.first_k_dense
            total += moe_layers * (m.n_experts + m.n_shared_experts) * expert
            total += moe_layers * d * m.n_experts  # router
            if not m.dense_residual:
                total -= moe_layers * dense_mlp    # MoE replaces dense FFN
        if self.ssm is not None:
            di = self.ssm.expand * d
            total = self.n_layers * (2 * d * di + di * d + 2 * d) + 0
        total += v * d * (1 if self.tie_embeddings else 2)
        if self.encoder_decoder:
            total *= 2  # encoder + decoder stacks (approximation)
        return int(total)

    def n_active_params(self) -> int:
        """Active-per-token parameters (MoE: top_k experts only)."""
        if self.moe is None:
            return self.n_params()
        m = self.moe
        mlp_mults = {"swiglu": 3, "geglu": 3, "gelu": 2}[self.act]
        expert = mlp_mults * self.d_model * m.d_ff_expert
        moe_layers = self.n_layers - m.first_k_dense
        inactive = moe_layers * (m.n_experts - m.top_k) * expert
        return int(self.n_params() - inactive)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture x input-shape) dry-run cell."""
    name: str                       # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}
