"""Architecture registry: ``--arch <id>`` -> ModelConfig. Lists every
architecture of the reference's registry."""
from repro_torch.configs.base import (ModelConfig, MoEConfig, SSMConfig,
                                      RecurrentConfig, SALOConfig, ShapeCell,
                                      SHAPES, SHAPES_BY_NAME)

ARCHS = ("smollm-135m", "gemma-7b", "phi4-mini-3.8b", "granite-3-8b",
         "longformer-4k", "recurrentgemma-9b", "mamba2-370m", "arctic-480b",
         "kimi-k2-1t-a32b", "qwen2-vl-2b", "whisper-base")

_MODULES = {
    "smollm-135m": "smollm_135m",
    "gemma-7b": "gemma_7b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "granite-3-8b": "granite_3_8b",
    "longformer-4k": "longformer_4k",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mamba2-370m": "mamba2_370m",
    "arctic-480b": "arctic_480b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "whisper-base": "whisper_base",
}


def _module(name: str):
    import importlib
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


def with_dilation(cfg: ModelConfig, dilation: int) -> ModelConfig:
    """``cfg`` with its attention at ``dilation``: a reordered schedule
    where it is above 1 (no published config sets one)."""
    import dataclasses
    return dataclasses.replace(cfg, salo=dataclasses.replace(
        cfg.salo, dilation=dilation))
