"""Config registry: ``--arch <id>`` resolves here (the port's copy of the
JAX package's ``configs``)."""
from __future__ import annotations

from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeConfig,
                                     shape_applicable, torch_dtype)
from repro_torch.configs import (
    nemotron_4_15b,
    gemma3_1b,
    deepseek_67b,
    yi_9b,
    hymba_1_5b,
    llama4_maverick_400b_a17b,
    qwen3_moe_235b_a22b,
    xlstm_1_3b,
    internvl2_26b,
    whisper_medium,
)

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        nemotron_4_15b,
        gemma3_1b,
        deepseek_67b,
        yi_9b,
        hymba_1_5b,
        llama4_maverick_400b_a17b,
        qwen3_moe_235b_a22b,
        xlstm_1_3b,
        internvl2_26b,
        whisper_medium,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


__all__ = ["ARCHS", "SHAPES", "ArchConfig", "ShapeConfig", "get_arch",
           "get_shape", "shape_applicable", "torch_dtype"]
