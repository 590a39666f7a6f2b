"""Assigned architecture configs (+ shape sets).

Every config is selectable via ``--arch <id>`` in the launchers."""

from .base import SHAPES, ModelConfig, MoEConfig, ShapeConfig, reduced
from . import (
    granite_moe_1b_a400m, kimi_k2_1t_a32b, yi_9b, internlm2_1_8b,
    minicpm_2b, qwen1_5_32b, whisper_base, zamba2_1_2b, xlstm_125m,
    internvl2_2b,
)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        granite_moe_1b_a400m, kimi_k2_1t_a32b, yi_9b, internlm2_1_8b,
        minicpm_2b, qwen1_5_32b, whisper_base, zamba2_1_2b, xlstm_125m,
        internvl2_2b,
    )
}

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "MoEConfig", "ShapeConfig", "reduced"]
