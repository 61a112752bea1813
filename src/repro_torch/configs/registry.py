"""Architecture registry: maps ``--arch`` ids to configs.

Also owns the per-arch shape applicability rules from the assignment:
``long_500k`` needs sub-quadratic sequence mixing, so it only runs for
the SSM/hybrid archs (skips recorded, not silently dropped).
"""

from __future__ import annotations

from .base import SHAPES, ModelConfig, ShapeConfig
from .chatglm3_6b import CONFIG as chatglm3_6b
from .internlm2_20b import CONFIG as internlm2_20b
from .jamba_v01_52b import CONFIG as jamba_v01_52b
from .kimi_k2_1t_a32b import CONFIG as kimi_k2_1t_a32b
from .mistral_nemo_12b import CONFIG as mistral_nemo_12b
from .nemotron_4_15b import CONFIG as nemotron_4_15b
from .qwen2_vl_2b import CONFIG as qwen2_vl_2b
from .qwen3_moe_235b_a22b import CONFIG as qwen3_moe_235b_a22b
from .whisper_small import CONFIG as whisper_small
from .xlstm_125m import CONFIG as xlstm_125m

__all__ = ["ARCHS", "get_arch", "cells", "cell_supported"]

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in (
        xlstm_125m, jamba_v01_52b, chatglm3_6b, internlm2_20b,
        mistral_nemo_12b, nemotron_4_15b, qwen3_moe_235b_a22b,
        kimi_k2_1t_a32b, qwen2_vl_2b, whisper_small,
    )
}

# Families whose sequence mixing is sub-quadratic end-to-end.
_SUBQUADRATIC = {"ssm", "hybrid"}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(supported, reason-if-not) for one (arch x shape) cell."""
    if shape.name == "long_500k" and cfg.family not in _SUBQUADRATIC:
        return False, ("long_500k requires sub-quadratic attention; "
                       f"{cfg.name} is full-attention ({cfg.family}) — "
                       "skip per assignment, DESIGN.md §6")
    return True, ""


def cells():
    """All 40 (arch, shape) cells with support flags."""
    out = []
    for cfg in ARCHS.values():
        for shape in SHAPES.values():
            ok, why = cell_supported(cfg, shape)
            out.append((cfg, shape, ok, why))
    return out
