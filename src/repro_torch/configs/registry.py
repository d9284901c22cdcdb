"""--arch registry: full configs, smoke variants, long-context variants,
and per-(arch × shape) applicability (which pairs the dry-run runs): the
port's copy of the JAX package's configs/registry.py and its ten LM
config modules."""
from __future__ import annotations

import importlib
from typing import Dict, Optional, Tuple

from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig

_MODULES = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "llama3-405b": "llama3_405b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "zamba2-7b": "zamba2_7b",
    "whisper-base": "whisper_base",
    "internvl2-2b": "internvl2_2b",
    "granite-20b": "granite_20b",
    "minicpm3-4b": "minicpm3_4b",
    "mamba2-1.3b": "mamba2_1_3b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
}

ARCH_NAMES = tuple(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; have {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _mod(arch).SMOKE


def get_long_context(arch: str) -> Optional[ModelConfig]:
    """Sliding-window variant for long_500k, if the arch defines one."""
    return getattr(_mod(arch), "LONG_CONTEXT", None)


def config_for_shape(arch: str, shape_name: str
                     ) -> Tuple[Optional[ModelConfig], str]:
    """Resolve the config used for a given input shape.

    Returns (config|None, note). None = pair skipped per the assignment
    (long_500k on pure full-attention archs without a SWA variant)."""
    shape = INPUT_SHAPES[shape_name]
    cfg = get_config(arch)
    if shape.name != "long_500k":
        return cfg, ""
    if cfg.supports_long_context():
        if cfg.arch_type in ("ssm", "hybrid"):
            return cfg, "native sub-quadratic (SSM state)"
        return cfg, "sliding-window attention"
    lc = get_long_context(arch)
    if lc is not None:
        return lc, "sliding-window variant (assignment carve-out)"
    return None, ("skipped: pure full-attention arch, no sub-quadratic "
                  "variant (see DESIGN.md §Arch-applicability)")


def all_pairs():
    """The 10 x 4 assignment grid with resolved configs."""
    for arch in ARCH_NAMES:
        for shape_name in INPUT_SHAPES:
            cfg, note = config_for_shape(arch, shape_name)
            yield arch, shape_name, cfg, note
