"""Architecture registry: one module per assigned architecture.

``get_config(arch_id)`` returns the exact published config;
``get_config(arch_id, reduced=True)`` the CPU smoke-test version.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ArchConfig, SHAPES, ShapeCell

ARCH_IDS: List[str] = [
    "seamless_m4t_medium",
    "gemma3_12b",
    "starcoder2_15b",
    "qwen3_32b",
    "nemotron_4_340b",
    "dbrx_132b",
    "qwen2_moe_a2_7b",
    "rwkv6_1_6b",
    "internvl2_76b",
    "hymba_1_5b",
]

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def get_config(arch_id: str, reduced: bool = False) -> ArchConfig:
    arch_id = _ALIASES.get(arch_id, arch_id)
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f".{arch_id}", __package__)
    cfg: ArchConfig = mod.CONFIG
    return cfg.reduced() if reduced else cfg


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def cells(arch_id: str):
    """The shape cells that apply to this arch (skips recorded in dry-run)."""
    cfg = get_config(arch_id)
    out = []
    for name, cell in SHAPES.items():
        if name == "long_500k" and not cfg.subquadratic:
            out.append((cell, "skip: pure full-attention arch — a 500k dense "
                              "KV cache targets the sub-quadratic regime "
                              "(DESIGN.md §4)"))
        else:
            out.append((cell, None))
    return out
