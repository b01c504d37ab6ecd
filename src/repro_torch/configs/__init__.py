"""Assigned architecture configs + input shapes + reduced smoke configs.

``get_config(name)`` returns the exact published configuration;
``get_smoke_config(name)`` returns a tiny same-family config for CPU
tests; ``SHAPES`` defines the 4 assigned input shapes.

The port's copy of the JAX package's ``configs/``: the ten config
modules are the same data, built on ``repro_torch.models.config``.
"""
from __future__ import annotations

import dataclasses
import importlib

ARCHS = (
    "qwen2_0_5b", "llama3_2_3b", "yi_9b", "qwen3_14b", "zamba2_2_7b",
    "deepseek_v2_236b", "phi3_5_moe_42b", "chameleon_34b", "mamba2_780m",
    "whisper_medium",
)

# canonical ids from the assignment table -> module names
ALIASES = {
    "qwen2-0.5b": "qwen2_0_5b",
    "llama3.2-3b": "llama3_2_3b",
    "yi-9b": "yi_9b",
    "qwen3-14b": "qwen3_14b",
    "zamba2-2.7b": "zamba2_2_7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "chameleon-34b": "chameleon_34b",
    "mamba2-780m": "mamba2_780m",
    "whisper-medium": "whisper_medium",
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def _module(name: str):
    name = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).SMOKE


def shape_applicable(arch: str, shape: str) -> tuple[bool, str]:
    """Whether a (arch, shape) cell runs; reason if skipped (DESIGN.md
    §Arch-applicability)."""
    cfg = get_config(name=arch)
    spec = SHAPES[shape]
    if shape == "long_500k":
        # needs sub-quadratic attention: ssm/hybrid run (O(1) state decode
        # or DDM-planned windowed attention); pure full-attention skip.
        if cfg.family in ("ssm", "hybrid"):
            return True, ""
        return False, ("pure full-attention arch: long_500k requires "
                       "sub-quadratic attention (DESIGN.md)")
    return True, ""
