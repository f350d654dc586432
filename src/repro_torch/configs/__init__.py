"""Configs of the architectures the port runs (copies of ``repro.configs``) + shape sets.

``get_config(arch_id)`` returns the published config; ``get_reduced(arch_id)``
the smoke-test reduction of the same family. Architectures the port has not
reached raise a ``KeyError`` that says so. ``SHAPES`` are the reference's
assigned cells (``shapes.py``).
"""
from .base import ARCHS, ModelConfig  # noqa: F401

# importing each module populates ARCHS
from . import (  # noqa: F401,E402
    deepseek_67b, internvl2_26b, mamba2_2_7b, minicpm3_4b, qwen1_5_0_5b, qwen2_0_5b,
    qwen2_moe_a2_7b, qwen3_moe_235b, whisper_small, zamba2_2_7b,
)
from .shapes import SHAPES, ShapeSpec, all_cells, cell_applicable  # noqa: F401,E402

ARCH_IDS = tuple(sorted(ARCHS))


def _lookup(arch_id: str, which: str) -> ModelConfig:
    try:
        return ARCHS[arch_id][which]
    except KeyError:
        raise KeyError(
            f"arch {arch_id!r} is not ported to repro_torch; ported: {ARCH_IDS}"
        ) from None


def get_config(arch_id: str) -> ModelConfig:
    return _lookup(arch_id, "full")


def get_reduced(arch_id: str) -> ModelConfig:
    return _lookup(arch_id, "reduced")
