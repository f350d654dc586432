"""Configs of the architectures the port runs so far (copies of ``repro.configs``).

``get_config(arch_id)`` returns the published config; ``get_reduced(arch_id)``
the smoke-test reduction of the same family. Architectures the port has not
reached raise a ``KeyError`` that says so.
"""
from .base import ARCHS, ModelConfig  # noqa: F401

# importing each module populates ARCHS
from . import deepseek_67b, mamba2_2_7b, qwen1_5_0_5b, qwen2_0_5b, zamba2_2_7b  # noqa: F401,E402

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
