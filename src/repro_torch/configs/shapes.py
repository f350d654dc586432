"""Assigned input shapes (LM-family: seq_len x global_batch); a copy of ``repro.configs.shapes``.

``decode_*`` / ``long_*`` lower ``decode_step`` (one new token against a KV
cache of seq_len); ``prefill_32k`` lowers ``prefill_step``; ``train_4k``
lowers ``train_step``. ``long_500k`` is defined only for sub-quadratic archs
(ssm / hybrid here); full-attention archs record the skip.
"""
from __future__ import annotations

from dataclasses import dataclass

from .base import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def cell_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable, reason-if-skipped). Encoder-only archs would skip decode
    shapes, but none are assigned; whisper is enc-dec and decodes."""
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, "long_500k requires sub-quadratic attention (ssm/hybrid only)"
    return True, ""


def all_cells() -> list:
    from . import ARCHS

    cells = []
    for arch in sorted(ARCHS):
        cfg = ARCHS[arch]["full"]
        for shape in SHAPES.values():
            ok, reason = cell_applicable(cfg, shape)
            cells.append((arch, shape.name, ok, reason))
    return cells
