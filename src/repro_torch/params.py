"""Carry weights across: a JAX ``Model.init`` pytree -> the port's state dict.

The JAX parameters arrive as nested dicts of numpy arrays (``jax.tree.map(
np.asarray, params)``); the result is keyed by the pytree path joined with
``.`` (``layers.attn.wq``), which is exactly ``repro_torch.models.model.Model``'s
``state_dict`` layout, layers stacked on axis 0. The hybrid's keys follow its
pytree too: ``layers.mamba.*`` stacked ``(G, PG, ...)`` and the one shared
dense block unstacked under ``shared.*``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

# leaves the JAX init keeps in float32 whatever the model dtype: the norm
# scales, and the SSM's decay, skip, step-bias and gated-norm scale
# (repro/models/mamba2.py:44-47)
FP32_LEAVES = ("scale", "q_norm", "k_norm", "A_log", "D", "dt_bias", "norm")


def to_tensor(a, device="cuda") -> torch.Tensor:
    """numpy (or ml_dtypes bfloat16) array -> tensor, bit for bit.

    ``np.asarray`` of a JAX bf16 array is an ``ml_dtypes.bfloat16`` array,
    which ``torch.from_numpy`` rejects: it goes through a ``uint16`` view."""
    a = np.array(a)  # a writable, contiguous copy (JAX hands out read-only views)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    out: Dict[str, object] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, name + "."))
        else:
            out[name] = v
    return out


def to_state_dict(tree: Mapping, device="cuda",
                  dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Nested numpy pytree -> flat state dict on `device`.

    With `dtype` None every leaf keeps its own dtype (bit-exact carry-over);
    otherwise floating leaves are cast to `dtype`, except ``FP32_LEAVES``,
    which stay float32 as in the JAX init."""
    sd = {}
    for name, a in flatten(tree).items():
        t = to_tensor(a, device)
        if dtype is not None and t.is_floating_point() and name.split(".")[-1] not in FP32_LEAVES:
            t = t.to(dtype)
        sd[name] = t
    return sd

