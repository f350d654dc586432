"""Mamba2 block (SSD mixer + depthwise causal conv + gated norm).

Port of ``repro.models.mamba2``. Projections are separate weights
(wz/wx/wB/wC/wdt) as in the reference, the conv runs over the concatenated
[x, B, C] channels, and the reference's rounding points are kept: the conv
is a sum of shifted products in the activation dtype, silu runs in float32
and is cast back before the split, the SSD scan and the gated norm compute in
float32. The prefill scan goes through ``kernels.ssd.ops.ssd`` (the Hopper
kernel on CUDA tensors); decode is the plain one-token recurrence, as in JAX.
Decode writes the new conv window and SSM state into the caller's cache in
place, where JAX returns new arrays.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.ssd import ops as ssd_ops
from ..sharding import partition
from ..sharding.local import local_call, unflatten
from . import layers


def dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    H = s.n_heads(cfg.d_model)
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, H, conv_dim


def init_mamba2(gen, cfg: ModelConfig, device, lead: Tuple[int, ...] = ()):
    s, d_in, H, conv_dim = dims(cfg)
    D = cfg.d_model
    dt = layers.dtype_of(cfg)
    gn = s.n_groups * s.d_state
    f32 = torch.float32

    def per_layer(v: torch.Tensor) -> torch.Tensor:
        return v.expand(*lead, *v.shape).clone()

    return {
        "wz": layers.dense_init(gen, (*lead, D, d_in), D, dt, device),
        "wx": layers.dense_init(gen, (*lead, D, d_in), D, dt, device),
        "wB": layers.dense_init(gen, (*lead, D, gn), D, dt, device),
        "wC": layers.dense_init(gen, (*lead, D, gn), D, dt, device),
        "wdt": layers.dense_init(gen, (*lead, D, H), D, dt, device),
        "conv_w": (torch.randn((*lead, conv_dim, s.conv_kernel), generator=gen, dtype=f32,
                               device=device) * s.conv_kernel ** -0.5).to(dt),
        "conv_b": torch.zeros((*lead, conv_dim), dtype=dt, device=device),
        "A_log": per_layer(torch.log(torch.linspace(1.0, 16.0, H, dtype=f32, device=device))),
        "D": torch.ones((*lead, H), dtype=f32, device=device),
        # softplus^-1(0.01)
        "dt_bias": per_layer(torch.log(torch.expm1(torch.full((H,), 0.01, dtype=f32,
                                                              device=device)))),
        "norm": torch.ones((*lead, d_in), dtype=f32, device=device),
        "out_proj": layers.dense_init(gen, (*lead, d_in, D), d_in, dt, device),
    }


def mamba2_specs(cfg: ModelConfig) -> dict:
    """Logical axes of ``init_mamba2``'s tree (\"ssm_inner\" and \"ssm_conv\"
    have no rule: replicated)."""
    return {
        "wz": ("embed", "ssm_inner"), "wx": ("embed", "ssm_inner"), "wB": ("embed", None),
        "wC": ("embed", None), "wdt": ("embed", "ssm_heads"), "conv_w": ("ssm_conv", None),
        "conv_b": ("ssm_conv",), "A_log": ("ssm_heads",), "D": ("ssm_heads",),
        "dt_bias": ("ssm_heads",), "norm": ("ssm_inner",), "out_proj": ("ssm_inner", "embed"),
    }


def decode_state_specs(cfg: ModelConfig) -> dict:
    """Logical axes of one layer's ``init_decode_state``."""
    return {"conv": ("batch", None, "ssm_conv"), "ssm": ("batch", "ssm_heads", None, None)}


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    yf = y.float() * F.silu(z.float())
    var = (yf * yf).mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale).to(y.dtype)


def _causal_depthwise_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """xbc: (B, S, Cd); w: (Cd, K). Causal: output[t] uses inputs [t-K+1, t].
    A sum of shifted products in xbc's dtype, as the reference writes it; not
    ``F.conv1d``, which accumulates bf16 in float32 and runs float32 through
    cuDNN in TF32 by default."""
    K = w.shape[-1]
    S = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[:, i] for i in range(K))
    return out + b


def _dt_and_A(dt: torch.Tensor, p) -> Tuple[torch.Tensor, torch.Tensor]:
    # F.softplus returns its input above 20 where jax.nn.softplus does not; the
    # difference there is log1p(exp(-x)) < 2.1e-9, below float32's resolution
    dt_act = F.softplus(dt.float() + p["dt_bias"])
    return dt_act, -torch.exp(p["A_log"])


def mamba2_block(p, x: torch.Tensor, cfg: ModelConfig, *, return_state: bool = False,
                 impl: str = "auto") -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B, S, D) -> (out (B, S, D), {"conv": (B, K-1, Cd), "ssm": (B, H, P, N)}
    or None)."""
    s, d_in, H, conv_dim = dims(cfg)
    gn = s.n_groups * s.d_state
    B_, S, _ = x.shape

    z = x @ p["wz"]
    xin = x @ p["wx"]
    Bm = x @ p["wB"]
    Cm = x @ p["wC"]
    dt = x @ p["wdt"]

    xbc = torch.cat([xin, Bm, Cm], dim=-1)

    def conv_silu_split(xbc, w, b):
        xbc = F.silu(_causal_depthwise_conv(xbc, w, b).float()).to(x.dtype)
        return torch.split(xbc, [d_in, gn, gn], dim=-1)

    if partition.is_dtensor(xbc):
        # on a mesh: on each rank's rows (the conv's pad and shifted slices
        # mix the sequence and the split the channels)
        xin, Bm, Cm = local_call(conv_silu_split, [xbc, p["conv_w"], p["conv_b"]],
                                 ["b..", "..", "."], ("b..", "b..", "b.."))
    else:
        xin, Bm, Cm = conv_silu_split(xbc, p["conv_w"], p["conv_b"])

    xh = unflatten(xin, -1, (H, s.head_dim))
    xh = partition.shard_act(xh, "batch", "seq", "ssm_heads", None)
    Bg = unflatten(Bm, -1, (s.n_groups, s.d_state))
    Cg = unflatten(Cm, -1, (s.n_groups, s.d_state))
    dt_act, A = _dt_and_A(dt, p)

    # pad S to a chunk multiple; dt = 0 at pads -> decay 1, contribution 0, so
    # outputs and the final state are unaffected
    chunk = min(s.chunk, S)
    pad = (-S) % chunk
    xs, Bs, Cs, dts = xh, Bg, Cg, dt_act
    if pad:
        def zpad(a):
            return F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
        xs, Bs, Cs, dts = zpad(xh), zpad(Bg), zpad(Cg), zpad(dt_act)
    y, final_state = ssd_ops.ssd(xs, dts, A, Bs, Cs, chunk=chunk,
                                 return_final_state=return_state, impl=impl)
    y = y[:, :S]
    y = y + xh * p["D"][:, None].to(y.dtype)
    y = y.reshape(B_, S, d_in)
    y = _gated_norm(y, z, p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]

    state = None
    if return_state:
        # the conv cache holds the last K-1 *pre-activation* conv inputs (the raw
        # projections), recomputed from the tail. Where the prompt is shorter
        # than K-1, the reference (mamba2.py:133-140) keeps a shorter tail that
        # kv_cache.insert_sequence then zero-pads at the END (kv_cache.py:51-57);
        # the causal conv needs the zeros at the START, so the port left-pads
        # here. For S >= K-1 this is exactly the reference's tail.
        tail = x[:, -(s.conv_kernel - 1):]
        raw_tail = torch.cat([tail @ p["wx"], tail @ p["wB"], tail @ p["wC"]], dim=-1)
        short = s.conv_kernel - 1 - raw_tail.shape[1]
        if short:
            raw_tail = F.pad(raw_tail, (0, 0, short, 0))
        state = {"conv": raw_tail, "ssm": final_state}
    return out, state


def mamba2_decode(p, x: torch.Tensor, state: dict, cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """One token. x (B, 1, D); ``state`` ({"conv": (B, K-1, Cd), "ssm": (B, H,
    P, N)}) is updated in place. Returns (out (B, 1, D), state)."""
    s, d_in, H, conv_dim = dims(cfg)
    gn = s.n_groups * s.d_state
    B_ = x.shape[0]
    x0 = x[:, 0]

    z = x0 @ p["wz"]
    xin = x0 @ p["wx"]
    Bm = x0 @ p["wB"]
    Cm = x0 @ p["wC"]
    dt = x0 @ p["wdt"]

    raw = torch.cat([xin, Bm, Cm], dim=-1)                           # (B, Cd)
    window = torch.cat([state["conv"], raw[:, None, :]], dim=1)      # (B, K, Cd)
    conv_out = torch.einsum("bkc,ck->bc", window, p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(conv_out.float()).to(x.dtype)
    xin, Bm, Cm = torch.split(conv_out, [d_in, gn, gn], dim=-1)

    xh = xin.reshape(B_, H, s.head_dim)
    Bg = Bm.reshape(B_, s.n_groups, s.d_state)
    Cg = Cm.reshape(B_, s.n_groups, s.d_state)
    dt_act, A = _dt_and_A(dt, p)

    y, new_ssm = ssd_ops.ssd_decode(state["ssm"], xh, dt_act, A, Bg, Cg)
    y = y + xh * p["D"][:, None].to(y.dtype)
    y = y.reshape(B_, d_in)
    y = _gated_norm(y, z, p["norm"], cfg.norm_eps)
    out = (y @ p["out_proj"])[:, None, :]

    state["conv"].copy_(window[:, 1:])
    state["ssm"].copy_(new_ssm)
    return out, state


def init_decode_state(cfg: ModelConfig, batch: int, device,
                      lead: Tuple[int, ...] = ()) -> dict:
    """Zero state for one mamba2 layer; ``lead`` stacks it (the model passes
    ``(n_layers,)``). The JAX version also returns its logical specs:
    ``decode_state_specs``."""
    s, d_in, H, conv_dim = dims(cfg)
    return {
        "conv": torch.zeros((*lead, batch, s.conv_kernel - 1, conv_dim),
                            dtype=layers.dtype_of(cfg), device=device),
        "ssm": torch.zeros((*lead, batch, H, s.head_dim, s.d_state), dtype=torch.float32,
                           device=device),
    }
