"""Roofline terms, FLOP counts, collectives and the memory fit of one cell.

Port of ``repro.launch.analysis``. Three terms, in per-device seconds:

    compute    = flops_per_device / peak_flops   (the bf16 dense tensor-core rate)
    memory     = hbm_bytes / hbm_bw              (``modeled_hbm_bytes``: the fused traffic)
    collective = wire_bytes / nvlink_bw + pod_wire_bytes / ib_bw

On one device the collective term is 0. On a mesh the wire bytes come from
the collectives the traced step issues (``trace_collectives``), summed with
the reference's ring-algorithm factors (``parse_collectives``, which is
also kept, reads them from XLA's HLO text):

    all-reduce      2·S·(n-1)/n      (reduce-scatter + all-gather phases)
    all-gather      R·(n-1)/n        (R = result bytes)
    reduce-scatter  R·(n-1)          (input = n·R; each device moves (n-1)·R)
    all-to-all      R·(n-1)/n
    collective-permute  R

A collective over a group that spans the ``pod`` axis crosses the
InfiniBand fabric; every other one stays on NVLink within a node.

FLOPs (the counterpart of ``extract_costs`` / ``analyze_compiled``):
``trace_costs`` runs a cell's ``BuiltStep.fn`` on its meta stand-ins under
``torch.utils.flop_counter.FlopCounterMode``; on a mesh (meta DTensors under
a fake process group) it counts each rank's local ops instead, since
``FlopCounterMode`` over a DTensor counts the global op. The model is built on the meta
device with ``kernel_impl="ref"``, so every kernel call takes its plain
version and nothing reaches a ctypes launch; shapes flow, no storage is
allocated, so a full-size cell costs no memory. It counts the matrix
products (``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions, attention),
forward, remat's recompute and backward, and no elementwise work.

Memory (the counterpart of ``memory_analysis``): ``memory_fit`` adds the
weights, for ``train`` the fp32 master and moments, the gradients and the new
weights, the batch, the cache (``serving.kv_cache.cache_bytes``) and a
modeled activation peak (``activation_bytes``), and holds the sum against the
card's memory. Its constants describe the port's own forward (which
intermediates it keeps live), and ``chip_smoke.py`` prints each run cell's
model beside the measured peak.
"""
from __future__ import annotations

import functools
import math
import re
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from ..kernels.flash_attention.kernel import DECODE_SPLIT
from ..serving.kv_cache import cache_bytes
from ..training.optimizer import OptimizerConfig

# one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the 700 W limit)
HW = {
    "name": "NVIDIA H100 80GB HBM3, 700 W",
    "peak_flops_bf16": 989e12,   # FLOP/s, the tensor cores' dense bf16 rate
    "hbm_bw": 3.35e12,           # B/s
    "hbm_bytes": 80e9,           # capacity without a card to ask
    # NVLink 4 within a node: 900 GB/s per GPU, both directions together
    # (NVIDIA's H100 SXM data sheet), so 450 GB/s each way; a device sends
    # its wire bytes while it receives as many
    "nvlink_bw": 450e9,          # B/s per direction
    # across the pod axis: one NDR InfiniBand port of 400 Gb/s per GPU
    # (NVIDIA's DGX H100 reference network), 50 GB/s each way
    "ib_bw": 50e9,               # B/s per direction
}
# the share of the card's memory a cell may plan to use: the allocator's
# rounding and fragmentation, cuBLAS workspaces and the CUDA context take the rest
FIT_SHARE = 0.92


def hbm_capacity() -> float:
    """The card's memory in bytes when a card is present, else HW["hbm_bytes"]."""
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return HW["hbm_bytes"]


_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
_OP_RE = re.compile(
    r"=\s*(?P<result>.*?)\s+(?P<op>all-reduce-start|all-gather-start|"
    r"reduce-scatter|all-to-all|collective-permute-start|collective-permute|"
    r"all-reduce|all-gather)\("
)
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([0-9, ]*)\}")


def _shape_bytes(result: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(result):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d.strip():
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def _group_size(line: str) -> int:
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return max(int(m.group(2)), 1)
    m = _GROUPS_LIST_RE.search(line)
    if m:
        ids = [t for t in m.group(1).split(",") if t.strip()]
        return max(len(ids), 1)
    return 1


def wire_bytes(op: str, result_bytes: float, n: int) -> float:
    """Bytes each of the n devices of a group sends for one collective."""
    if op == "all-reduce":
        return 2 * result_bytes * (n - 1) / n
    if op in ("all-gather", "all-to-all"):
        return result_bytes * (n - 1) / n
    if op == "reduce-scatter":
        return result_bytes * (n - 1)
    return result_bytes  # collective-permute


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=dict)
    result_bytes: Dict[str, int] = field(default_factory=dict)
    wire_bytes: Dict[str, float] = field(default_factory=dict)
    # the wire bytes of the collectives whose group spans the pod axis
    pod_wire_bytes: float = 0.0

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    def add(self, op: str, rbytes: int, n: int, crosses_pod: bool = False) -> None:
        if n <= 1:
            return  # single-participant: no wire traffic
        wire = wire_bytes(op, rbytes, n)
        self.counts[op] = self.counts.get(op, 0) + 1
        self.result_bytes[op] = self.result_bytes.get(op, 0) + rbytes
        self.wire_bytes[op] = self.wire_bytes.get(op, 0) + wire
        if crosses_pod:
            self.pod_wire_bytes += wire

    def to_dict(self) -> dict:
        return {
            "counts": dict(self.counts),
            "result_bytes": dict(self.result_bytes),
            "wire_bytes": {k: int(v) for k, v in self.wire_bytes.items()},
            "total_wire_bytes": int(self.total_wire_bytes),
            "pod_wire_bytes": int(self.pod_wire_bytes),
        }


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """The collectives of XLA's optimized HLO text, as the reference reads them."""
    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        if not any(c in line for c in _COLLECTIVES):
            continue
        m = _OP_RE.search(line)
        if m is None:
            continue
        stats.add(m.group("op").replace("-start", ""), _shape_bytes(m.group("result")),
                  _group_size(line))
    return stats


# torch's functional collectives -> the reference's HLO op names
_FUNCOL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all",
}


def _group_of(name: str):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name)


class _DeviceCounter:
    """A dispatch mode that sees each rank's local ops: it hands every op on
    a DTensor back to DTensor (which then runs the local op, seen here) and
    skips the fake tensors of DTensor's shape propagation. It counts the
    local ops' FLOPs with ``FlopCounterMode``'s formulas (in total, by aten
    op, and by op and local operand shapes: a product a rank computes whole
    shows its full width there) and records each functional collective with
    its group size and result bytes."""

    def __init__(self, pod_groups=()):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return counter._dispatch(func, types, args, kwargs or {})

        self.mode = Mode()
        self.flops = 0
        self.by_op: Dict[str, int] = {}
        self.by_shape: Dict[str, int] = {}
        self.stats = CollectiveStats()
        self.pod_groups = set(pod_groups)

    def _dispatch(self, func, types, args, kwargs):
        import torch.utils._pytree as pytree
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        leaves = pytree.tree_leaves((args, kwargs))
        if any(isinstance(a, FakeTensor) for a in leaves):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            self.by_op[str(packet)] = self.by_op.get(str(packet), 0) + n
            shapes = " x ".join(str(tuple(a.shape)) for a in args if isinstance(a, torch.Tensor))
            key = f"{packet} {shapes}"
            self.by_shape[key] = self.by_shape.get(key, 0) + n
        op = _FUNCOL.get(packet.__name__)
        if op is not None and "c10d_functional" in str(packet):
            # the group's name is the op's last string argument
            group = [a for a in list(args) + list(kwargs.values()) if isinstance(a, str)][-1]
            res = out if isinstance(out, torch.Tensor) else args[0]
            rbytes = res.numel() * res.element_size()
            self.stats.add(op, rbytes, _group_of(group).size(), group in self.pod_groups)
        return out


def _pod_groups(built) -> set:
    """The names of the process groups of a built step's mesh whose ranks
    span its pod axis."""
    mesh = _mesh_of(built)
    if mesh is None or "pod" not in (mesh.mesh_dim_names or ()):
        return set()
    return {mesh.get_group("pod").group_name}


def _mesh_of(built):
    from ..sharding.partition import NamedSharding
    from ..training.optimizer import tree_leaves

    for sh in built.in_shardings or ():
        leaves = tree_leaves(sh) if isinstance(sh, dict) else [sh]
        for leaf in leaves:
            if isinstance(leaf, NamedSharding):
                return leaf.mesh
    return None


def _trace(built) -> _DeviceCounter:
    counter = _DeviceCounter(_pod_groups(built))
    with counter.mode:
        built.fn(*built.abstract_args)
    return counter


def trace_device(built) -> dict:
    """One call of a mesh step on its meta DTensor stand-ins: each rank's
    local FLOPs (total, by aten op, and by op and local operand shapes) and
    its collectives."""
    counter = _trace(built)
    return {"flops_per_device": float(counter.flops), "flops_by_op": dict(counter.by_op),
            "flops_by_shape": dict(counter.by_shape),
            "collectives": counter.stats.to_dict(),
            "wire_bytes_per_device": float(counter.stats.total_wire_bytes),
            "pod_wire_bytes_per_device": float(counter.stats.pod_wire_bytes)}


def trace_collectives(built) -> CollectiveStats:
    """The collectives that one call of a mesh step issues (each
    ``c10d_functional`` op, with its group's size and its result's bytes),
    in a ``CollectiveStats`` with the reference's wire formulas."""
    return _trace(built).stats


def modeled_hbm_bytes(cfg, shape, n_chips: int = 1, model_axis: int = 1) -> dict:
    """Analytic per-device HBM traffic of the fused execution (flash attention
    keeps the S^2 scores on chip; fusions keep elementwise chains out of HBM),
    the reference's model term for term (``model_axis`` 1: one device).

    Terms (documented coarse constants):
      params  train: 8x bf16 param bytes (fwd read, bwd read, remat read,
              grad write) + 24x fp32-equivalent optimizer r/w + 2x write-back
              prefill/decode: one bf16 read
      acts    per layer: residual/proj I/O ~8 D-wide + 4 F-wide passes per
              token, x3 for train (fwd+remat+bwd), x1 inference
      attn    flash traffic: q,k,v,o only (+cache r/w at decode)
    """
    N_loc = cfg.param_count() / n_chips
    data_total = max(n_chips // model_axis, 1)
    bpe = 2  # bf16

    if shape.kind == "train":
        param_traffic = (4 * 2 + 24 + 2) * N_loc  # ~34 bytes/param/step
        tokens_loc = shape.global_batch * shape.seq_len / data_total
        passes = 3
    elif shape.kind == "prefill":
        param_traffic = 2 * N_loc
        tokens_loc = shape.global_batch * shape.seq_len / data_total
        passes = 1
    else:  # decode
        param_traffic = 2 * N_loc
        tokens_loc = shape.global_batch / data_total
        passes = 1

    D = cfg.d_model
    if cfg.family == "moe":
        F_eff = cfg.moe.top_k * cfg.moe.d_ff_expert + (
            cfg.moe.d_ff_shared if cfg.moe.n_shared_experts else 0
        )
    elif cfg.family in ("ssm", "hybrid"):
        F_eff = 2 * cfg.ssm.d_inner(D)
    else:
        F_eff = cfg.d_ff
    act_per_layer = tokens_loc * (8 * D + 4 * F_eff / max(model_axis, 1)) * bpe
    act_traffic = cfg.n_layers * act_per_layer * passes

    cache_traffic = 0.0
    if shape.kind == "decode":
        cache_traffic = 2.0 * cache_bytes(cfg, shape.global_batch, shape.seq_len) / n_chips

    total = param_traffic + act_traffic + cache_traffic
    return {
        "total": float(total),
        "param_traffic": float(param_traffic),
        "act_traffic": float(act_traffic),
        "cache_traffic": float(cache_traffic),
    }


def roofline_terms(flops: float, hbm_bytes: float,
                   model_flops_total: Optional[float] = None, *, wire_bytes: float = 0.0,
                   pod_wire_bytes: float = 0.0, n_chips: int = 1) -> dict:
    """The three per-device terms on H100s (the collective term 0 on one
    device; ``pod_wire_bytes``, the part of ``wire_bytes`` that crosses the
    pod axis, at the InfiniBand rate), the one that binds, the bound (their
    maximum) and, given the model's useful FLOPs, their share of the counted
    FLOPs of all ``n_chips`` and the roofline fraction (useful FLOP/s at the
    bound over the devices' peak)."""
    terms = {"compute_s": flops / HW["peak_flops_bf16"], "memory_s": hbm_bytes / HW["hbm_bw"],
             "collective_s": ((wire_bytes - pod_wire_bytes) / HW["nvlink_bw"]
                              + pod_wire_bytes / HW["ib_bw"])}
    bottleneck = max(terms, key=terms.get)
    out = {**terms, "bottleneck": bottleneck.replace("_s", ""),
           "step_time_lower_bound_s": max(terms.values())}
    if model_flops_total is not None:
        total = flops * n_chips
        out["model_flops_total"] = model_flops_total
        out["useful_flops_ratio"] = model_flops_total / total if total else 0.0
        t = out["step_time_lower_bound_s"]
        out["roofline_fraction"] = (model_flops_total / t / (n_chips * HW["peak_flops_bf16"])
                                    if t > 0 else 0.0)
    return out


def trace_costs(built) -> dict:
    """FLOPs of one call of ``built.fn`` on ``built.abstract_args`` (meta
    tensors), counted by ``FlopCounterMode``: the total and by aten op. A
    step on a mesh is counted per device (``trace_device``)."""
    from torch.utils.flop_counter import FlopCounterMode

    if built.in_shardings is not None:
        return trace_device(built)
    counter = FlopCounterMode(display=False)
    with counter:
        built.fn(*built.abstract_args)
    by_op = {str(op): int(n) for op, n in counter.get_flop_counts().get("Global", {}).items()}
    return {"flops_per_device": float(counter.get_total_flops()), "flops_by_op": by_op}


def extrapolate(base: dict, two_units: dict, units: int) -> dict:
    """Depth calibration: cost(L) = cost(L1) + (units-1) * (cost(L2)-cost(L1)).
    Exact for layer-homogeneous stacks; the wire bytes too, on a mesh. A
    mesh trace's FLOPs by op and by shape give one layer's breakdown."""
    out = {"units": units}
    for k in ("flops_per_device", "wire_bytes_per_device", "pod_wire_bytes_per_device"):
        if k in base:
            delta = two_units[k] - base[k]
            out[k] = base[k] + (units - 1) * delta
            out[k + "_per_layer"] = delta
    for k in ("flops_by_op", "flops_by_shape"):
        if k in base:
            out[k + "_per_layer"] = {key: two_units[k].get(key, 0) - base[k].get(key, 0)
                                     for key in set(base[k]) | set(two_units[k])}
    return out


# ------------------------------------------------------------ memory fit
def _itemsize(dtype: str) -> int:
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


def activation_bytes_per_token(cfg) -> float:
    """Modeled live bytes a token holds at the peak of one layer's forward in
    the port (a = the activation dtype's bytes; fp32 intermediates 4):
    residual stream and norm 3a·D + 4·D, plus the larger of the mixer and the
    MLP. Attention: q, k, v, their fp32 rotary copies and the output,
    a·(2H + 2KV)·hd + 8·(H + KV)·hd. SwiGLU / GELU MLP: h and g, and the
    activation's fp32 input and output while it runs (12·F in bf16), or the
    product beside h, g and the activation (4a·F in fp32). MoE: each routed
    copy (capacity factor x top_k) holds its row, its expert's MLP and its
    output, plus the shared expert and fp32 router probabilities.
    Mamba2: the projections, the conv's padded and shifted partial sums, the
    fp32 SiLU and gated norm, (6a + 8)·(d_inner + 2·G·N)."""
    a = _itemsize(cfg.dtype)
    D = cfg.d_model
    base = 3 * a * D + 4 * D
    if cfg.family == "ssm":
        s = cfg.ssm
        return base + (6 * a + 8) * (s.d_inner(D) + 2 * s.n_groups * s.d_state)
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if cfg.mla is not None:
        m = cfg.mla
        hd, KV = m.qk_nope_dim + m.qk_rope_dim, H
    else:
        hd = cfg.hd
    attn = a * (2 * H + 2 * KV) * hd + 8 * (H + KV) * hd
    mlp = max(2 * a + 8, 4 * a)
    if cfg.family == "moe":
        m = cfg.moe
        copies = m.capacity_factor * m.top_k
        ffn = (copies * (2 * a * D + mlp * m.d_ff_expert) + 4 * m.n_experts
               + (mlp * m.d_ff_shared if m.n_shared_experts else 0))
    else:
        ffn = mlp * cfg.d_ff
    peak = base + max(attn, ffn)
    if cfg.family == "hybrid":
        s = cfg.ssm
        peak = max(peak, base + (6 * a + 8) * (s.d_inner(D) + 2 * s.n_groups * s.d_state))
    return float(peak)


def activation_bytes(cfg, shape, batch: int) -> dict:
    """The modeled activation peak of one step at ``batch`` rows: train (remat
    on: each layer's input kept, one layer's forward recomputed beside its
    backward; off: every layer's working set) with the fp32 logits, their
    log-softmax and gradient; prefill, one layer's working set at full length
    plus the last position's logits; decode, one token's and the decode
    attention's fp32 split scratch."""
    a = _itemsize(cfg.dtype)
    per_tok = activation_bytes_per_token(cfg)
    L = cfg.n_layers + (cfg.n_enc_layers if cfg.family == "encdec" else 0)
    logits_row = 4.0 * cfg.vocab
    if shape.kind == "train":
        T = batch * shape.seq_len
        layers = (L * T * cfg.d_model * a + 3 * T * per_tok if cfg.remat
                  else L * T * per_tok)
        return {"layers": layers, "logits": 3 * T * logits_row}
    if shape.kind == "prefill":
        T = batch * shape.seq_len
        enc = batch * cfg.enc_seq * per_tok if cfg.family == "encdec" else 0.0
        return {"layers": T * per_tok + enc, "logits": batch * logits_row}
    scratch = 0.0
    if cfg.family != "ssm":
        H = cfg.n_heads
        dv = cfg.mla.kv_lora_rank if cfg.mla is not None else cfg.hd
        scratch = batch * math.ceil(shape.seq_len / DECODE_SPLIT) * H * (dv + 2) * 4.0
    return {"layers": batch * per_tok + scratch, "logits": batch * logits_row}


@functools.lru_cache(maxsize=None)
def weight_bytes(cfg) -> tuple:
    """(bytes, elements) of the model's weights, from a meta model."""
    from ..models.model import Model
    meta = Model(cfg, device="meta", kernel_impl="ref")
    return (float(sum(p.numel() * p.element_size() for p in meta.parameters())),
            float(sum(p.numel() for p in meta.parameters())))


def memory_fit(cfg, shape, batch: Optional[int] = None, capacity: Optional[float] = None,
               ocfg: Optional[OptimizerConfig] = None) -> dict:
    """Whether one step of the cell fits the card, with its terms in bytes.
    ``batch`` defaults to the cell's global batch, ``capacity`` to the
    card's memory, ``ocfg`` (the gradients' and moments' dtypes) to the
    optimizer's defaults."""
    B = shape.global_batch if batch is None else batch
    param_bytes, n_elems = weight_bytes(cfg)
    capacity = hbm_capacity() if capacity is None else capacity
    ocfg = ocfg or OptimizerConfig()
    a = _itemsize(cfg.dtype)
    terms: Dict[str, float] = {"params": param_bytes}
    if shape.kind == "train":
        terms["optimizer"] = n_elems * (4 + 2 * _itemsize(ocfg.moments_dtype))
        terms["grads"] = n_elems * _itemsize(ocfg.grad_dtype)
        terms["new_params"] = param_bytes
    if shape.kind in ("train", "prefill"):
        S_tok = shape.seq_len - (cfg.n_patches if cfg.family == "vlm" else 0)
        side = (cfg.enc_seq if cfg.family == "encdec" else
                cfg.n_patches if cfg.family == "vlm" else 0) * cfg.d_model * a
        terms["batch"] = float(B * (S_tok * 4 + side))
    else:
        terms["batch"] = float(B * 4)
    if shape.kind != "train":
        # a prefill returns its cache stacked from the per-layer caches: both
        # are live at the stack
        cache = float(cache_bytes(cfg, B, shape.seq_len))
        terms["cache"] = 2 * cache if shape.kind == "prefill" else cache
    act = activation_bytes(cfg, shape, B)
    terms["activations"] = act["layers"]
    terms["logits"] = act["logits"]
    total = float(sum(terms.values()))
    return {"batch": B, "terms": terms, "total": total, "capacity": capacity,
            "usable": FIT_SHARE * capacity, "fits": total <= FIT_SHARE * capacity}


def memory_fit_mesh(cfg, shape, weight_specs: dict, axes: dict,
                    ocfg: Optional[OptimizerConfig] = None,
                    capacity: Optional[float] = None) -> dict:
    """``memory_fit`` per device of a mesh: the weights, their fp32 master,
    moments, gradients and new weights at each weight's local shard (its
    resolved spec, ``weight_specs`` {key: spec}, over the mesh ``axes``
    {name: size}); the batch, activations and cache at the device's share of
    the batch (the data-parallel size: all devices over the model axis), the
    logits also split over the model axis (vocab)."""
    from ..models.model import Model

    ocfg = ocfg or OptimizerConfig()
    capacity = hbm_capacity() if capacity is None else capacity
    n_chips = int(math.prod(axes.values()))
    model_axis = axes.get("model", 1)
    data_total = max(n_chips // model_axis, 1)
    meta = Model(cfg, device="meta", kernel_impl="ref")
    elems = nbytes = 0.0

    def walk(t, prefix):
        nonlocal elems, nbytes
        for k, v in t.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
                continue
            parts = 1
            for entry in weight_specs.get(key, ()):
                for a in (entry if isinstance(entry, list) else [entry]):
                    parts *= axes.get(a, 1) if a else 1
            elems += v.numel() / parts
            nbytes += v.numel() * v.element_size() / parts

    walk(meta.params, "")
    B = max(-(-shape.global_batch // data_total), 1)
    one = memory_fit(cfg, shape, batch=B, capacity=capacity, ocfg=ocfg)["terms"]
    terms: Dict[str, float] = {"params": nbytes}
    if shape.kind == "train":
        terms["optimizer"] = elems * (4 + 2 * _itemsize(ocfg.moments_dtype))
        terms["grads"] = elems * _itemsize(ocfg.grad_dtype)
        terms["new_params"] = nbytes
    terms["batch"] = one["batch"]
    if "cache" in one:
        terms["cache"] = one["cache"] * B * data_total / shape.global_batch / model_axis
    terms["activations"] = one["activations"]
    terms["logits"] = one["logits"] / model_axis
    total = float(sum(terms.values()))
    return {"batch_per_device": B, "terms": terms, "total": total, "capacity": capacity,
            "usable": FIT_SHARE * capacity, "fits": total <= FIT_SHARE * capacity}


def max_batch(cfg, shape, **kw) -> int:
    """The largest global batch (at most the cell's) whose step fits, 0 if none."""
    lo, hi = 0, shape.global_batch
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if memory_fit(cfg, shape, batch=mid, **kw)["fits"]:
            lo = mid
        else:
            hi = mid - 1
    return lo
