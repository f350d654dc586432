"""Model/config dataclasses shared by all assigned architectures."""
from __future__ import annotations

from dataclasses import dataclass, replace

from typing import Optional



@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    norm_topk_prob: bool = True


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    n_groups: int = 1
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False           # Qwen3-style per-head RMSNorm on q,k
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # encoder-decoder (whisper): encoder depth and fixed frame count (stub frontend)
    n_enc_layers: int = 0
    enc_seq: int = 0
    # vlm: number of prepended patch embeddings (stub frontend)
    n_patches: int = 0
    # hybrid (zamba2): one shared attention block applied every k mamba layers
    shared_attn_every: int = 0
    # numerics / compile shape
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"   # nothing | dots | dots_no_batch
    scan_layers: bool = True
    sequence_parallel: bool = False
    # §Perf hillclimb levers (baseline values reproduce the paper-faithful run)
    moe_combine: str = "scatter"    # scatter | gather (token-side gather combine)
    moe_impl: str = "global"        # global (XLA SPMD partitions the dispatch)
    #                                 | local (shard_map: per-shard routing,
    #                                 local expert compute, one psum — zero
    #                                 dispatch collectives)
    attn_seq_shard: bool = False    # context-parallel attention: shard q over
    #                                 seq on `model` when heads aren't divisible
    pure_dp: bool = False           # ZeRO-3 layout: batch shards over BOTH mesh
    #                                 axes (viable when global_batch >= chips);
    #                                 params stay 2D-sharded at rest and are
    #                                 all-gathered per layer — no TP all-reduces
    microbatches: int = 1           # grad accumulation: divides activation
    #                                 memory by M at the cost of M serial passes
    # serving
    max_decode_len: int = 0         # 0 -> shape-driven

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    # -- parameter count (analytical; used for MODEL_FLOPS = 6·N·D) --------
    def param_count(self, active_only: bool = False) -> int:
        D, V, L = self.d_model, self.vocab, self.n_layers
        total = V * D * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            if self.mla is not None:
                m = self.mla
                qk = m.qk_nope_dim + m.qk_rope_dim
                return (
                    D * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk
                    + D * (m.kv_lora_rank + m.qk_rope_dim)
                    + m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * D
                )
            return D * self.hd * (2 * self.n_heads + 2 * self.n_kv_heads)

        def mlp_params(dff: int) -> int:
            return 3 * D * dff  # SwiGLU

        def moe_params(active: bool) -> int:
            m = self.moe
            e = m.top_k if active else m.n_experts
            p = D * m.n_experts  # router
            p += e * 3 * D * m.d_ff_expert
            if m.n_shared_experts:
                p += 3 * D * m.d_ff_shared + D  # shared experts + gate
            return p

        def ssm_params() -> int:
            s = self.ssm
            d_in = s.d_inner(D)
            nh = s.n_heads(D)
            conv_dim = d_in + 2 * s.n_groups * s.d_state
            return (
                D * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
                + conv_dim * s.conv_kernel
                + 3 * nh  # A_log, D, dt_bias
                + d_in  # gated norm
                + d_in * D
            )

        if self.family in ("dense", "vlm"):
            total += L * (attn_params() + mlp_params(self.d_ff) + 2 * D)
            if self.family == "vlm":
                total += D * D  # patch projection stub
        elif self.family == "moe":
            total += L * (attn_params() + moe_params(active_only) + 2 * D)
        elif self.family == "ssm":
            total += L * (ssm_params() + D)
        elif self.family == "hybrid":
            total += L * (ssm_params() + D)
            n_shared_applications = L // max(self.shared_attn_every, 1)
            shared = attn_params() + mlp_params(self.d_ff) + 2 * D
            total += shared  # parameters stored once
            if active_only:
                total += shared * max(n_shared_applications - 1, 0)  # re-used compute
        elif self.family == "encdec":
            total += self.n_enc_layers * (attn_params() + mlp_params(self.d_ff) + 2 * D)
            # decoder: self-attn + cross-attn + mlp
            total += L * (2 * attn_params() + mlp_params(self.d_ff) + 3 * D)
        else:
            raise ValueError(self.family)
        return int(total)


# architecture registry, populated by configs/__init__.py
ARCHS: dict = {}


def register_arch(cfg: ModelConfig, reduced: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = {"full": cfg, "reduced": reduced}
    return cfg
