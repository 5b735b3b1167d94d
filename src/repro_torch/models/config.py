"""Architecture configuration."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid
    modality: str = "text"         # text | vlm | audio
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4               # 0 for attention-free archs
    n_kv_heads: int = 4
    d_ff: int = 1024               # per-expert width for MoE
    vocab: int = 1024
    head_dim: int = 0              # default d_model // n_heads
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 2048     # tokens per dispatch group
    # SSM (mamba-1)
    ssm_state: int = 0
    d_inner: int = 0               # default 2 * d_model
    conv_width: int = 4
    dt_rank: int = 0               # default ceil(d_model / 16)
    # attention
    sliding_window: Optional[int] = None
    rope_theta: float = 10_000.0
    mlp: str = "gated_silu"        # | gelu
    # numerics / execution
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    attention_chunk: int = 1024    # kv-chunk for the memory-safe xla attention
    # optimizer selection (framework-level, used by train/)
    optimizer: str = "adamw"       # | adafactor
    grad_accum: int = 1            # microbatch count for train_4k at prod scale
    moment_dtype: str = "float32"  # AdamW m/v dtype (bf16 for 100B+ models)
    accum_dtype: str = "float32"   # grad-accumulator dtype
    # distribution knobs (see DESIGN.md §5 and the per-arch memory napkin math
    # in EXPERIMENTS.md): ZeRO-3 across pods, sequence-parallel residual stream
    fsdp_over_pod: bool = False
    seq_parallel: bool = False

    # -- derived -------------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def dinner(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def dtrank(self) -> int:
        return self.dt_rank or max(1, -(-self.d_model // 16))

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0 and self.family in ("dense", "moe", "hybrid")

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def is_moe(self) -> bool:
        return self.family == "moe" and self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k decode."""
        return self.family in ("ssm",) or (
            self.family == "hybrid" and self.sliding_window is not None)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def n_params(self) -> int:
        """Total parameter count (embedding + layers + head)."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        n = 0
        if self.modality == "text":
            n += V * d                       # token embedding
        n += d * V                           # lm head
        n += d                               # final norm
        per_layer = 0
        if self.has_attention:
            hq = self.n_heads * self.hd
            hkv = self.n_kv_heads * self.hd
            per_layer += d * hq + 2 * d * hkv + hq * d + d  # qkvo + ln
        if self.has_ssm:
            di, ns, dr = self.dinner, self.ssm_state, self.dtrank
            per_layer += d * 2 * di + di * self.conv_width + di
            per_layer += di * (dr + 2 * ns) + dr * di + di  # x_proj, dt_proj, bias
            per_layer += di * ns + di                       # A_log, D
            per_layer += di * d + d                         # out_proj + ln
        if self.is_moe:
            per_layer += d * self.n_experts                 # router
            per_layer += self.n_experts * 3 * d * self.d_ff  # expert FFNs
            per_layer += d                                  # ln
        elif self.family != "ssm":
            if self.mlp == "gated_silu":
                per_layer += 3 * d * self.d_ff + d
            else:
                per_layer += 2 * d * self.d_ff + d
        return n + L * per_layer

    def n_active_params(self) -> int:
        """Active parameters per token (MoE counts top_k experts only)."""
        if not self.is_moe:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        inactive = L * (self.n_experts - self.top_k) * 3 * d * self.d_ff
        return self.n_params() - inactive
