"""kimi-k2-1t-a32b — trillion-parameter MoE, 384 experts top-8.
[arXiv:2501.kimi2; unverified]  61L d_model=7168 64H (GQA kv=8) d_ff=2048
(per expert) vocab=163840.  Optimizer: adafactor (fp32 Adam moments for 1T
params would not fit 512 x 16 GB; see DESIGN.md).  No shared expert is
modeled (deviation recorded in DESIGN.md)."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe", modality="text",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab=163840, n_experts=384, top_k=8,
    capacity_factor=1.25, moe_group_size=2048,
    rope_theta=50_000.0, mlp="gated_silu",
    optimizer="adafactor", grad_accum=8, fsdp_over_pod=True,
    accum_dtype="bfloat16",
)

SMOKE_CONFIG = CONFIG.replace(
    grad_accum=1, fsdp_over_pod=False,
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64, vocab=256,
    n_experts=8, top_k=2, moe_group_size=64, dtype="float32",
    attention_chunk=64)
