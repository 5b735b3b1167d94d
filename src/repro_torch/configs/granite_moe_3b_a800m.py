"""granite-moe-3b-a800m — 40 experts top-8 MoE.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]  32L d_model=1536 24H (kv=8)
d_ff=512 (per expert) vocab=49155.  24 heads and 49155 vocab are not
divisible by the 16-way model axis — GSPMD padding handles both (a main
reason the framework uses pjit semantics rather than shard_map)."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe", modality="text",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab=49155, n_experts=40, top_k=8,
    capacity_factor=1.25, moe_group_size=2048,
    rope_theta=10_000.0, mlp="gated_silu", grad_accum=1,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=48, n_heads=3, n_kv_heads=1, d_ff=32, vocab=129,
    n_experts=5, top_k=2, moe_group_size=64, dtype="float32",
    attention_chunk=64)
