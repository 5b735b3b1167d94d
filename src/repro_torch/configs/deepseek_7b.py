"""deepseek-7b — llama-architecture dense model.
[arXiv:2401.02954; hf]  30L d_model=4096 32H (kv=32) d_ff=11008
vocab=102400."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b", family="dense", modality="text",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab=102400, rope_theta=10_000.0, mlp="gated_silu",
    grad_accum=1,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160, vocab=256,
    dtype="float32", attention_chunk=64)
