"""starcoder2-15b — dense GQA + RoPE code model.
[arXiv:2402.19173; hf]  40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152.  StarCoder2 uses non-gated GELU FFNs (d_ff = 4 x d_model)."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b", family="dense", modality="text",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab=49152, rope_theta=100_000.0, mlp="gelu", grad_accum=2,
)

SMOKE_CONFIG = CONFIG.replace(
    grad_accum=1, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=256, vocab=128,
    dtype="float32", attention_chunk=64)
