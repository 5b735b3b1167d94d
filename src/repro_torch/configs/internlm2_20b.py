"""internlm2-20b — dense GQA model.
[arXiv:2403.17297; hf]  48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b", family="dense", modality="text",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92544, rope_theta=1_000_000.0, mlp="gated_silu",
    grad_accum=2,
)

SMOKE_CONFIG = CONFIG.replace(
    grad_accum=1, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192, vocab=192,
    dtype="float32", attention_chunk=64)
