"""phi-3-vision-4.2b — phi3-mini backbone + CLIP frontend (stub).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]  32L d_model=3072 32H (kv=32)
d_ff=8192 vocab=32064.  Modality: vlm — input_specs() provides precomputed
patch embeddings; the CLIP tower is a stub per the assignment."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="dense", modality="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32064, rope_theta=10_000.0, mlp="gated_silu",
    grad_accum=1,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
    dtype="float32", attention_chunk=64)
