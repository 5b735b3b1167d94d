"""llama3-405b — dense GQA, 128k vocab.
[arXiv:2407.21783; unverified]  126L d_model=16384 128H (GQA kv=8)
d_ff=53248 vocab=128256.  Training at 512 chips requires grad_accum=4
(microbatch 64) to fit activations besides the 405B param + AdamW state
footprint; see EXPERIMENTS.md memory analysis."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b", family="dense", modality="text",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab=128256, rope_theta=500_000.0, mlp="gated_silu",
    grad_accum=8, fsdp_over_pod=True, seq_parallel=True,
    moment_dtype="bfloat16", accum_dtype="bfloat16",
)

SMOKE_CONFIG = CONFIG.replace(
    grad_accum=1, fsdp_over_pod=False, seq_parallel=False,
    moment_dtype="float32", accum_dtype="float32",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192, vocab=256,
    dtype="float32", attention_chunk=64)
