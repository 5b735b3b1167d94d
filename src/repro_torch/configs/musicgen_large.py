"""musicgen-large — decoder-only transformer over EnCodec tokens.
[arXiv:2306.05284; hf]  48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.
Modality: audio — input_specs() provides precomputed frame embeddings; the
EnCodec tokenizer/frontend is a stub per the assignment.  MusicGen uses
non-gated GELU FFNs."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="dense", modality="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048, rope_theta=10_000.0, mlp="gelu", grad_accum=1,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=64,
    dtype="float32", attention_chunk=64)
