"""hymba-1.5b — hybrid: parallel attention + mamba heads per block.
[arXiv:2411.13676; hf]  32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001
ssm_state=16.  Attention is sliding-window (W=1024) in the hybrid blocks, so
the arch is sub-quadratic and runs the long_500k cell (ring-buffer KV cache
of W slots + recurrent SSM state).  25 heads / 16-way model axis relies on
GSPMD padding."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid", modality="text",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, ssm_state=16, d_inner=3200, conv_width=4,
    sliding_window=1024, rope_theta=10_000.0, mlp="gated_silu",
    head_dim=64, grad_accum=1,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=5, n_kv_heads=1, d_ff=128, vocab=128,
    ssm_state=8, d_inner=128, sliding_window=32, head_dim=16,
    dtype="float32", attention_chunk=64)
