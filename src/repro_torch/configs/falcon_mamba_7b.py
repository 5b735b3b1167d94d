"""falcon-mamba-7b — attention-free mamba-1 architecture.
[arXiv:2410.05355; unverified]  64L d_model=4096 ssm_state=16 vocab=65024,
d_inner = 2 x d_model = 8192.  No attention, no KV cache: the long_500k cell
decodes against a constant-size recurrent state."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm", modality="text",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=65024, ssm_state=16, d_inner=8192, conv_width=4,
    grad_accum=2,
)

SMOKE_CONFIG = CONFIG.replace(
    grad_accum=1, n_layers=2, d_model=64, ssm_state=8, d_inner=128, vocab=128,
    dtype="float32")
