from .checkpoint import CheckpointManager
from .compression import (
    compress_tree,
    compressed_grad_combine,
    decompress_tree,
    dequantize_int8,
    init_error_feedback,
    quantize_int8,
)
from .elastic import (
    AvailabilityEvent,
    ElasticReport,
    ElasticTrainer,
    build_mesh,
    simulate_worker_availability,
)
from .placement import ClusterScheduler, JobSpec, SLICE_V5E_256
from .straggler import StragglerDetector, masked_grad_mean

__all__ = [k for k in dir() if not k.startswith("_")]
