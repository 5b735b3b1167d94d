"""repro_torch.market — scenario layers above the core simulator.

* ``trace`` — Google-Cluster-Trace-style machine/task event generation, CSV
  reading and writing, and trace-driven simulation (paper §VII-C/D).
"""
from .trace import (
    Trace,
    TraceConfig,
    generate_trace,
    load_trace,
    simulate_trace,
    wire_trace,
    write_trace_csv,
)

__all__ = [k for k in dir() if not k.startswith("_")]
