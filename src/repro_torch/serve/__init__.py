"""Serving layer: request scheduling on spot capacity.

The market-simulation side (``scheduler``, ``demand``, ``autoscale``,
``slo``, ``service``) is pure Python + numpy and imports eagerly; the
model-serving side (``engine``: prefill/decode over the torch model stack)
loads lazily on first attribute access, so building a serve scenario
never imports the model stack.
"""
from .autoscale import (
    AUTOSCALE_REGISTRY,
    Autoscaler,
    AutoscaleConfig,
    DemandSignals,
    make_autoscaler,
    register_autoscale_policy,
    validate_autoscale_config,
)
from .demand import make_bursty, make_diurnal
from .scheduler import Request, SpotServingScheduler
from .service import (
    ServeConfig,
    ServeManager,
    make_serve_manager,
    validate_serve_config,
)
from .slo import (
    cost_forecast,
    cost_per_request,
    error_budget_burn,
    latency_percentiles,
    serve_stats,
    slo_attainment,
)

#: model-stack exports, resolved on demand (PEP 562)
_ENGINE_EXPORTS = ("greedy_generate", "make_prefill_step", "make_serve_step")

__all__ = [k for k in dir() if not k.startswith("_")] + list(_ENGINE_EXPORTS)


def __getattr__(name):
    if name in _ENGINE_EXPORTS:
        from . import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
