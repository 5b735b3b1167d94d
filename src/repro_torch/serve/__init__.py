"""Serving layer of the port: the model-serving engine (prefill and batched
decode) and the interruption-aware request scheduler."""
from .engine import greedy_generate, make_prefill_step, make_serve_step
from .scheduler import Request, SpotServingScheduler

__all__ = ["Request", "SpotServingScheduler", "greedy_generate",
           "make_prefill_step", "make_serve_step"]
