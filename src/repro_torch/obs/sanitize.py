"""Runtime determinism sanitizer — the dynamic twin of ``tools/detlint``.

``sanitized()`` monkeypatches the wall-clock readers (``time.time``,
``time.monotonic``, ``time.perf_counter`` and their ``_ns`` variants), the
stdlib ``random`` module-level functions, and the legacy ``np.random``
module-level functions to raise :class:`SanitizerViolation` for the
duration of a ``with`` block.  Running one fixed-seed simulation inside
the block verifies *at runtime* what the ``no-wallclock`` and
``no-global-rng`` lint rules claim statically: nothing on the sim path
reads a clock or touches hidden global RNG state.

Scope and limits:

* Module-level function replacement only — code that bound a clock at
  import/class-definition time (e.g. :class:`repro_torch.obs.tracer.Tracer`'s
  default ``clock=time.perf_counter``) keeps its captured reference.
  That is deliberate: obs/ is *allowed* to read clocks; the sanitizer
  polices call-time lookups on the sim path.
* ``datetime.datetime.now`` is a method on a C type and cannot be
  patched; the static ``no-wallclock`` rule covers it.
* Seeded ``np.random.default_rng(...)`` Generators are untouched — their
  methods live on the Generator instance, not the module.

Everything is restored in a ``finally``, so a violation (or any other
exception) cannot leak patched state into the caller.
"""

from __future__ import annotations

import contextlib
import random
import time
from typing import Iterator, List, Tuple

import numpy as np

__all__ = ["SanitizerViolation", "sanitized", "TIME_ATTRS", "RANDOM_ATTRS",
           "NP_RANDOM_ATTRS"]


class SanitizerViolation(RuntimeError):
    """A forbidden wall-clock or global-RNG call executed inside a
    ``sanitized()`` scope."""


TIME_ATTRS = (
    "time", "time_ns",
    "monotonic", "monotonic_ns",
    "perf_counter", "perf_counter_ns",
    "process_time", "process_time_ns",
)

#: stdlib random module-level functions (all share one hidden global state)
RANDOM_ATTRS = (
    "random", "uniform", "randint", "randrange", "choice", "choices",
    "shuffle", "sample", "gauss", "normalvariate", "expovariate",
    "betavariate", "gammavariate", "lognormvariate", "paretovariate",
    "weibullvariate", "triangular", "vonmisesvariate", "getrandbits",
    "seed",
)

#: legacy numpy module-level RNG entry points (hidden global RandomState)
NP_RANDOM_ATTRS = (
    "random", "rand", "randn", "randint", "random_sample", "ranf",
    "sample", "choice", "shuffle", "permutation", "uniform", "normal",
    "standard_normal", "exponential", "poisson", "binomial", "beta",
    "gamma", "lognormal", "pareto", "weibull", "seed", "random_integers",
)


def _raiser(module_name: str, attr: str):
    full = f"{module_name}.{attr}"

    def _forbidden(*args, **kwargs):
        raise SanitizerViolation(
            f"{full}() called inside a sanitized sim scope — sim code must "
            "be a pure function of (spec, seed); thread a seeded "
            "np.random.default_rng Generator / take times from the event "
            "queue instead"
        )

    _forbidden.__name__ = f"forbidden_{attr}"
    _forbidden.__qualname__ = _forbidden.__name__
    return _forbidden


@contextlib.contextmanager
def sanitized() -> Iterator[None]:
    """Forbid wall-clock and global-RNG calls for the duration of the block."""
    saved: List[Tuple[object, str, object]] = []

    def patch(module, module_name: str, attrs) -> None:
        for attr in attrs:
            original = getattr(module, attr, None)
            if original is None:
                continue
            saved.append((module, attr, original))
            setattr(module, attr, _raiser(module_name, attr))

    patch(time, "time", TIME_ATTRS)
    patch(random, "random", RANDOM_ATTRS)
    patch(np.random, "np.random", NP_RANDOM_ATTRS)
    try:
        yield
    finally:
        for module, attr, original in reversed(saved):
            setattr(module, attr, original)
