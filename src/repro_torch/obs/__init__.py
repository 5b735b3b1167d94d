"""Runtime telemetry the simulator core reads: the span/counter tracer and
the event flight recorder, each with its inert default.

* :class:`Tracer` / :data:`NULL_TRACER` — span/instant/counter recorder
  (``repro_torch.obs.tracer``).
* :class:`EventLog` / :data:`NULL_RECORDER` — append-only structured log
  of every lifecycle/market event (``repro_torch.obs.eventlog``).
"""
from .tracer import NULL_TRACER, Counters, NullTracer, Tracer
from .eventlog import (EVENT_KINDS, NULL_RECORDER, EventLog, LogEventKind,
                       NullRecorder, iter_event_records, load_event_log,
                       read_manifest, validate_event_log, write_event_log)

__all__ = [k for k in dir() if not k.startswith("_")]
