"""Zero-dependency runtime telemetry: tracing, counters, profiles, manifests,
and the event flight recorder.

Public surface:

* :class:`Tracer` / :data:`NULL_TRACER` — span/instant/counter recorder
  and its inert default (``repro_torch.obs.tracer``).
* :class:`EventLog` / :data:`NULL_RECORDER` — append-only structured log
  of every lifecycle/market event and its inert default
  (``repro_torch.obs.eventlog``).
* :func:`first_divergence` / :func:`bisect_divergence` — first-divergence
  run diffing over two event logs (``repro_torch.obs.diff``).
* :func:`pool_risk_series` / :func:`storm_intervals` /
  :func:`cohort_summary` — vectorized post-hoc market-risk analytics over
  a recorded log (``repro_torch.obs.analyze``).
* :func:`write_html_report` — self-contained static HTML run/sweep report
  (``repro_torch.obs.report``).
* :func:`write_chrome_trace` / :func:`validate_chrome_trace` — Chrome
  trace-event JSON export for Perfetto / chrome://tracing
  (``repro_torch.obs.export``).
* :func:`profile_table` / :func:`write_profile` /
  :func:`format_profile_table` — per-subsystem self/total wall-time
  breakdown (``repro_torch.obs.profile``).
* :func:`run_manifest` / :func:`spec_hash` — self-describing metadata
  blocks for committed artifacts (``repro_torch.obs.manifest``).
"""
from .tracer import NULL_TRACER, Counters, NullTracer, Tracer
from .eventlog import (EVENT_KINDS, NULL_RECORDER, EventLog, LogEventKind,
                       NullRecorder, iter_event_records, load_event_log,
                       read_manifest, validate_event_log, write_event_log)
from .diff import (Divergence, bisect_divergence, first_divergence,
                   format_divergence)
from .analyze import (cohort_summary, interruption_intensity,
                      pool_risk_series, serve_series, storm_intervals,
                      victim_rate, vm_lifecycle)
from .report import (render_report, render_sweep_report, report_summary_json,
                     write_html_report)
from .export import chrome_trace, validate_chrome_trace, write_chrome_trace
from .profile import (format_profile_table, profile_report, profile_table,
                      write_profile)
from .manifest import run_manifest, spec_hash
from .sanitize import SanitizerViolation, sanitized

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "Counters",
    "EventLog", "NullRecorder", "NULL_RECORDER", "EVENT_KINDS", "LogEventKind",
    "load_event_log", "iter_event_records", "read_manifest",
    "validate_event_log", "write_event_log",
    "Divergence", "first_divergence", "bisect_divergence",
    "format_divergence",
    "interruption_intensity", "storm_intervals", "pool_risk_series",
    "victim_rate", "vm_lifecycle", "cohort_summary", "serve_series",
    "render_report", "render_sweep_report", "write_html_report",
    "report_summary_json",
    "chrome_trace", "write_chrome_trace", "validate_chrome_trace",
    "profile_table", "profile_report", "write_profile",
    "format_profile_table",
    "run_manifest", "spec_hash",
    "SanitizerViolation", "sanitized",
]
