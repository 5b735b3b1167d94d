"""Canonical interruption-cause names (one constants module, no drift).

Every :class:`repro.core.metrics.InterruptionEvent` carries a ``cause``
string.  Before this module they were scattered literals ("capacity",
"price-wave", "migration-failed"); the fault-injection layer adds more, so
the names now live in one place.  The values are **serialized identifiers**
(they appear in metrics JSON, sweep reports, and tests) — they must never
change, only grow.
"""
from __future__ import annotations


class InterruptionCause:
    """String constants for ``InterruptionEvent.cause``.

    Plain ``str`` constants rather than an Enum: causes are serialized
    verbatim into metrics rows and committed sweep reports, and historical
    artifacts compare by raw string — a constants class keeps equality,
    hashing, and ``json.dumps`` behavior byte-for-byte identical to the
    pre-unification literals.
    """

    #: reclaimed by an on-demand request's preemption (the default)
    CAPACITY = "capacity"
    #: pool clearing price crossed the VM's bid (market engine wave)
    PRICE_WAVE = "price-wave"
    #: a proactive migration flight whose destination stopped clearing
    MIGRATION_FAILED = "migration-failed"
    #: the VM's host was removed (trace machine event / host churn)
    HOST_REMOVED = "host-removed"
    #: injected correlated interruption storm (``market/faults``)
    FAULT_STORM = "fault-storm"
    #: injected transient pool outage (``market/faults``)
    FAULT_OUTAGE = "fault-outage"

    ALL = (CAPACITY, PRICE_WAVE, MIGRATION_FAILED, HOST_REMOVED,
           FAULT_STORM, FAULT_OUTAGE)
    #: causes emitted by the fault-injection layer
    FAULT_CAUSES = (FAULT_STORM, FAULT_OUTAGE)

    @classmethod
    def validate(cls, cause: str) -> str:
        if cause not in cls.ALL:
            raise ValueError(
                f"unknown interruption cause {cause!r} "
                f"(known: {', '.join(cls.ALL)})")
        return cause
