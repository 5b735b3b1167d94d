"""String-keyed plugin registries (the scenario API's extension points).

Every pluggable family in the simulator — allocation policies, bid
strategies, migration policies, price processes, workload generators — is a
:class:`Registry`: a name → factory mapping with a uniform registration
decorator and a fail-fast error message that lists the known names.  The
legacy factory helpers (``make_policy``, ``make_bid_strategy``,
``make_migration_planner``, …) delegate here, so examples and tests can add
custom strategies without touching core:

    from repro_torch.core.registry import Registry
    from repro_torch.core.allocation import POLICY_REGISTRY

    @POLICY_REGISTRY.register("my-policy")
    class MyPolicy(AllocationPolicy):
        ...

    make_policy("my-policy")          # now resolves
    ScenarioSpec / PolicySpec("my-policy")  # and validates in the spec tree
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional


class Registry:
    """Ordered name → factory mapping with decorator registration.

    ``kind`` names the family in error messages ("allocation policy", …).
    Factories are arbitrary callables (classes or functions); ``build``
    invokes them with the caller's kwargs.
    """

    def __init__(self, kind: str):
        self.kind = kind
        self.entries: Dict[str, Any] = {}

    # -- registration --------------------------------------------------------
    def register(self, name: str, obj: Any = None,
                 overwrite: bool = False) -> Callable:
        """Register ``obj`` under ``name``; usable as a decorator:

            @REG.register("name")
            class Thing: ...
        """
        def _add(target: Any) -> Any:
            if not overwrite and name in self.entries:
                raise ValueError(
                    f"{self.kind} {name!r} is already registered "
                    f"(pass overwrite=True to replace it)")
            self.entries[name] = target
            return target

        return _add if obj is None else _add(obj)

    # -- lookup --------------------------------------------------------------
    def get(self, name: str) -> Any:
        try:
            return self.entries[name]
        except KeyError:
            raise ValueError(
                f"unknown {self.kind} {name!r} "
                f"(known: {', '.join(self.names()) or '<none>'})") from None

    def build(self, name: str, **kwargs: Any) -> Any:
        return self.get(name)(**kwargs)

    def names(self) -> tuple:
        return tuple(self.entries)

    def __contains__(self, name: object) -> bool:
        return name in self.entries

    def __iter__(self) -> Iterator[str]:
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __repr__(self) -> str:
        return f"Registry({self.kind!r}, {list(self.entries)})"
