"""Command-line entry points of the port (``python -m repro_torch.launch.serve``),
meshes (``mesh``) and the dry-run's cells (``specs``).

The reference's exports, loaded on first use: the launchers of the market
side import this package without loading the model stack."""
import importlib

_FROM = {"available_devices": "mesh", "make_mesh": "mesh",
         "make_production_mesh": "mesh", "SHAPES": "specs",
         "ShapeSpec": "specs", "cell_supported": "specs",
         "input_specs": "specs", "rules_for": "specs"}

__all__ = sorted(list(_FROM) + ["mesh", "specs"])


def __getattr__(name):
    if name in ("mesh", "specs"):
        return importlib.import_module(f".{name}", __name__)
    if name in _FROM:
        return getattr(importlib.import_module(f".{_FROM[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
