"""Run manifests: make every committed metrics/report JSON self-describing.

A manifest answers "what produced this file?" months later: the seed(s),
the full spec dict plus a content hash (so two artifacts are comparable
at a glance), the git SHA if the tree is a checkout, the versions of the
packages whose numerics matter (torch and the CUDA it was built for), the
card the run used, and the wall-clock duration of the run.

Everything degrades gracefully: no git, no CUDA, no installed-package
metadata — the corresponding fields are simply ``null``.  The card's name
is read only in a process that has already initialised CUDA: a manifest
built in a sweep's parent must not initialise CUDA before its worker pool
forks (a forked child cannot use a CUDA context its parent created).  The
sweep therefore passes the names its workers read (``cuda_device_name``).
The manifest is *additive* metadata, deliberately excluded from
determinism comparisons (the sweep runner's byte-identity tests run with
``manifest=False``).
"""
from __future__ import annotations

import hashlib
import json
import platform
import subprocess
import sys
from typing import Any, Dict, Optional

MANIFEST_VERSION = 1


def spec_hash(spec_dict: Optional[dict]) -> Optional[str]:
    """Content hash of a spec's canonical JSON (sorted keys)."""
    if spec_dict is None:
        return None
    blob = json.dumps(spec_dict, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def git_sha(cwd: Optional[str] = None) -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=cwd, capture_output=True,
            text=True, timeout=5)
        if out.returncode == 0:
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return None


def _pkg_version(name: str) -> Optional[str]:
    try:
        from importlib import metadata
        return metadata.version(name)
    except Exception:
        return None


def package_versions() -> Dict[str, Optional[str]]:
    import torch

    return {
        "python": platform.python_version(),
        "numpy": _pkg_version("numpy"),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }


def cuda_device_name() -> Optional[str]:
    """The name of this process's current CUDA device, or None where CUDA
    has not been initialised here (reading it would initialise CUDA)."""
    import torch

    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.get_device_name(torch.cuda.current_device())


def run_manifest(spec_dict: Optional[dict] = None,
                 seed: Any = None,
                 duration_s: Optional[float] = None,
                 extra: Optional[dict] = None) -> dict:
    """Assemble the manifest block attached to metrics/report JSON."""
    m: Dict[str, Any] = {
        "manifest_version": MANIFEST_VERSION,
        "seed": seed,
        "spec": spec_dict,
        "spec_hash": spec_hash(spec_dict),
        "git_sha": git_sha(),
        "versions": package_versions(),
        "device": cuda_device_name(),
        "platform": platform.platform(),
        "argv": list(sys.argv),
        "duration_s": (round(duration_s, 6)
                       if duration_s is not None else None),
    }
    if extra:
        m.update(extra)
    return m
