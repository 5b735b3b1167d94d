"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own by ``nvcc`` into ``build/repro_torch/lib<name>-<hash>.so`` at the root
of the checkout.  The hash is of the source and of every shared header
``csrc/*.cuh`` (which any source may include), so an edited kernel or
header is never served from a stale library.  A C interface keeps
PyTorch's headers out of the compile, which then takes seconds instead of
minutes.  Nothing here runs at import time: the CPU-only test environment
has no ``nvcc``.  ``refuse_grad`` is the wrappers' shared check that no
input of a kernel needs a gradient.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (no CUDA_HOME, no nvcc on "
                           "PATH): the CUDA kernels build only where it is "
                           "installed")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.

    The compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside the library as ``<library>.log``."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    out.with_suffix(".so.log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent builder never sees a partial file
    return out


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise when grad is enabled and any of ``tensors`` (None skipped)
    requires it: a kernel writes fresh tensors with no ``grad_fn``, so a loss
    through it would silently lose the gradient of everything upstream."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {kernel} kernel has no backward: run the model with "
            f'impl="xla" (the plain, differentiable functions) to train, '
            f"or call it under torch.no_grad()")


def load_library(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use in this process."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib
