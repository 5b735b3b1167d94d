"""repro_torch — the spot-market simulator on PyTorch and CUDA.

A port of the ``repro`` package, which stays the reference: the same
subpackages (``core``, ``obs``, ``market``, ``kernels``) with the same module
and function names.  Host-side logic (event loop, host pool, metrics, the
numpy HLEM oracle) is numpy float64 as in the reference; HLEM-VMP host
scoring runs on the GPU through a hand-written CUDA kernel
(``kernels/csrc/hlem_score.cu``).  Nothing here imports JAX.
"""
