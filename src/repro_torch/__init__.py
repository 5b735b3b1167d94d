"""repro_torch — the spot-market simulator on PyTorch and CUDA.

A port of the ``repro`` package, which stays the reference: the same
subpackages with the same module and function names.  ``core`` (event
loop, host pool, metrics, allocation policies, the numpy HLEM oracle),
``market`` (price engine and processes, bids, billing, risk, migration,
fleet, faults, traces), ``obs`` (tracer, event log), ``models``/``serve``/
``configs``/``launch`` (model serving) and ``kernels``.  Host-side logic is
numpy float64 as in the reference; HLEM-VMP host scoring, attention and the
selective scan run on the GPU through hand-written CUDA kernels
(``kernels/csrc``), and offline price paths through a float64 torch loop.
Nothing here imports JAX.
"""
