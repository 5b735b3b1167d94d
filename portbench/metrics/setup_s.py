"""Seconds from the process's start to the window's: imports, CUDA
initialisation, the kernel's build or load, input generation, warm-up."""


def read(rec):
    return rec.setup_s
