"""Seconds from the process's start to the window's: imports, CUDA, the
kernel and host libraries (built once in the checkout), the data from the
seed, createdb and the warm job (host clock)."""


def read(run):
    return run.setup_s
