"""Microbenchmark kernels (csrc/kbench.cu), dispatched by the device of the
tensor given.

- A CPU tensor goes to the plain PyTorch version (ops/kbench_torch.py).
- A CUDA tensor launches the kernel, or raises. There is no fallback.

Counterparts in tools/kbench.py (repository root): alu is make_alu_case
(T1), shift is make_shift_case (T2), scan is make_scan_case (T3). The output
is a new tensor of the input's shape and dtype.

LAUNCHES counts kernel launches and PLAIN_CALLS calls that went to the plain
version; reset_counts() sets both to zero.
"""

import ctypes
import functools

import torch

from . import _build, kbench_torch
from .kbench_torch import REPS

KERNELS = ("kb_alu", "kb_shift", "kb_scan")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(KERNELS, 0)

ALU_DTYPES = {torch.int32: 0, torch.int16: 1, torch.float32: 2,
              torch.bfloat16: 3}
SHIFT_DTYPES = {torch.int32: 0, torch.int16: 1}
SHIFT_AMOUNTS = (1, 3, 8, 64)     # tools/kbench.py main()'s
ROWS = kbench_torch.SHAPE[0]     # shift and scan: one warp a column

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    # dtype, x, out, n_words, reps, n_ops, stream
    "kb_alu": [_I, _P, _P, ctypes.c_longlong, _I, _I, _P],
    # dtype, x, out, rows, cols, reps, amount, roll, stream
    "kb_shift": [_I, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, out, rows, cols, reps, stream
    "kb_scan": [_P, _P, _I, _I, _I, _P],
}


def reset_counts():
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0


@functools.lru_cache(maxsize=None)
def _kernel(name):
    fn = getattr(_build.load("kbench"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check(name, x, dtypes):
    if x.device.type != "cuda":
        raise ValueError(f"{name} takes a CUDA tensor, got {x.device}")
    if x.dtype not in dtypes:
        raise ValueError(f"{name} takes {list(dtypes)}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous tensor")


def _check_column_layout(name, x):
    if x.dim() != 2 or x.shape[0] != ROWS or x.shape[1] < 1:
        raise ValueError(f"{name} takes ({ROWS}, cols), got "
                         f"{tuple(x.shape)}")


def _launch(name, *args):
    rc = _kernel(name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def alu(x, reps=REPS, n_ops=8):
    """T1: `reps` times an n_ops-long dependent add-max chain, elementwise."""
    if x.device.type == "cpu":
        PLAIN_CALLS["kb_alu"] += 1
        return kbench_torch.alu(x, reps, n_ops)
    _check("kb_alu", x, ALU_DTYPES)
    words = x.numel() * x.element_size() // 4
    if words * 4 != x.numel() * x.element_size():
        raise ValueError("kb_alu takes an even number of 16-bit values")
    out = torch.empty_like(x)
    _launch("kb_alu", ALU_DTYPES[x.dtype], x.data_ptr(), out.data_ptr(),
            words, reps, n_ops)
    return out


def shift(x, reps=REPS, amount=1, roll=False):
    """T2: `reps` times a = max(a, a moved down the rows by `amount`)."""
    if x.device.type == "cpu":
        PLAIN_CALLS["kb_shift"] += 1
        return kbench_torch.shift(x, reps, amount, roll)
    _check("kb_shift", x, SHIFT_DTYPES)
    _check_column_layout("kb_shift", x)
    if amount not in SHIFT_AMOUNTS:
        raise ValueError(f"kb_shift is built for amounts {SHIFT_AMOUNTS}, "
                         f"got {amount}")
    out = torch.empty_like(x)
    _launch("kb_shift", SHIFT_DTYPES[x.dtype], x.data_ptr(), out.data_ptr(),
            ROWS, x.shape[1], reps, amount, int(roll))
    return out


def scan(x, reps=REPS):
    """T3: `reps` // 8 times a = cummax_down(a) - 1 on int32."""
    if x.device.type == "cpu":
        PLAIN_CALLS["kb_scan"] += 1
        return kbench_torch.scan(x, reps)
    _check("kb_scan", x, {torch.int32: 0})
    _check_column_layout("kb_scan", x)
    out = torch.empty_like(x)
    _launch("kb_scan", x.data_ptr(), out.data_ptr(), ROWS, x.shape[1], reps)
    return out
