"""Microbenchmark kernels (csrc/kbench.cu), dispatched by the device of the
tensor given.

- A CPU tensor goes to the plain PyTorch version (ops/kbench_torch.py).
- A CUDA tensor launches the kernel, or raises. There is no fallback.

Counterparts in tools/kbench.py (repository root): alu is make_alu_case
(T1), shift is make_shift_case (T2), scan is make_scan_case (T3). The output
is a new tensor of the input's shape and dtype.

LAUNCHES counts kernel launches and PLAIN_CALLS calls that went to the plain
version; reset_counts() sets both to zero.

The pure functions below describe kb_shift's and kb_scan's index arithmetic
(csrc/kbench.cu), so that the CPU tests can hold it to the plain versions
without a card: row_slot (row 8t + i in register i of lane t),
shift_source and rep_blocks (what each register takes, and the order of
the unrolled reps), shift_model (kb_shift in numpy), scan_phases and
scan_model (kb_scan's wavefront in numpy), and the counts the bounds take
(shuffles_per_rep, shift_chain, scan_steps, SCAN_CHAIN).
"""

import ctypes
import functools

import numpy as np
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

LANES = 32
ROWS_PER_LANE = ROWS // LANES    # csrc/kbench.cu kRowsPerLane
SCAN_RAMP = 32                   # kb_scan's exact first steps
INT_MIN = -2 ** 31

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


def row_slot(row):
    """(lane, register) holding `row` in kb_shift's and kb_scan's layout."""
    return divmod(row, ROWS_PER_LANE)


def shift_source(amount, reg):
    """(lanes, register): register `reg` of lane t takes, each rep, that
    register of lane t - lanes (0: the lane itself)."""
    q, r = divmod(amount, ROWS_PER_LANE)
    return q + (1 if reg < r else 0), (reg - r) % ROWS_PER_LANE


def shuffles_per_rep(amount):
    """Registers a lane receives from another lane each rep."""
    return sum(shift_source(amount, i)[0] > 0 for i in range(ROWS_PER_LANE))


def fill_by_floor(amount, reg):
    """Whether kb_shift's zero fill of `reg` is the floor of a three-way
    max (the register is its own source, so a shuffle up hands the lanes it
    leaves their own value) rather than a multiply of the value received."""
    lanes, src = shift_source(amount, reg)
    return lanes > 0 and src == reg


def shift_chain(amount, roll):
    """(shuffles, other operations) a rep on kb_shift's longest dependent
    path: follow a register back through its sources for ROWS_PER_LANE reps
    (every register's cycle closes within them); each rep a max, each
    crossing a shuffle and, with zero fill, the fill's multiply where it is
    not the max's floor."""
    worst = (0, 0)
    for start in range(ROWS_PER_LANE):
        reg, crossings, fills = start, 0, 0
        for _ in range(ROWS_PER_LANE):
            lanes, src = shift_source(amount, reg)
            crossings += lanes > 0
            fills += lanes > 0 and not roll and src != reg
            reg = src
        worst = max(worst, (crossings, fills))
    return worst[0] / ROWS_PER_LANE, 1 + worst[1] / ROWS_PER_LANE


def rep_blocks(reps):
    """kb_shift's reps in order: blocks of ROWS_PER_LANE unrolled reps, then
    the remainder loop's single reps."""
    return [ROWS_PER_LANE] * (reps // ROWS_PER_LANE) + \
        [1] * (reps % ROWS_PER_LANE)


def _wrap(x):
    """int64 values wrapped to int32, as the card's 32-bit arithmetic."""
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int64)


def shift_model(x, reps, amount=1, roll=False):
    """kb_shift in numpy on a (256, cols) integer array: the registers of
    each lane (int16 sign-extended), each rep's sources and zero fill (a
    shuffle up returns a lane its own value: multiplied by 0, or, where
    fill_by_floor, kept and met by a floor of 0 in a three-way max), the
    reps in rep_blocks' order."""
    v = x.astype(np.int64).reshape(LANES, ROWS_PER_LANE, -1)
    lanes = np.arange(LANES)
    for block in rep_blocks(reps):
        for _ in range(block):
            s = np.empty_like(v)
            for i in range(ROWS_PER_LANE):
                dq, src = shift_source(amount, i)
                if dq == 0:
                    s[:, i] = v[:, src]
                elif roll:
                    s[:, i] = v[(lanes - dq) % LANES, src]
                else:
                    got = v[np.where(lanes >= dq, lanes - dq, lanes), src]
                    left = (lanes < dq)[:, None]
                    s[:, i] = np.maximum(got, np.where(left, 0, INT_MIN)) \
                        if fill_by_floor(amount, i) else got * ~left
            v = np.maximum(v, s)
    return v.reshape(x.shape).astype(x.dtype)


def scan_steps(passes):
    """kb_scan's steps: lane t runs pass s - t at step s."""
    return passes + LANES - 1 if passes > 0 else 0


def scan_phases(passes):
    """kb_scan's three step loops, (first, stop, first_passes, last_passes):
    the first SCAN_RAMP steps hold every lane's first pass (the exact form;
    a lane takes its input back there), the steps from there to passes - 1
    no first or last pass, the rest every lane's last pass (a lane leaves
    its output there)."""
    steps = scan_steps(passes)
    return [(0, min(SCAN_RAMP, steps), True, True),
            (SCAN_RAMP, passes - 1, False, False),
            (max(SCAN_RAMP, passes - 1), steps, False, True)]


# a scan step's dependent chain: the carry's shuffle, the max of the send
# and lane 31's select of the carry of no rows for lane 0
SCAN_CHAIN = (1, 2)


def scan_model(x, reps):
    """kb_scan in numpy on a (256, cols) int32 array: the wavefront of
    scan_phases over the lanes, every lane at every step (a lane with no
    pass on values of no use: it takes its input back at its first pass and
    leaves its output at its last), each step's carry shuffled from lane t
    - 1 (lane 0's from lane 31, the carry of no rows), the exact and the
    add-max forms, the int32 wrap of the card's adds."""
    passes = reps // 8
    neg = kbench_torch.NEG
    x_in = x.astype(np.int64).reshape(LANES, ROWS_PER_LANE, -1)
    out = x_in.copy()
    a = x_in.copy()
    in_tot = x_in.max(axis=1)
    tot = in_tot.copy()
    got = np.full_like(tot, INT_MIN)   # step 0's: lane 0's first pass
    lanes = np.arange(LANES)
    last = (lanes == LANES - 1)[:, None]
    row255 = np.zeros(a.shape, bool)
    row255[-1, -1] = True

    def addmax(u, w):          # __viaddmax_s32(u, -1, w)
        return np.maximum(_wrap(u - 1), w)

    for first, stop, first_passes, last_passes in scan_phases(passes):
        for s in range(first, stop):
            if first_passes:
                start = (lanes == s)[:, None]
                a = np.where(start[:, :, None], x_in, a)
                tot = np.where(start, in_tot, tot)
            c = got
            send = np.maximum(tot, c)
            # lane 31 sends lane 0 the carry of no rows
            got = np.where(last, INT_MIN + 1, send)[(lanes - 1) % LANES]
            p = np.maximum.accumulate(a, axis=1)
            if first_passes:
                floor = np.where(row255, INT_MIN, neg)
                a = _wrap(np.maximum(np.maximum(p, c[:, None]), floor) - 1)
                tot = np.maximum(send, neg) - 1
            else:
                cn = addmax(c, neg - 1)
                cn7 = addmax(c, np.where(last, INT_MIN, neg - 1))
                a = addmax(p, cn[:, None])
                a[:, -1] = addmax(p[:, -1], cn7)
                tot = addmax(send, neg - 1)
            if last_passes:
                done = (s - lanes == passes - 1)[:, None, None]
                out = np.where(done, a, out)
    return out.reshape(x.shape).astype(x.dtype)
