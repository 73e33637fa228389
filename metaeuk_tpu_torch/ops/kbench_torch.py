"""Plain PyTorch versions of the microbenchmark kernels of csrc/kbench.cu.

Each function is the TPU kernel's loop written out step by step in torch, in
the input's own dtype, so every rounding and wrap happens where the Pallas
kernel has it (tools/kbench.py in the repository root):

- alu    (make_alu_case, T1): `reps` times b = a; n_ops // 2 times
         b = max(b + 1, a); a = b.
- shift  (make_shift_case, T2): `reps` times a = max(a, s), with s = a moved
         down the rows (axis 0) by `amount`: zero fill, or wrapped round as
         pltpu.roll(a, amount, 0) does (torch.roll's direction).
- scan   (make_scan_case, T3): `reps` // 8 times a = cummax_down(a) - 1, the
         cummax as log2(rows) passes a = max(a, a shifted down by 1, 2, 4, ...
         with fill NEG).

These are the CPU path and the yardstick of equality on the card, not of
speed.
"""

import torch

REPS = 512            # inner op-block repetitions (tools/kbench.py REPS)
SHAPE = (256, 512)    # rows x lanes (tools/kbench.py SHAPE)
NEG = -(10 ** 6)      # the scan's fill


def alu(x, reps=REPS, n_ops=8):
    """T1: the dependent add-max chain, elementwise in x's dtype."""
    one = torch.ones((), dtype=x.dtype)
    a = x
    for _ in range(reps):
        b = a
        for _ in range(n_ops // 2):
            b = torch.maximum(b + one, a)
        a = b
    return a


def _shift_down(a, k, fill):
    pad = torch.full((k, a.shape[1]), fill, dtype=a.dtype, device=a.device)
    return torch.cat([pad, a[:-k]], dim=0)


def shift(x, reps=REPS, amount=1, roll=False):
    """T2: `reps` times a = max(a, a moved down the rows by `amount`)."""
    a = x
    for _ in range(reps):
        s = torch.roll(a, amount, 0) if roll else _shift_down(a, amount, 0)
        a = torch.maximum(a, s)
    return a


def cummax_down(a):
    """The Pallas kernel's in-column max-scan: log-step passes, fill NEG."""
    k = 1
    while k < a.shape[0]:
        a = torch.maximum(a, _shift_down(a, k, NEG))
        k *= 2
    return a


def scan(x, reps=REPS):
    """T3: `reps` // 8 times a = cummax_down(a) - 1 on int32 x."""
    a = x
    for _ in range(reps // 8):
        a = cummax_down(a) - 1
    return a
