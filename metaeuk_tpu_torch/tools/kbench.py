"""Microbenchmarks of the steps an SW column recurrence is made of, on one
NVIDIA GPU (the port of tools/kbench.py in the repository root):

  - int32 / int16 / float32 / bfloat16 dependent add-max chains (T1: is
    packed 16-bit work twice the int32 rate?)
  - moving rows down a column by 1, 3, 8 or 64, with zero fill or wrapped
    round, against the max that consumes them (T2)
  - an exact 256-row in-column max-scan (T3)

    python -m metaeuk_tpu_torch.tools.kbench [--device cuda|cpu] [case ...]

Each case prints `name: us/call Tops/s`: device time by CUDA events over 10
calls after one warm-up, and the TPU tool's operation count over it. The
header names the card and its power limit. `--device cpu` runs the plain
PyTorch versions once each, untimed.

shift_yardstick and scan_yardstick compute T2 and T3 at REPS in one or a
few PyTorch calls (the algebra of REPS reps, not the reps): yardsticks of
the kernels' time, never their design.
"""

import argparse
import math
import subprocess

import numpy as np
import torch

from ..ops import kbench_cuda
from ..ops.kbench_torch import REPS, SHAPE

ITERS = 10
# name: (kernel, dtype, keyword arguments), as in tools/kbench.py main()
CASES = {
    "alu_i32": ("alu", torch.int32, {}),
    "alu_i16": ("alu", torch.int16, {}),
    "alu_f32": ("alu", torch.float32, {}),
    "alu_bf16": ("alu", torch.bfloat16, {}),
    "shift_i32": ("shift", torch.int32, {}),
    "shift_i16": ("shift", torch.int16, {}),
    "roll_i32": ("shift", torch.int32, {"roll": True}),
    "shift8": ("shift", torch.int32, {"amount": 8}),
    "shift64": ("shift", torch.int32, {"amount": 64}),
    "shift3": ("shift", torch.int32, {"amount": 3}),
    "scan256": ("scan", torch.int32, {}),
}


def card():
    """`name, power limit` of the first card, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters=ITERS):
    """Device ms per call: CUDA events around `iters` calls after one. A
    spin of about 5 ms on the stream first lets the host queue every call
    before the first starts, so a kernel of tens of microseconds is timed
    back to back and not at the pace of its launches."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def case_input(name, device, seed=None, shape=SHAPE):
    """The case's input: zeros, as the TPU tool gives, or seeded values
    that keep every chain clear of int16 wrap-around and carry bf16 past
    256, where b + 1 stops growing."""
    dtype = CASES[name][1]
    if seed is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    rng = np.random.default_rng(seed)
    if dtype == torch.float32:
        x = torch.from_numpy((rng.standard_normal(shape) * 300)
                             .astype(np.float32))
    elif dtype == torch.bfloat16:
        x = torch.from_numpy(rng.uniform(-400, 400, shape)
                             .astype(np.float32)).to(dtype)
    else:
        hi = 20000 if dtype == torch.int16 else 100000
        x = torch.from_numpy(rng.integers(-hi, hi, shape)).to(dtype)
    return x.to(device)


def n_total_ops(name):
    """The TPU tool's operation count (tools/kbench.py :75, :107, :149)."""
    kind = CASES[name][0]
    cells = SHAPE[0] * SHAPE[1]
    if kind == "alu":
        return REPS * 8 * cells
    if kind == "shift":
        return REPS * 2 * cells
    return (REPS // 8) * 2 * 8 * cells


def shift_yardstick(x, amount=1, roll=False):
    """T2's output at REPS reps (REPS * amount >= rows) in one PyTorch call:
    with zero fill row p is the max of rows p, p - amount, ... and of 0,
    the cummax down each residue chain clamped at 0 (rows padded to a
    multiple of amount); wrapped round, the max over p's residue class mod
    gcd(amount, rows)."""
    rows, cols = x.shape
    if roll:
        g = math.gcd(amount, rows)
        return x.view(rows // g, g, cols).amax(0, keepdim=True).expand(
            rows // g, g, cols).reshape(rows, cols)
    n = -(-rows // amount) * amount
    xp = x if n == rows else torch.cat([x, x.new_zeros(n - rows, cols)])
    return torch.cummax(xp.view(n // amount, amount, cols), 0).values.view(
        n, cols)[:rows].clamp_min(0)


def scan_yardstick(x, reps=REPS):
    """T3's output where every value stays above NEG (the fill then never
    wins): reps // 8 times torch.cummax down the rows, less 1."""
    a = x
    for _ in range(reps // 8):
        a = torch.cummax(a, 0).values - 1
    return a


def yardstick(name, x):
    """A T2 or T3 case's output at REPS by its yardstick."""
    kind, _, kw = CASES[name]
    if kind == "scan":
        return scan_yardstick(x)
    return shift_yardstick(x, kw.get("amount", 1), kw.get("roll", False))


def run_case(name, x, reps=REPS):
    kind, _, kw = CASES[name]
    return getattr(kbench_cuda, kind)(x, reps, **kw)


def main(argv=None):
    """Runs the cases; {name: (us per call or None on the CPU, Tops/s or
    None, output)}."""
    ap = argparse.ArgumentParser(prog="python -m metaeuk_tpu_torch.tools."
                                 "kbench", description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("cases", nargs="*", metavar="case",
                    help=f"any of {', '.join(CASES)} (default: all)")
    args = ap.parse_args(argv)
    unknown = [c for c in args.cases if c not in CASES]
    if unknown:
        ap.error(f"unknown cases {unknown}")
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: use --device cpu for the "
                             "plain versions")
        print(f"device: {card()} platform=gpu", flush=True)
    else:
        print("device: cpu (plain PyTorch versions, not timed)", flush=True)
    results = {}
    for name in args.cases or list(CASES):
        x = case_input(name, args.device)
        out = run_case(name, x)
        if args.device == "cpu":
            results[name] = (None, None, out)
            print(f"{name:12s}: plain version ran, not timed", flush=True)
            continue
        sec = time_ms(lambda: run_case(name, x)) / 1e3
        tops = n_total_ops(name) / sec / 1e12
        results[name] = (sec * 1e6, tops, out)
        print(f"{name:12s}: {sec * 1e6:9.1f} us/call  {tops:7.3f} Tops/s",
              flush=True)
    return results


if __name__ == "__main__":
    main()
