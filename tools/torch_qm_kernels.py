#!/usr/bin/env python3
"""Where K3/K4's time goes at chip_smoke.py's two query-major timing shapes,
on one CUDA device.

    python3 tools/torch_qm_kernels.py

For sw_qm_ends (K3) and sw_qm_starts (K4, from K3's ends) at phase 6's
QM_TIME_SHAPE and QM_BUCKET_SHAPE (one launch of the ungapped slices'
largest bucket), timed by CUDA events over 20 calls: the wrapper
(ops/sw_cuda.py, as the driver calls it; the five class launches at once
on their side streams), with the live lanes and true cells of each length
class (a lane's class is the one of the rows it sweeps); then K1/K2's
wrappers on the same pairs. Then the opcodes of each K3/K4 class
instance's step loop (the loop that holds the group's shuffle, from
cuobjdump -sass of the built library). Prints the card's name and power
limit, then one JSON line per measurement. The kernels' outputs are
checked against the plain versions first.
"""

import collections
import json
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def ev_ms(torch, fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def measure(torch, smoke, sw_cuda, sw_torch, tag, staged, qidx, lj):
    TB = sw_torch.TB
    (Lq, Lt), args = (staged[0].shape[1], staged[3].shape[1]), (
        *staged, qidx, lj)
    _, qe, te = sw_torch.qm_ends(*args)
    ends_k4 = (qe.clamp_min(0), te.clamp_min(0))
    n, m = smoke.lane_lengths(torch, staged[2], staged[4], qidx, lj, Lq, Lt)
    caps = torch.tensor([g * r for g, r in sw_cuda.PAIR_CLASSES[:-1]],
                        dtype=torch.int32, device=n.device)
    for name, ends in (("sw_qm_ends", ()), ("sw_qm_starts", ends_k4)):
        wrap = sw_cuda.qm_starts if ends else sw_cuda.qm_ends
        got = wrap(*args, *ends)
        ref = (sw_torch.qm_starts if ends else sw_torch.qm_ends)(*args, *ends)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"{name} disagrees with its plain version")
        rows, cols = n.long(), m.long()
        if ends:
            rows = (torch.minimum(ends[0].long(), rows - 1) + 1).clamp_min(0)
            cols = (torch.minimum(ends[1].long(), cols - 1) + 1).clamp_min(0)
        cells = rows * cols
        cls = torch.bucketize(rows.int(), caps)
        out = {"shape": tag, "kernel": name,
               "wrapper_ms": ev_ms(torch, lambda: wrap(*args, *ends)),
               "classes": [{"G_R": sw_cuda.PAIR_CLASSES[c],
                            "live_lanes": int((cells[cls == c] > 0).sum()),
                            "cells": int(cells[cls == c].sum())}
                           for c in range(len(caps) + 1)]}
        print(json.dumps(out), flush=True)
    live = (lj >= 0).nonzero().squeeze(1)
    lane_q = qidx.long().repeat_interleave(TB)[live]
    t_row = lj.long()[live]
    pair = (staged[0][lane_q], staged[1][lane_q], staged[2][lane_q],
            staged[3][t_row], staged[4][t_row])
    pe, ps = ends_k4[0][live], ends_k4[1][live]
    print(json.dumps({"shape": tag, "pairs": len(live),
                      "sw_pair_ends_ms": ev_ms(
                          torch, lambda: sw_cuda.sw_ends(*pair)),
                      "sw_pair_starts_ms": ev_ms(
                          torch, lambda: sw_cuda.sw_starts(*pair, pe, ps))}),
          flush=True)


def sass_loops(library):
    """{"K3 (G, R)" or "K4 (G, R)": (instructions, {opcode: count})} of the
    wavefront's step loop in each sw_qm_ends/sw_qm_starts class instance:
    of the innermost loops (a backward branch to its target, with no other
    backward branch inside) that hold a shuffle, the one with the most
    VIADDMNMX (for the warp class, its stripes of 16 rows), counting every
    instruction between the branch's target and the branch, the rarely
    taken blocks (the ring's staging, a new best) included."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    line = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_]*)(\.[A-Z0-9_.]+)?([^;]*);")
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = re.search(r"sw_qm_(ends|starts)_kernelILi(\d+)ELi(\d+)E",
                         fn.split("\n", 1)[0])
        if name is None:
            continue
        code = [(int(a, 16), op, rest) for a, op, _, rest in line.findall(fn)]
        loops = []   # (target, branch) of each backward branch
        for addr, op, rest in code:
            target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
            if target is not None and int(target.group(1), 16) < addr:
                loops.append((int(target.group(1), 16), addr))
        for lo, hi in loops:
            if any(lo <= a < b < hi or lo < a < b <= hi for a, b in loops):
                continue
            body = [o for a, o, _ in code if lo <= a <= hi]
            key = (f"K{3 if name.group(1) == 'ends' else 4} "
                   f"({name.group(2)}, {name.group(3)})")
            ops = collections.Counter(body)
            if "SHFL" in ops and ops["VIADDMNMX"] > out.get(key, (0, {}))[1] \
                    .get("VIADDMNMX", 0):
                out[key] = (len(body), dict(ops.most_common(10)))
    return dict(sorted(out.items()))


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the run needs one GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from metaeuk_tpu_torch.ops import sw_cuda, sw_torch
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for tag, staged, qidx, lj in smoke.qm_time_cases(
            torch, np, np.random.default_rng(8), 3000):
        measure(torch, smoke, sw_cuda, sw_torch, tag, staged, qidx, lj)
    from metaeuk_tpu_torch.ops import _build
    for k, (n, ops) in sass_loops(_build.build("sw_qm")).items():
        print(json.dumps({"sass_step_loop": k, "instructions": n,
                          "opcodes": ops}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
