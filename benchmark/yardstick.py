"""The yardstick of the kernel metrics: the work a job needs, counted from
true lengths, the least operations a cell of it takes on Hopper, the
card's peak issue rate, and the reduction of a profiler trace to busy
time, stage device time, top operations and idle gaps.

Operations a cell (the derivation is in ROOFLINE.md beside this file):

- gapless: D' = max(D + S, 0) is one fused add-max (VIADDMNMX) a cell,
  and the running best one three-input max a cell pair; scores fit 16
  bits, so both run in the 16x2 packed forms: 0.5 + 0.25 = 0.75
  instructions a cell.
- Smith-Waterman: H = max(Hd + S, E) (one add-max), max(., F, 0) (one
  three-input max with relu), H - go (one add), E' and F' (one add-max
  each), the best (half a three-input max): 5.5 instructions, in the 16x2
  packed forms (H is capped at 32767): 2.75 a cell.

The peak: no SM issues more than 4 warp instructions a clock (128 lanes),
at the card's maximum SM clock, on every SM. Nothing a kernel does can
beat that, so a share of it cannot pass 100%.
"""

import subprocess

import numpy as np
import torch

GAPLESS_OPS = 0.75
SW_OPS = 2.75
LANES_PER_SM_CLOCK = 128


def peak_ops_per_s(device=0):
    """(instructions a second, facts): 128 lanes a clock on every SM at
    the card's maximum SM clock as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={device}", "--query-gpu=clocks.max.sm,"
         "clocks.sm,power.limit,name", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip()
    max_mhz, cur_mhz, power, name = [x.strip() for x in out.split(",")]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    peak = LANES_PER_SM_CLOCK * sms * float(max_mhz) * 1e6
    return peak, dict(sms=sms, max_sm_mhz=float(max_mhz),
                      sm_mhz=float(cur_mhz), power_limit_w=float(power),
                      name=name)


def gapless_cells(query_lens, db_res):
    """Cells of every query against every target: sum(q) * sum(t)."""
    return int(np.sum(query_lens, dtype=np.int64)) * int(db_res)


def sw_cells(pairs, q_lens, t_lens, hits):
    """Forward cells over the candidate pairs' true lengths, and reverse
    cells from each returned hit's ends."""
    fwd = int(np.sum(q_lens[pairs[:, 0]].astype(np.int64)
                     * t_lens[pairs[:, 1]].astype(np.int64)))
    rev = int(np.sum((hits["q_end"].astype(np.int64) + 1)
                     * (hits["t_end"].astype(np.int64) + 1)))
    return fwd + rev


def _union(iv):
    """Total length of a union of (start, end) intervals, and the gaps
    between them: (busy, [(gap start, gap end)])."""
    if not iv:
        return 0.0, []
    iv = sorted(iv)
    busy, gaps = 0.0, []
    s, e = iv[0]
    for a, b in iv[1:]:
        if a > e:
            busy += e - s
            gaps.append((e, a))
            s, e = a, b
        else:
            e = max(e, b)
    return busy + (e - s), gaps


class Trace:
    """A profiler's events over the window, in seconds on one clock:
    device operations (name, start, end) and the benchmark's host ranges
    (name, start, end)."""

    def __init__(self, prof):
        dev, host = [], []
        for ev in prof.events():
            t0, t1 = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                if not ev.name.startswith("bench."):
                    dev.append((ev.name, t0, t1))
            elif ev.name.startswith("bench."):
                host.append((ev.name[len("bench."):], t0, t1))
        self.dev = dev
        self.host = host

    def busy(self):
        """(seconds with a device operation running, idle gaps)."""
        return _union([(a, b) for _, a, b in self.dev])

    def stage_device_s(self, name):
        """Device seconds of every operation that ran inside a host range
        of `name` (a stage ends in host arrays, so its operations end
        inside it)."""
        total = 0.0
        for n, lo, hi in self.host:
            if n == name:
                total += sum(b - a for _, a, b in self.dev
                             if a >= lo and b <= hi)
        return total

    def breakdown(self, n=10):
        """The device operations that took most time, and the idle time
        of the window (the benchmark's job ranges) summed by the innermost
        host range open over it."""
        by_op = {}
        for name, a, b in self.dev:
            by_op[name] = by_op.get(name, 0.0) + (b - a)
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:n]
        jobs = [(a, b) for name, a, b in self.host if name == "job"]
        lo = min(a for a, _ in jobs)
        hi = max(b for _, b in jobs)
        busy = [(max(a, lo), min(b, hi)) for _, a, b in self.dev
                if b > lo and a < hi]
        _, gaps = _union(busy + [(lo, lo), (hi, hi)])
        by_host = {}
        for g0, g1 in gaps:
            # cut the gap where host ranges open or close inside it, and
            # give each piece to the innermost range open over it
            cuts = sorted({g0, g1} | {t for _, a, b in self.host
                                      for t in (a, b) if g0 < t < g1})
            for c0, c1 in zip(cuts, cuts[1:]):
                mid = 0.5 * (c0 + c1)
                open_ = [(b - a, name) for name, a, b in self.host
                         if a <= mid <= b]
                label = min(open_)[1] if open_ else "between jobs"
                by_host[label] = by_host.get(label, 0.0) + (c1 - c0)
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}
