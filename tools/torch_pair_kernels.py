#!/usr/bin/env python3
"""Where K1/K2's time goes at chip_smoke.py's two pair timing shapes, on one
CUDA device.

    python3 tools/torch_pair_kernels.py [--nocap]

For sw_pair_ends (K1) and sw_pair_starts (K2, from the plain version's
ends) at phase 6's TIME_SHAPE and at KMER_PAIR_SHAPE (the k-mer slice's
largest bucket), timed by CUDA events over 20 calls: the wrapper
(ops/sw_cuda.py, as the driver calls it), its work list alone
(pair_classes), the C entry alone on that work list (the five class
launches at once on their side streams), and each length class alone
(the entry with the other classes' bounds empty), with each class's pairs
and true cells; then K1 on the first 64 to 4,096 pairs of TIME_SHAPE,
which shows where a launch stops being bound by the latency of its warps'
steps (the C entry alone). Prints the card's name, power limit and SM
clock during a sustained run, and one JSON line per measurement. The
kernels' outputs are checked against the plain versions first. With
--nocap, the same for the uncapped instances (sw_pair_ends_nocap,
sw_pair_starts_nocap) under the realign matrix, at the two shapes only.
"""

import functools
import json
import pathlib
import subprocess
import sys
import threading
import time

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


def entry(torch, sw_cuda, name, args, ends, order, bounds, scoring=None):
    """A call of the C entry `name` on a fixed work list."""
    scoring = scoring or sw_cuda.default_scoring(args[0].device)
    q, qb, ql, t, tl, *ends, sub = sw_cuda._cuda_inputs(scoring, *args,
                                                        *ends)
    (B, Lq), Lt = q.shape, t.shape[1]
    wide = torch.int64 if name.endswith("_nocap") else torch.int32
    carry = torch.empty((B, Lt), dtype=wide, device="cuda") \
        if Lq > sw_cuda.PAIR_STRIPE else None
    outs = [torch.empty(B, dtype=torch.int32, device="cuda")
            for _ in range(3)]
    keep = (q, qb, ql, t, tl, *ends, sub, order, bounds, carry, *outs)
    argv = [sub.data_ptr(), sub.shape[0], q.data_ptr(), qb.data_ptr(),
            ql.data_ptr(), t.data_ptr(), tl.data_ptr(),
            *(e.data_ptr() for e in ends), B, Lq, Lt, scoring.go,
            scoring.ge, order.data_ptr(), bounds.data_ptr(),
            None if carry is None else carry.data_ptr(),
            *(o.data_ptr() for o in outs)]
    fn = sw_cuda._kernel(name)

    def call():
        rc = fn(*argv, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc}")
        return keep
    return call


def sweep_sizes(n, ends, Lq, Lt, torch):
    """(rows, columns) each pair sweeps, as pair_classes counts them."""
    rows = n[0].long().clamp(0, Lq)
    cols = n[1].long().clamp(0, Lt)
    if ends:
        rows = (torch.minimum(ends[0].long(), rows - 1) + 1).clamp_min(0)
        cols = (torch.minimum(ends[1].long(), cols - 1) + 1).clamp_min(0)
    return rows, cols


def measure(torch, sw_cuda, sw_torch, tag, args, scoring=None):
    """scoring given: the uncapped instances under it."""
    kw = {} if scoring is None else dict(scoring=scoring, cap=None)
    suffix = "" if scoring is None else "_nocap"
    _, qe, te = sw_torch.sw_ends(*args, **kw)
    ends_k2 = (qe.clamp_min(0), te.clamp_min(0))
    Lq, Lt = args[0].shape[1], args[3].shape[1]
    for name, ends in (("sw_pair_ends", ()), ("sw_pair_starts", ends_k2)):
        name += suffix
        wrap = functools.partial(
            getattr(sw_cuda, "sw_ends" if not ends else "sw_starts"), **kw)
        got = wrap(*args, *ends)
        ref = (sw_torch.sw_ends if not ends else sw_torch.sw_starts)(
            *args, *ends, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"{name} disagrees with its plain version")
        order, bounds = sw_cuda.pair_classes(args[2], args[4], Lq, Lt,
                                             *ends)
        rows, cols = sweep_sizes((args[2], args[4]), ends, Lq, Lt, torch)
        out = {"shape": tag, "kernel": name,
               "wrapper_ms": ev_ms(torch, lambda: wrap(*args, *ends)),
               "pair_classes_ms": ev_ms(
                   torch, lambda: sw_cuda.pair_classes(
                       args[2], args[4], Lq, Lt, *ends)),
               "entry_ms": ev_ms(torch, entry(torch, sw_cuda, name, args,
                                              ends, order, bounds, scoring)),
               "classes": []}
        lo = 0
        for c, hi in enumerate(bounds.tolist()):
            part = order[lo:hi].long()
            alone = torch.tensor([0] * c + [hi - lo] * (len(bounds) - c),
                                 dtype=torch.int32, device="cuda")
            ms = ev_ms(torch, entry(torch, sw_cuda, name, args, ends,
                                    order[lo:hi].contiguous(), alone,
                                    scoring)) \
                if hi > lo else 0.0
            out["classes"].append({
                "G_R": sw_cuda.PAIR_CLASSES[c], "pairs": hi - lo,
                "cells": int((rows[part] * cols[part]).sum()), "ms": ms})
            lo = hi
        print(json.dumps(out), flush=True)


def sm_clock(torch, sw_cuda, args, seconds=3.0):
    """nvidia-smi's SM clock and power draw, sampled while K1 runs."""
    samples, done = [], threading.Event()

    def sample():
        while not done.is_set():
            samples.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip())
            time.sleep(0.25)
    th = threading.Thread(target=sample)
    th.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            sw_cuda.sw_ends(*args)
        torch.cuda.synchronize()
    done.set()
    th.join()
    return samples


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
    rng = np.random.default_rng(7)
    Lq, Lt, B = smoke.TIME_SHAPE
    args = smoke.ragged_batch(torch, rng, Lq, Lt, B, "cuda")
    timed = (*args[:2], torch.from_numpy(rng.integers(
        Lq // 2, Lq + 1, B)).int().cuda(), args[3], torch.from_numpy(
        rng.integers(Lt // 2, Lt + 1, B)).int().cuda())
    Lq, Lt, B = smoke.KMER_PAIR_SHAPE
    pct, q_at, t_at = smoke.KMER_PAIR_LENGTHS
    draw = lambda at: torch.from_numpy(np.rint(np.interp(
        rng.uniform(0, 100, B), pct, at))).int().cuda()
    args = smoke.ragged_batch(torch, rng, Lq, Lt, B, "cuda")
    kmer = (*args[:2], draw(q_at), args[3], draw(t_at))
    if "--nocap" in sys.argv[1:]:
        scoring = smoke.realign_scoring("cuda")
        measure(torch, sw_cuda, sw_torch, "TIME_SHAPE", timed, scoring)
        measure(torch, sw_cuda, sw_torch, "KMER_PAIR_SHAPE", kmer, scoring)
        return 0
    measure(torch, sw_cuda, sw_torch, "TIME_SHAPE", timed)
    measure(torch, sw_cuda, sw_torch, "KMER_PAIR_SHAPE", kmer)
    for n in (64, 256, 1024, 2048, 4096):
        part = tuple(a[:n].contiguous() for a in timed)
        order, bounds = sw_cuda.pair_classes(part[2], part[4],
                                             *smoke.TIME_SHAPE[:2])
        print(json.dumps({"shape": "TIME_SHAPE", "kernel": "sw_pair_ends",
                          "pairs": n, "entry_ms": ev_ms(torch, entry(
                              torch, sw_cuda, "sw_pair_ends", part, (),
                              order, bounds))}), flush=True)
    print(json.dumps({"sm_clock_power_during_K1": sm_clock(
        torch, sw_cuda, timed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
