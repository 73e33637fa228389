#!/usr/bin/env python3
"""Where a slice's time goes, for one or more checkouts of the repository
on one CUDA device, with CUDA events around every kernel launch: by
default the long-frame slice of chip_smoke.py phase 5c's first run
(metaeuk_tpu_torch easy-predict --prefilter-mode ungapped on
tests/golden/make_long_slice.py CHIP_SLICE); with --slice kmer the k-mer
slice of phase 5 (easy-predict on the 1.6 Mbp / 3000-target metagenome of
tests/golden/multichip_slice.json, the pipelined path); with --slice
ungapped the 0.4 Mbp ungapped slice of phase 5b.

    python3 tools/torch_long_frame_ab.py [--slice long|kmer|ungapped]
        [--qm-shapes] [CHECKOUT ...]

Each CHECKOUT (default: this one) runs in a process of its own, in the order
given (name a parent and a change as parent, change, change, parent), with
its own package, generator and kernel sources; the kernels and the host
library are built before the timed run. Prints the card's name and power
limit, then one JSON line per run: wall, stage and align-phase seconds,
launches and summed kernel milliseconds of each kernel (the gapless
kernels' also by staged query width, "gapless_long Lq 32768"), and the
sha256 of the four outputs. With --qm-shapes the line also holds
"qm_shapes": every launch of the query-major kernels K3/K4 (sw_qm_ends,
sw_qm_starts) by (Lq, Lt) tier: launches, tiles, live lanes a tile, the
tiles' query and the live lanes' target lengths, the rows and columns the
reverse pass sweeps (p10/p50/p90), forward or reverse cells, the bound at
chip_smoke.SW_OPS operations a cell, CUDA-event ms, and the tiles (K3) or
lanes (K4) in each of sw_cuda.PAIR_CLASSES' row classes. The hook reads
each launch's lengths back to the host, so the run's wall and host phases
are not comparable with a run without it. Exits non-zero if a run fails or
the outputs differ between runs.
"""

import contextlib
import importlib.util
import json
import pathlib
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = ("sw_pair", "sw_qm", "sw_qm_rt", "gapless")


def one(checkout, which, qm_shapes=False):
    """The timed run of one checkout on slice `which`: its JSON line, with
    K3/K4's launch shapes if qm_shapes."""
    checkout = pathlib.Path(checkout).resolve()
    sys.path.insert(0, str(checkout))
    sys.path.insert(1, str(checkout / "tests" / "golden"))
    import torch
    spec = importlib.util.spec_from_file_location("smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import make_long_slice as mls
    from metaeuk_tpu_torch import native
    from metaeuk_tpu_torch.ops import _build, sw_cuda, ungapped_cuda
    from metaeuk_tpu_torch.params import Params
    from metaeuk_tpu_torch.pipeline.predict import EasyPredict
    from metaeuk_tpu_torch.search import driver
    from tools.make_metagenome import make_metagenome, write_fasta

    shapes = [] if qm_shapes else None
    with ThreadPoolExecutor(len(SOURCES) + 1) as ex:
        host = ex.submit(native.get_lib)
        for f in [ex.submit(_build.load, s) for s in SOURCES]:
            f.result()
        if host.result() is None:
            raise RuntimeError("the native host library did not build")
    with tempfile.TemporaryDirectory(prefix="meuk_ab") as td:
        td = pathlib.Path(td)
        if which == "ungapped":
            u = smoke.UNGAPPED_SLICE
            contigs, proteins = make_metagenome(u["mbp"], u["targets"],
                                                u["seed"])
            params, tmp = Params(prefilter_mode="ungapped"), str(td / "tmp")
        elif which == "kmer":
            golden = json.loads((checkout / "tests" / "golden" /
                                 "multichip_slice.json").read_text())
            contigs, proteins = make_metagenome(golden["mbp"],
                                                golden["targets"])
            params, tmp = Params(), None
        else:
            contigs, proteins = mls.long_slice(mls.CHIP_SLICE)
            params, tmp = Params(prefilter_mode="ungapped"), str(td / "tmp")
        write_fasta(td / "l.fna", contigs)
        write_fasta(td / "l.faa", proteins)
        driver.PHASE_SECONDS.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with smoke.launch_events(torch, sw_cuda) as sw_ev, \
                smoke.launch_events(torch, ungapped_cuda, by_lq=True) \
                as gap_ev, qm_shape_hook(torch, sw_cuda, shapes):
            ep = EasyPredict(params, device="cuda")
            ep.run(str(td / "l.fna"), str(td / "l.faa"), str(td / "out"),
                   tmp_dir=tmp)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kernels = smoke.event_ms({**sw_ev, **gap_ev})
        out = {"checkout": str(checkout), "slice": which, "wall_s": wall,
               "stages": {**ep.predict_stage_seconds, **ep.stage_seconds},
               "phases": dict(driver.PHASE_SECONDS),
               "kernels_launches_ms": kernels,
               "sha256": smoke.digests(td / "out")}
        if shapes is not None:
            out["qm_shapes"] = qm_shape_table(shapes, sw_cuda, smoke)
        return out


@contextlib.contextmanager
def qm_shape_hook(torch, sw_cuda, shapes):
    """With shapes a list, wraps sw_cuda.qm_ends / qm_starts (which the
    driver looks up at each call) so that each launch appends (kernel, Lq,
    Lt, live lanes a tile, query lengths of the tiles, target lengths and
    swept rows and columns of the live lanes, start and stop events) to
    it; with shapes None, does nothing."""
    if shapes is None:
        yield
        return
    wrapped = {k: getattr(sw_cuda, k) for k in ("qm_ends", "qm_starts")}

    def hook(name, fn):
        def call(q_mat, qb_mat, q_lens, t_mat, t_lens, qidx, lj, *ends,
                 **kw):
            (Lq, Lt), nT = (q_mat.shape[1], t_mat.shape[1]), qidx.shape[0]
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
            outs = fn(q_mat, qb_mat, q_lens, t_mat, t_lens, qidx, lj, *ends,
                      **kw)
            stop.record()
            qi = qidx.long()
            qn = torch.where(qi >= 0, q_lens[qi.clamp_min(0)].long()
                             .clamp(0, Lq), 0)
            live = (lj.long() >= 0).view(nT, -1) & (qi >= 0)[:, None]
            tn = t_lens[lj.long().clamp_min(0)].long().clamp(0, Lt).view(
                nT, -1)
            rows = qn[:, None].expand_as(tn)
            cols = tn
            if ends:
                rows = (torch.minimum(ends[0].long().view(nT, -1), rows - 1)
                        + 1).clamp_min(0)
                cols = (torch.minimum(ends[1].long().view(nT, -1), tn - 1)
                        + 1).clamp_min(0)
            live_tile = live.any(1)
            shapes.append((name, Lq, Lt, live.sum(1)[live_tile].cpu(),
                           qn[live_tile].cpu(), tn[live].cpu(),
                           rows[live].cpu(), cols[live].cpu(), start, stop))
            return outs
        return call

    for k, fn in wrapped.items():
        setattr(sw_cuda, k, hook(k, fn))
    try:
        yield
    finally:
        for k, fn in wrapped.items():
            setattr(sw_cuda, k, fn)


def qm_shape_table(shapes, sw_cuda, smoke):
    """qm_shape_hook's launches summed by kernel and (Lq, Lt) tier, after a
    synchronise."""
    import numpy as np
    import torch
    pct = lambda a: [int(v) for v in np.percentile(a, (10, 50, 90))] \
        if len(a) else []
    caps = [g * r for g, r in sw_cuda.PAIR_CLASSES[:-1]]
    groups = {}
    for name, Lq, Lt, *arrays, start, stop in shapes:
        g = groups.setdefault(f"{name} Lq {Lq} Lt {Lt}",
                              [[] for _ in range(5)] + [0, 0.0])
        for acc, a in zip(g, arrays):
            acc.append(a.numpy())
        g[5] += 1
        g[6] += start.elapsed_time(stop)
    table = {}
    for key, (lanes, qn, tn, rows, cols, n, ms) in sorted(groups.items()):
        lanes, qn, tn, rows, cols = (np.concatenate(a) for a in
                                     (lanes, qn, tn, rows, cols))
        cells = int((rows * cols).sum())
        bound_ms = cells * smoke.SW_OPS / smoke.INT32_OPS_PER_S * 1e3
        by_class = np.bincount(np.searchsorted(
            caps, qn if key.startswith("qm_ends") else rows),
            minlength=len(caps) + 1)
        table[key] = {
            "launches": n, "tiles": len(lanes),
            "live_lanes_p10_50_90": pct(lanes),
            "tiles_under_128_live": int((lanes < 128).sum()),
            "tiles_48_to_127_live": int(((lanes >= 48)
                                         & (lanes < 128)).sum()),
            "lane_slots": 128 * len(lanes), "live_lanes": len(tn),
            "q_len_p10_50_90": pct(qn), "t_len_p10_50_90": pct(tn),
            "rows_p10_50_90": pct(rows), "cols_p10_50_90": pct(cols),
            "cells": cells, "bound_ms": bound_ms, "ms": ms,
            "by_row_class": by_class.tolist()}
    return table


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1], argv[2], argv[3:] == ["--qm-shapes"])),
              flush=True)
        return 0
    which, flags = "long", []
    while argv[:1] in (["--slice"], ["--qm-shapes"]):
        if argv[0] == "--qm-shapes":
            flags, argv = ["--qm-shapes"], argv[1:]
            continue
        which, argv = argv[1], argv[2:]
        if which not in ("long", "kmer", "ungapped"):
            print("--slice takes long, kmer or ungapped", file=sys.stderr)
            return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the run needs one GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    digests = set()
    for checkout in argv or [str(ROOT)]:
        res = subprocess.run([sys.executable, __file__, "--one", checkout,
                              which, *flags], capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        digests.add(json.dumps(json.loads(line)["sha256"], sort_keys=True))
    if len(digests) != 1:
        print("the outputs differ between runs", file=sys.stderr)
        return 1
    print("all runs gave the same four outputs", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
