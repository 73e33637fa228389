"""Multi-process easy-predict worker (the reference's MPI-rank role), the
twin of tools/dist_worker.py on torch.distributed.

Started once per process with a shared coordinator address; joins a gloo
process group, runs this process's contig partition through
parallel.multihost.distributed_easy_predict, and lets rank 0 merge the
partition outputs (Prefiltering::runMpiSplits / Alignment::run(mpiRank)
role, lib/mmseqs/src/prefiltering/Prefiltering.cpp:575-770).

    python -m metaeuk_tpu_torch.tools.dist_worker <pid> <nprocs> <host:port>
        <contigs> <targets> <out_prefix> [split] [--device cuda|cpu]

(or python metaeuk_tpu_torch/tools/dist_worker.py ... from a checkout).
With a split count, the target-split prefilter fans splits over the
processes (parallel/dist_prefilter.py). The group only orders files on the
shared filesystem, so it is gloo whatever the device, and processes may
share one GPU. Its rendezvous and barriers wait at most GROUP_TIMEOUT
seconds for a peer.

The last line of standard output is one JSON object: the process's rank,
wall and stage seconds, the driver's aligned cells (search/driver.py
CELLS), each kernel's launches and summed ms (CUDA events around each
launch; 0 on the CPU) and PLAIN_CALLS.
"""

import argparse
import contextlib
import datetime
import json
import pathlib
import sys
import time

GROUP_TIMEOUT = 120


@contextlib.contextmanager
def timed_launches(torch, sw_cuda):
    """CUDA events around each launch through sw_cuda._kernel; yields
    {kernel: [(start, stop)]}, read after a synchronise."""
    kernel, events = sw_cuda._kernel, {}

    def timed(name):
        fn = kernel(name)

        def launch(*args):
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
            rc = fn(*args)
            stop.record()
            events.setdefault(name, []).append((start, stop))
            return rc
        return launch
    sw_cuda._kernel = timed
    try:
        yield events
    finally:
        sw_cuda._kernel = kernel


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m metaeuk_tpu_torch.tools.dist_worker")
    for name in ("pid", "nprocs", "coord", "contigs", "targets",
                 "out_prefix"):
        ap.add_argument(name)
    ap.add_argument("split", nargs="?", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as tdist
    from metaeuk_tpu_torch.ops import sw_cuda
    from metaeuk_tpu_torch.params import Params
    from metaeuk_tpu_torch.parallel.multihost import (
        distributed_easy_predict, process_count)
    from metaeuk_tpu_torch.pipeline.predict import EasyPredict
    from metaeuk_tpu_torch.search import driver

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "available")
    tdist.init_process_group(
        backend="gloo", init_method=f"tcp://{args.coord}",
        world_size=int(args.nprocs), rank=int(args.pid),
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    try:
        assert process_count() == int(args.nprocs), process_count()
        params = Params(split=args.split) if args.split else Params()
        ep = EasyPredict(params, device=device)
        sw_cuda.reset_counts()
        driver.CELLS.update(fwd=0, rev=0)
        t0 = time.perf_counter()
        cuda = device.type == "cuda"
        with (timed_launches(torch, sw_cuda) if cuda
              else contextlib.nullcontext({})) as events:
            distributed_easy_predict(params, args.contigs, args.targets,
                                     args.out_prefix, device=device,
                                     predictor=ep)
            if cuda:
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tdist.destroy_process_group()
    kernels = {k: [n, sum(a.elapsed_time(b) for a, b in events.get(k, []))]
               for k, n in sw_cuda.LAUNCHES.items() if n}
    print(json.dumps({
        "rank": int(args.pid), "wall": wall,
        "stage_seconds": {**getattr(ep, "predict_stage_seconds", {}),
                          **ep.stage_seconds},
        "cells": dict(driver.CELLS), "kernels": kernels,
        "plain_calls": dict(sw_cuda.PLAIN_CALLS)}), flush=True)
    return 0


if __name__ == "__main__":
    if __package__ in (None, ""):
        sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    sys.exit(main())
