#!/usr/bin/env python3
"""The gapless kernels against each other on the same launches, at each of
the ungapped prefilter's query buckets: the measurement that places
metaeuk_tpu_torch/ops/ungapped_cuda.py LONG_ROWS and the short rows'
kernel.

    python3 tools/torch_gapless_rows.py [Lq ...]      (needs one CUDA device)

For each Lq (default 32 64 128 256 512 1024), query rows of
Lq / 2 + 1 to Lq aa (seeded random codes and biases) go against the 3,000
targets of the ungapped slice (tools/make_metagenome.py, seed 20260820: the
same target pool at any size), staged per target bucket as
search/prefilter.py stages them, with as many query rows as the
prefilter's cell budget puts in one launch at (Lq, Lt) (at least one). Each
launch is a cross product and runs through ungapped_cuda.launch_cross on
gapless_long and, up to Lq ROWS_MAX (their profiles sit in shared
memory), gapless_pair and gapless_rows; their outputs must be equal, and
each is timed with CUDA events. Prints the card's name and power limit,
one JSON line per (Lq, Lt) launch (with gapless_rows's query rows by the
lanes that scored them, ungapped_cuda.ROW_LANES), then per Lq the summed
ms of each kernel over the target buckets and the fastest kernel.
"""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
BUCKETS = (32, 64, 128, 256, 512, 1024)
ROWS_MAX = 2048


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the run needs one GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from metaeuk_tpu_torch.data.submat import encode_aa
    from metaeuk_tpu_torch.ops import ungapped_cuda
    from metaeuk_tpu_torch.search import prefilter
    from metaeuk_tpu_torch.search.driver import pad_rows
    from tools.make_metagenome import make_metagenome

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _, proteins = make_metagenome(0.001, 3000, 20260820)
    targets = [encode_aa(s) for _, s in proteins]
    t_lens = np.array([len(t) for t in targets])
    t_buckets = np.array([prefilter._bucket(int(n)) for n in t_lens])
    staged = {}
    for Lt in np.unique(t_buckets):
        idx = np.flatnonzero(t_buckets == Lt)
        staged[int(Lt)] = (
            torch.from_numpy(pad_rows([targets[i] for i in idx], int(Lt),
                                      dtype=np.uint8)).cuda(),
            torch.from_numpy(t_lens[idx].astype(np.int32)).cuda())
    budget = prefilter.CELL_BUDGET["cuda"]
    cap = prefilter.MAX_PAIRS_PER_LAUNCH["cuda"]
    rng = np.random.default_rng(7)
    sums = {}
    for Lq in [int(a) for a in argv] or BUCKETS:
        kernels = [k for k in ungapped_cuda.KERNELS
                   if k == "gapless_long" or Lq <= ROWS_MAX]
        total = dict.fromkeys(kernels, 0.0)
        for Lt, (t_mat, tl) in staged.items():
            nt = len(tl)
            rows = max(1, min(cap, max(8, budget // (Lq * Lt))) // nt)
            q = torch.from_numpy(rng.integers(0, 20, (rows, Lq))).to(
                "cuda", torch.uint8)
            qb = torch.from_numpy(rng.integers(-3, 4, (rows, Lq))).to(
                "cuda", torch.int8)
            ql = torch.from_numpy(rng.integers(Lq // 2 + 1, Lq + 1, rows)).to(
                "cuda", torch.int32)
            args = (q, qb, ql, t_mat, tl, 0, rows)
            ungapped_cuda.reset_counts()
            outs = [ungapped_cuda.launch_cross(k, *args) for k in kernels]
            smoke.max_err(torch, outs[1:], outs[:1] * (len(outs) - 1))
            ungapped_cuda.fold_row_lanes()
            lanes = dict(ungapped_cuda.ROW_LANES)
            ms = {k: smoke.time_ms(torch, lambda k=k: ungapped_cuda.
                                   launch_cross(k, *args), 3)
                  for k in kernels}
            cells = int((ql.long()[:, None] * tl.long()[None, :]).sum())
            for k in ms:
                total[k] += ms[k]
            print(json.dumps({"Lq": Lq, "Lt": Lt, "rows": rows,
                              "targets": nt, "cells": cells, "ms": ms,
                              "row_lanes": lanes}), flush=True)
        sums[Lq] = total
    for Lq, total in sums.items():
        fast = min(total, key=total.get)
        print(f"Lq {Lq}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                        total.items())
              + f" over the target buckets; fastest: {fast}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
