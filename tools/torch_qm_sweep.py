#!/usr/bin/env python3
"""Where the query-major gate should sit on the card: a METAEUK_QM_MIN sweep
of metaeuk_tpu_torch's align stage on the 0.4 Mbp / 3000-target ungapped
slice (chip_smoke.py phase 5b's), on one CUDA device.

    python3 tools/torch_qm_sweep.py [--mins 8,24,48,96] [--rounds 2]

The candidate pairs come from one run of the ungapped prefilter; the same
pairs are then aligned by a fresh SearchDriver under the default routing
(auto) at each QM_MIN_CANDS, in turns (the list, then the list reversed, for
each round), and once under METAEUK_QM=off. Every run's hit array must equal
the first one's field by field. Prints the card's name and power limit, then
one JSON line per run (align-phase seconds, launches, pairs routed
query-major) and exits non-zero on any difference. The defaults of the
driver are left as they are.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SLICE = dict(mbp=0.4, targets=3000, seed=20260820)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mins", default="8,24,48,96")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the sweep needs one GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    from metaeuk_tpu_torch.io.seqdb import DBTYPE_AA, DBTYPE_NUCL, SeqDB
    from metaeuk_tpu_torch.ops import sw_cuda
    from metaeuk_tpu_torch.ops.orf import OrfExtractor
    from metaeuk_tpu_torch.params import Params
    from metaeuk_tpu_torch.search import driver
    from metaeuk_tpu_torch.search.prefilter import UngappedPrefilter
    from tools.make_metagenome import make_metagenome, write_fasta

    p = Params(prefilter_mode="ungapped")
    mins = [int(m) for m in args.mins.split(",")]
    runs = [("auto", m) for _ in range(args.rounds)
            for m in (mins + mins[::-1])] + [("off", None)]
    with tempfile.TemporaryDirectory(prefix="meuk_sweep") as td:
        td = pathlib.Path(td)
        contigs, proteins = make_metagenome(SLICE["mbp"], SLICE["targets"],
                                            SLICE["seed"])
        write_fasta(td / "u.fna", contigs)
        write_fasta(td / "u.faa", proteins)
        ex = OrfExtractor(p)
        db = SeqDB.from_fasta(str(td / "u.fna"), DBTYPE_NUCL)
        orf_aa = []
        for ci in range(len(db)):
            _, frags = ex.extract_contig(db.seq_bytes(ci), ci)
            orf_aa.extend(ex.translate_fragments(frags))
        targets = SeqDB.from_fasta(str(td / "u.faa"), DBTYPE_AA)
        pairs = UngappedPrefilter(p, targets, p.min_diag_score,
                                  device="cuda").candidate_pairs(orf_aa)
        counts = np.bincount(pairs[:, 0], minlength=len(orf_aa))
        print(json.dumps({"slice": SLICE, "fragments": len(orf_aa),
                          "pairs": len(pairs)}), flush=True)
        ref = None
        for mode, m in runs:
            os.environ["METAEUK_QM"] = mode
            if m is not None:
                driver.QM_MIN_CANDS = m
            sw_cuda.reset_counts()
            driver.PHASE_SECONDS.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hits = driver.SearchDriver(p, targets, "cuda").search(
                orf_aa, pair_generator=pairs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if ref is None:
                ref = hits
            elif len(hits) != len(ref) or any(
                    not np.array_equal(hits[f], ref[f])
                    for f in ref.dtype.names):
                raise AssertionError(f"METAEUK_QM={mode} QM_MIN_CANDS={m}: "
                                     "the hit array differs")
            dense = int(counts[counts >= m].sum()) if m is not None else 0
            print(json.dumps({
                "METAEUK_QM": mode, "QM_MIN_CANDS": m, "wall_s": wall,
                "align_phase_s": sum(driver.PHASE_SECONDS.values()),
                "phases": dict(driver.PHASE_SECONDS),
                "pairs_of_dense_queries": dense, "hits": len(hits),
                "launches": dict(sw_cuda.LAUNCHES)}), flush=True)
    print("all runs gave the same hit array", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
