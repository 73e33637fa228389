#!/usr/bin/env python3
"""Gapless cells and K7's bound by staged query width, for the ungapped
prefilter of the slices that chip_smoke.py phases 5b and 5c run.

    python3 tools/torch_gapless_cells.py [ungapped|long ...]

Runs on the CPU (no card, no kernel): ORF extraction and encoding of the
0.4 Mbp ungapped slice (tools/make_metagenome.py, seed 20260820, 3,000
targets) and of the long-frame slice (tests/golden/make_long_slice.py
CHIP_SLICE), then search/prefilter.py cells_by_lq, which the prefilter
itself counts with (CELLS_BY_LQ). Prints one JSON line per slice: the cells
of each staged query width Lq, their total, and the bound of each, two
operations a cell at an H100's int32 rate (chip_smoke.py GAPLESS_OPS and
INT32_OPS_PER_S).
"""

import json
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None):
    argv = (sys.argv[1:] if argv is None else argv) or ["ungapped", "long"]
    sys.path.insert(0, str(ROOT))
    sys.path.insert(1, str(ROOT / "tests" / "golden"))
    import chip_smoke as smoke
    import make_long_slice as mls
    from metaeuk_tpu_torch.io.seqdb import DBTYPE_AA, DBTYPE_NUCL, SeqDB
    from metaeuk_tpu_torch.ops.orf import OrfExtractor
    from metaeuk_tpu_torch.params import Params
    from metaeuk_tpu_torch.search.prefilter import cells_by_lq
    from tools.make_metagenome import make_metagenome, write_fasta

    u = smoke.UNGAPPED_SLICE
    slices = {"ungapped": lambda: make_metagenome(u["mbp"], u["targets"],
                                                  u["seed"]),
              "long": lambda: mls.long_slice(mls.CHIP_SLICE)}
    p = Params(prefilter_mode="ungapped")
    for name in argv:
        contigs, proteins = slices[name]()
        with tempfile.TemporaryDirectory(prefix="meuk_cells") as td:
            write_fasta(f"{td}/c.fna", contigs)
            write_fasta(f"{td}/p.faa", proteins)
            frags = smoke.fragments(OrfExtractor(p), SeqDB.from_fasta(
                f"{td}/c.fna", DBTYPE_NUCL))
            targets = SeqDB.from_fasta(f"{td}/p.faa", DBTYPE_AA)
            t_lens = [len(targets.seq_bytes(i)) for i in range(len(targets))]
        cells = cells_by_lq([len(f) for f in frags], t_lens)
        ms = {Lq: c * smoke.GAPLESS_OPS / smoke.INT32_OPS_PER_S * 1e3
              for Lq, c in cells.items()}
        print(json.dumps({"slice": name, "fragments": len(frags),
                          "targets": len(t_lens), "cells": cells,
                          "total": sum(cells.values()), "bound_ms": ms}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
