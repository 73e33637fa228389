#!/usr/bin/env python3
"""Where a slice's time goes, for one or more checkouts of the repository
on one CUDA device, with CUDA events around every kernel launch: by
default the long-frame slice of chip_smoke.py phase 5c's first run
(metaeuk_tpu_torch easy-predict --prefilter-mode ungapped on
tests/golden/make_long_slice.py CHIP_SLICE); with --slice kmer the k-mer
slice of phase 5 (easy-predict on the 1.6 Mbp / 3000-target metagenome of
tests/golden/multichip_slice.json, the pipelined path).

    python3 tools/torch_long_frame_ab.py [--slice long|kmer] [CHECKOUT ...]

Each CHECKOUT (default: this one) runs in a process of its own, in the order
given (name a parent and a change as parent, change, change, parent), with
its own package, generator and kernel sources; the kernels and the host
library are built before the timed run. Prints the card's name and power
limit, then one JSON line per run: wall, stage and align-phase seconds,
launches and summed kernel milliseconds of each kernel (the gapless
kernels' also by staged query width, "gapless_long Lq 32768"), and the
sha256 of the four outputs. Exits non-zero if a run fails or the outputs
differ between runs.
"""

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


def one(checkout, which):
    """The timed run of one checkout on slice `which`: its JSON line."""
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

    with ThreadPoolExecutor(len(SOURCES) + 1) as ex:
        host = ex.submit(native.get_lib)
        for f in [ex.submit(_build.load, s) for s in SOURCES]:
            f.result()
        if host.result() is None:
            raise RuntimeError("the native host library did not build")
    with tempfile.TemporaryDirectory(prefix="meuk_ab") as td:
        td = pathlib.Path(td)
        if which == "kmer":
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
                as gap_ev:
            ep = EasyPredict(params, device="cuda")
            ep.run(str(td / "l.fna"), str(td / "l.faa"), str(td / "out"),
                   tmp_dir=tmp)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kernels = smoke.event_ms({**sw_ev, **gap_ev})
        return {"checkout": str(checkout), "slice": which, "wall_s": wall,
                "stages": {**ep.predict_stage_seconds, **ep.stage_seconds},
                "phases": dict(driver.PHASE_SECONDS),
                "kernels_launches_ms": kernels,
                "sha256": smoke.digests(td / "out")}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1], argv[2])), flush=True)
        return 0
    which = "long"
    if argv[:1] == ["--slice"]:
        which, argv = argv[1], argv[2:]
        if which not in ("long", "kmer"):
            print("--slice takes long or kmer", file=sys.stderr)
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
                              which], capture_output=True, text=True)
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
