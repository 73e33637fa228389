"""The multihit slice: the k-mer slice's contigs binned into set FASTAs, and
tests/golden/multihit_slice.json.

The contigs are those of make_metagenome(1.6, 3000, 20260820)
(tools/make_metagenome.py), the k-mer slice of chip_smoke.py's phase 5:
245 contigs, taken in order and written as MULTIHIT_SLICE["sets"] files of
MULTIHIT_SLICE["contigs_per_set"] contigs each (set00.fna .. set34.fna):
binned genomes of about 46 kbp. multihitdb builds the set DB over the
files (createdb, extractorfs, translatenucs, orftocontig, the member/set
maps), multihitsearch searches the DB against itself at its defaults (-s
5.7, -e 1e-3, --max-seqs 300; every ORF of every bin against every other)
and aggregates the best hit per target set (besthitperset,
mergeresultsbyset): the gene content shared between bins.

multihit_slice() writes the set files under a directory; it uses numpy and
the repository's tools/make_metagenome.py only, so chip_smoke.py builds the
same files on the card.

Run as a script, it runs metaeuk_tpu on the CPU, two processes at once,
and prints each run's CPU seconds, counts and the sha256 of its DBs: the
seven DBs of multihitdb, multihitsearch's result and aggregate DBs and its
output DB:

- "whole": the 35 sets;
- "cut": the first MULTIHIT_SLICE["cut_sets"] (12) sets;
- "rehearsal": the first MULTIHIT_SLICE["rehearsal_sets"] (3) sets (what
  tests/test_torch_multihit.py runs on the CPU).

    python3 tests/golden/make_multihit_slice.py > tests/golden/multihit_slice.json

metaeuk_tpu_torch must give the same digests (chip_smoke.py phase 5i holds
the port to them on the card).
"""

import contextlib
import hashlib
import json
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

DB_SUFFIXES = ("", ".index", ".dbtype")
COMMAND = "python3 tests/golden/make_multihit_slice.py"
MULTIHIT_SLICE = dict(mbp=1.6, targets=3000, seed=20260820, sets=35,
                      contigs_per_set=7, cut_sets=12, rehearsal_sets=3)
# the DBs multihitdb writes beside its output DB (tests/test_util7.py)
MULTIHITDB_DBS = ("", "_member_to_set", "_set_to_member", "_set_size",
                  "_nucl_contig_to_set", "_nucl_set_to_contig",
                  "_nucl_orf_to_contig")
RUNS = {"whole": "sets", "cut": "cut_sets", "rehearsal": "rehearsal_sets"}


def multihit_slice(cfg, td, n_sets=None):
    """Writes the first n_sets (all by default) set FASTAs under td; returns
    their paths in order."""
    from tools.make_metagenome import make_metagenome, write_fasta

    td = pathlib.Path(td)
    contigs, _ = make_metagenome(cfg["mbp"], cfg["targets"], cfg["seed"])
    k = cfg["contigs_per_set"]
    if len(contigs) != cfg["sets"] * k:
        raise ValueError(f"{len(contigs)} contigs, not {cfg['sets']} sets "
                         f"of {k}")
    paths = []
    for i in range(cfg["sets"] if n_sets is None else n_sets):
        paths.append(td / f"set{i:02d}.fna")
        write_fasta(paths[-1], contigs[k * i:k * (i + 1)])
    return paths


def sha256(path):
    return hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest()


def db_sha256(path):
    return {s: sha256(f"{path}{s}") for s in DB_SUFFIXES}


def lines(read_db, path):
    return sum(len(p.splitlines()) for _, p in read_db(str(path)))


def step_dbs(db, tmp, out):
    """{name: path} of the DBs a run holds: multihitdb's seven (mhdb ..),
    multihitsearch's prefilter, result and aggregate DBs in tmp and its
    output DB."""
    dbs = {f"mhdb{s}": f"{db}{s}" for s in MULTIHITDB_DBS}
    tmp = pathlib.Path(tmp)
    dbs.update(pref=tmp / "search" / "pref_0", result=tmp / "result",
               aggregate=tmp / "aggregate", out=out)
    return dbs


def summary(db, tmp, out, read_db):
    """(counts, digests) of a finished multihitdb + multihitsearch run
    (either package's read_db): the lines of every DB of step_dbs (ORFs in
    mhdb, candidate pairs in pref, hits in result), and the sha256 of each
    but pref."""
    dbs = step_dbs(db, tmp, out)
    counts = {name: lines(read_db, path) for name, path in dbs.items()}
    counts["mhdb"] = len(read_db(str(db)))
    digests = {name: db_sha256(path) for name, path in dbs.items()
               if name != "pref"}
    return counts, digests


def _run(td, run):
    """multihitdb and multihitsearch of metaeuk_tpu on the CPU over the
    run's sets; returns (seconds, counts, digests)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from metaeuk_tpu.io.mmseqsdb import read_db
    from metaeuk_tpu.pipeline.multihit_wf import multihitdb, multihitsearch
    n = MULTIHIT_SLICE[RUNS[run]]
    sets = [td / f"set{i:02d}.fna" for i in range(n)]
    db, out = td / f"{run}_mhdb", td / f"{run}_res"
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        multihitdb([str(s) for s in sets], str(db), str(td / f"{run}_dbtmp"))
        multihitsearch(str(db), str(db), str(out), str(td / f"{run}_tmp"))
    seconds = round(time.perf_counter() - t0, 1)
    return (seconds, *summary(db, td / f"{run}_tmp", out, read_db))


def main():
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    out = {"command": COMMAND, "input": MULTIHIT_SLICE}
    with tempfile.TemporaryDirectory() as td:
        td = pathlib.Path(td)
        multihit_slice(MULTIHIT_SLICE, td)
        t0 = time.perf_counter()
        with ProcessPoolExecutor(
                2, mp_context=multiprocessing.get_context("spawn")) as ex:
            futs = {run: ex.submit(_run, td, run) for run in RUNS}
            runs = {run: f.result() for run, f in futs.items()}
        out["jax_cpu_seconds"] = {k: v[0] for k, v in runs.items()}
        out["jax_cpu_seconds"]["all_at_once"] = round(
            time.perf_counter() - t0, 1)
        out["counts"] = {k: v[1] for k, v in runs.items()}
        out["sha256"] = {k: v[2] for k, v in runs.items()}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
