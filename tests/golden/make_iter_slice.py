"""The iterative search slice: make_search_slice.py's 4,000 queries against
the k-mer slice's 3,000 targets, searched with `search --num-iterations`,
and tests/golden/iter_slice.json.

The queries and targets are make_search_slice.SEARCH_SLICE's: for each of
targets 0-999 three copies at 90%, 60% and 40% identity, then 1,000 random
decoys. The 40% copies are the queries a profile round should help. The
cut takes every `cut_every`-th query (queries 0, 10, 20, ...: 400 at 10,
all three identities and the decoys), so that the JAX package's CPU run of
it stays under about 40 minutes.

iter_slice() writes the queries (q.faa), the cut (q_cut.faa) and the
targets (t.faa). It uses numpy, the repository's tools/make_metagenome.py
and make_search_slice.search_slice only, so chip_smoke.py can build the
slice on the card.

Run as a script, it runs metaeuk_tpu on the CPU, through its CLI, on the
cut: `search q_cut.faa t.faa out tmp --num-iterations 3 -a` (the CLI's
defaults: -e 1e-3, --e-profile 0.1, no minimum alignment length), and
prints the seconds, the pairs and hits of each step, the profiles of each
profile DB, and the sha256 of the final alignment DB, of profile_0 and
profile_1 and of each step's prefilter DB:

    python3 tests/golden/make_iter_slice.py > tests/golden/iter_slice.json

metaeuk_tpu_torch must give the same digests (chip_smoke.py phase 5g holds
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
HERE = pathlib.Path(__file__).resolve().parent
for p in (ROOT, HERE):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import make_search_slice as mss  # noqa: E402

DB_SUFFIXES = ("", ".index", ".dbtype")
COMMAND = "python3 tests/golden/make_iter_slice.py"
ITER_SLICE = dict(search=mss.SEARCH_SLICE, cut_every=10, num_iterations=3,
                  evalue=1e-3, e_profile=0.1)


def iter_slice(cfg, td):
    """Writes cfg's queries to td/q.faa, its cut to td/q_cut.faa and the
    targets to td/t.faa; returns {"queries", "cut", "targets"}: the three
    paths."""
    from tools.make_metagenome import make_metagenome, write_fasta

    td = pathlib.Path(td)
    s = cfg["search"]
    _, proteins = make_metagenome(s["mbp"], s["targets"], s["seed"])
    queries = mss.search_queries(s, proteins)
    write_fasta(td / "q.faa", queries)
    write_fasta(td / "q_cut.faa", queries[::cfg["cut_every"]])
    write_fasta(td / "t.faa", proteins)
    return {"queries": td / "q.faa", "cut": td / "q_cut.faa",
            "targets": td / "t.faa"}


def search_args(cfg, queries, targets, out, tmp):
    """The CLI arguments of the slice's search (either package's CLI)."""
    return ["search", str(queries), str(targets), str(out), str(tmp),
            "--num-iterations", str(cfg["num_iterations"]), "-a",
            "-e", str(cfg["evalue"]), "--e-profile", str(cfg["e_profile"])]


def sha256(path):
    return hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest()


def db_sha256(path):
    return {s: sha256(f"{path}{s}") for s in DB_SUFFIXES}


def step_dbs(cfg, out, tmp):
    """{name: path} of the run's DBs that the JSON records: each step's
    prefilter DB (pref_<step>) and alignment DB (aln_0, aln_tmp_<step>: the
    step's own hits), the profile DBs (profile_<step>) and the final
    alignment DB (out)."""
    tmp = pathlib.Path(tmp)
    n = cfg["num_iterations"]
    dbs = {}
    for step in range(n):
        dbs[f"pref_{step}"] = tmp / f"pref_{step}"
        dbs[f"aln_{step}"] = tmp / ("aln_0" if step == 0
                                    else f"aln_tmp_{step}")
        if step < n - 1:
            dbs[f"profile_{step}"] = tmp / f"profile_{step}"
    dbs["result"] = pathlib.Path(out)
    return dbs


def summary(cfg, out, tmp, read_db):
    """(counts, digests) of a finished run: the entries' lines of each
    step's prefilter and alignment DB and the entries of each profile DB;
    the sha256 of every DB of step_dbs. read_db: either package's
    io.mmseqsdb.read_db."""
    dbs = step_dbs(cfg, out, tmp)
    counts = {}
    for name, path in dbs.items():
        entries = read_db(str(path))
        counts[name] = len(entries) if name.startswith("profile") else \
            sum(len(p.splitlines()) for _, p in entries)
    return counts, {name: db_sha256(path) for name, path in dbs.items()}


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from metaeuk_tpu import cli
    from metaeuk_tpu.io.mmseqsdb import read_db

    out = {"command": COMMAND, "input": ITER_SLICE}
    with tempfile.TemporaryDirectory() as td:
        td = pathlib.Path(td)
        paths = iter_slice(ITER_SLICE, td)
        t0 = time.perf_counter()
        # the CLI's own line goes to stderr: stdout is the JSON
        with contextlib.redirect_stdout(sys.stderr):
            cli.main(search_args(ITER_SLICE, paths["cut"], paths["targets"],
                                 td / "res", td / "tmp"))
        out["jax_cpu_seconds"] = round(time.perf_counter() - t0, 1)
        out["counts"], out["sha256"] = summary(ITER_SLICE, td / "res",
                                               td / "tmp", read_db)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
