"""The cluster slice: make_search_slice.py's 3,000 targets and 4,000 queries
in one protein DB, clustered and searched linearly, and
tests/golden/cluster_slice.json.

The targets are the proteins of make_metagenome(1.6, 3000, 20260820)
(tools/make_metagenome.py), the k-mer slice's target DB; the queries are
make_search_slice.SEARCH_SLICE's: three copies of each of targets 0-999 at
90%, 60% and 40% identity (queries 3i, 3i + 1, 3i + 2 come from target
i), then 1,000 random decoys. So the DB holds 1,000 planted families of
four members, 2,000 targets without a copy and 1,000 decoys: linclust at
--min-seq-id 0.9 catches the 90% copies, the cascade of `cluster` at 0
the rest.

cluster_slice() writes:

- all.faa: the 3,000 targets, then the 4,000 queries (7,000 proteins, the
  input of easy-cluster and easy-linclust);
- q.faa and t.faa: the queries and the targets (easy-linsearch's);
- the cut, which keeps whole families: cut.faa holds targets
  CUT["family_targets"] (0-199), their 600 copies, the targets
  CUT["other_targets"] (1000-1199, no copy) and the decoys CUT["decoys"]
  (0-199), in all.faa's order (1,200 proteins); q_cut.faa and t_cut.faa
  hold its 800 queries and its 400 targets.

It uses numpy, the repository's tools/make_metagenome.py and
make_search_slice.py only, so chip_smoke.py can build the slice on the
card.

Run as a script, it runs metaeuk_tpu on the CPU, five processes at once,
and prints each run's CPU seconds, counts and the sha256 of its outputs:

- (a) easy_cluster on the cut at its defaults (--min-seq-id 0: sensitivity
  6, three cascade steps, max_seqs 20, the linclust pre-step): the three
  output files, and the DBs of the cascade (clu_redundancy, each step's
  pref_step, aln_step and clu_step, and clu);
- (b) easy_cluster on the cut with use_linclust=True (easy-linclust at its
  defaults: --min-seq-id 0.9, alignment mode 2): the three files and its
  clu DB;
- (a) and (b) again on all.faa, the whole slice, each in a process of its
  own;
- (c) easy_linsearch of the fixture's queries (tests/data/queries_lin.faa
  against tests/data/proteins.faa: the MMseqs2 goldens of
  tests/golden/linsearch hold linsearch, whose alignment mode differs from
  easy-linsearch's), of the cut's 800 queries against its 400 targets, then
  of the 4,000 queries against the 3,000 targets: the m8 and the result DB
  of each.

    python3 tests/golden/make_cluster_slice.py > tests/golden/cluster_slice.json

metaeuk_tpu_torch must give the same digests (chip_smoke.py phase 5h holds
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
COMMAND = "python3 tests/golden/make_cluster_slice.py"
CLUSTER_SLICE = dict(search=mss.SEARCH_SLICE,
                     cut=dict(family_targets=[0, 200],
                              other_targets=[1000, 1200], decoys=[0, 200]))
EASY_FILES = ("_cluster.tsv", "_rep_seq.fasta", "_all_seqs.fasta")
CASCADE_STEPS = 3


def cluster_slice(cfg, td):
    """Writes the files of the module docstring under td; returns {"all",
    "queries", "targets", "cut", "cut_queries", "cut_targets"}: their
    paths."""
    from tools.make_metagenome import make_metagenome, write_fasta

    td = pathlib.Path(td)
    s, cut = cfg["search"], cfg["cut"]
    _, proteins = make_metagenome(s["mbp"], s["targets"], s["seed"])
    queries = mss.search_queries(s, proteins)
    n_copies = len(s["identities"])
    homologs = s["homolog_targets"] * n_copies
    fam, other, dec = (range(*cut[k]) for k in ("family_targets",
                                                "other_targets", "decoys"))
    cut_t = [proteins[i] for i in (*fam, *other)]
    cut_q = [queries[n_copies * i + k] for i in fam
             for k in range(n_copies)] + [queries[homologs + i] for i in dec]
    paths = {"all": td / "all.faa", "queries": td / "q.faa",
             "targets": td / "t.faa", "cut": td / "cut.faa",
             "cut_queries": td / "q_cut.faa",
             "cut_targets": td / "t_cut.faa"}
    write_fasta(paths["all"], proteins + queries)
    write_fasta(paths["queries"], queries)
    write_fasta(paths["targets"], proteins)
    write_fasta(paths["cut"], cut_t + cut_q)
    write_fasta(paths["cut_queries"], cut_q)
    write_fasta(paths["cut_targets"], cut_t)
    return paths


def sha256(path):
    return hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest()


def db_sha256(path):
    return {s: sha256(f"{path}{s}") for s in DB_SUFFIXES}


def lines(read_db, path):
    return sum(len(p.splitlines()) for _, p in read_db(str(path)))


def cluster_summary(prefix, tmp, linclust, read_db):
    """(counts, digests) of a finished easy_cluster run (either package's
    read_db): the three files; the clu DB and its clusters; for the cascade
    (linclust False) the lines of clu_redundancy and of each step's
    prefilter, alignment and cluster DB and their digests."""
    tmp = pathlib.Path(tmp)
    dbs = {"clu": tmp / "clu"}
    if not linclust:
        ct = tmp / "clu_tmp"
        dbs["clu_redundancy"] = ct / "clu_redundancy"
        for step in range(CASCADE_STEPS):
            for name in ("pref_step", "aln_step", "clu_step"):
                dbs[f"{name}{step}"] = ct / f"{name}{step}"
    counts = {name: lines(read_db, path) for name, path in dbs.items()}
    counts["clusters"] = len(read_db(str(tmp / "clu")))
    digests = {f: sha256(f"{prefix}{f}") for f in EASY_FILES}
    digests.update({name: db_sha256(path) for name, path in dbs.items()})
    return counts, digests


def linsearch_summary(m8, tmp, read_db):
    """(counts, digests) of a finished easy_linsearch run: the k-mer
    prefilter's pairs, the ungapped filter's and the gapped step's hits,
    the m8's lines; the m8's and the result DB's sha256."""
    st = pathlib.Path(tmp) / "search_tmp"
    counts = {"pref": lines(read_db, st / "pref"),
              "reverse_ungapaln": lines(read_db, st / "reverse_ungapaln"),
              "reverse_aln": lines(read_db, st / "reverse_aln"),
              "m8": len(pathlib.Path(m8).read_text().splitlines())}
    return counts, {"m8": sha256(m8),
                    "result": db_sha256(pathlib.Path(tmp) / "result")}


def _jax_cpu():
    import jax
    jax.config.update("jax_platforms", "cpu")


def _run_cluster(td, linclust, whole=False):
    """(a) or (b) under td, on the cut or (whole) on the whole slice;
    returns (seconds, counts, digests)."""
    _jax_cpu()
    from metaeuk_tpu.io.mmseqsdb import read_db
    from metaeuk_tpu.pipeline.clusterwf import easy_cluster
    tag = ("el" if linclust else "ec") + ("_full" if whole else "")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        easy_cluster(str(td / ("all.faa" if whole else "cut.faa")),
                     str(td / tag), str(td / f"{tag}_tmp"),
                     use_linclust=linclust)
    seconds = round(time.perf_counter() - t0, 1)
    return (seconds, *cluster_summary(td / tag, td / f"{tag}_tmp", linclust,
                                      read_db))


def _run_linsearch(td):
    """(c): the fixture, the cut, then the whole slice; returns {"fixture":
    ..., "cut": ..., "full": ...}, each (seconds, counts, digests)."""
    _jax_cpu()
    from metaeuk_tpu.io.mmseqsdb import read_db
    from metaeuk_tpu.search.searchdb import easy_linsearch
    data = ROOT / "tests" / "data"
    out = {}
    for run, q, t in (("fixture", data / "queries_lin.faa",
                       data / "proteins.faa"),
                      ("cut", td / "q_cut.faa", td / "t_cut.faa"),
                      ("full", td / "q.faa", td / "t.faa")):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            easy_linsearch(str(q), str(t), str(td / f"ls_{run}.m8"),
                           str(td / f"ls_{run}"))
        out[run] = (round(time.perf_counter() - t0, 1),
                    *linsearch_summary(td / f"ls_{run}.m8", td / f"ls_{run}",
                                       read_db))
    return out


def main():
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    out = {"command": COMMAND, "input": CLUSTER_SLICE}
    with tempfile.TemporaryDirectory() as td:
        td = pathlib.Path(td)
        cluster_slice(CLUSTER_SLICE, td)
        t0 = time.perf_counter()
        with ProcessPoolExecutor(
                5, mp_context=multiprocessing.get_context("spawn")) as ex:
            a = ex.submit(_run_cluster, td, False)
            b = ex.submit(_run_cluster, td, True)
            c = ex.submit(_run_linsearch, td)
            a_full = ex.submit(_run_cluster, td, False, True)
            b_full = ex.submit(_run_cluster, td, True, True)
            runs = {"easy_cluster": a.result(), "easy_linclust": b.result(),
                    **{f"easy_linsearch_{k}": v
                       for k, v in c.result().items()},
                    "easy_cluster_full": a_full.result(),
                    "easy_linclust_full": b_full.result()}
        out["jax_cpu_seconds"] = {k: v[0] for k, v in runs.items()}
        out["jax_cpu_seconds"]["all_at_once"] = round(
            time.perf_counter() - t0, 1)
        out["counts"] = {k: v[1] for k, v in runs.items()}
        out["sha256"] = {k: v[2] for k, v in runs.items()}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
