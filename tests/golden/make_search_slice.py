"""The search slice: a protein query set against the k-mer slice's 3,000
target proteins, and tests/golden/search_slice.json.

The targets are the proteins of make_metagenome(1.6, 3000, 20260820)
(tools/make_metagenome.py), the k-mer slice's target DB. The queries come
from numpy.random.default_rng(SEARCH_SLICE["query_seed"]):

- for each of targets 0-999, three copies, at 90%, 60% and 40% identity
  (target i gives queries 3i, 3i + 1, 3i + 2, named q<3i+k>_t<i>_<pid>):
  each residue is substituted with probability 1 - identity by a residue
  drawn uniformly from the 20, and at each residue, with probability 0.01,
  an indel of 1-5 residues (an insertion of random residues or a deletion,
  even odds) follows it;
- 1,000 decoys of 321 random residues (decoy<k>).

search_slice() writes both as FASTA. It uses numpy and the repository's
tools/make_metagenome.py only, so chip_smoke.py can build the slice on the
card.

Run as a script, it writes the sha256 of two runs of metaeuk_tpu on the CPU:

- (a) easy_search at its defaults (alignment mode 3, so every accepted hit
  gets a backtrace): its BLAST-tab output and its `result` DB;
- (b) align_db over (a)'s pref_0 with add_backtrace=True, realign=True.

The two runs go at once, in two processes; (b) makes its own copy of
(a)'s prefilter DB with the same calls, and the script checks that the two
copies are equal.

    python3 tests/golden/make_search_slice.py > tests/golden/search_slice.json

metaeuk_tpu_torch must give the same digests (chip_smoke.py phase 5e holds
the port to them on the card).
"""

import hashlib
import json
import pathlib
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

DB_SUFFIXES = ("", ".index", ".dbtype")
COMMAND = "python3 tests/golden/make_search_slice.py"
SEARCH_SLICE = dict(mbp=1.6, targets=3000, seed=20260820,
                    query_seed=20260827, homolog_targets=1000,
                    identities=[0.9, 0.6, 0.4], indel_rate=0.01,
                    indel_max=5, decoys=1000, decoy_len=321)


def mutate(rng, seq, identity, indel_rate, indel_max):
    """seq (uint8 codes 0-19) with substitutions and indels as the module
    docstring says."""
    sub = rng.random(len(seq)) >= identity
    out = np.where(sub, rng.integers(0, 20, len(seq)), seq)
    pieces, i = [], 0
    events = np.flatnonzero(rng.random(len(seq)) < indel_rate)
    skip_to = 0
    for e in events:
        if e < skip_to:
            continue
        n = int(rng.integers(1, indel_max + 1))
        pieces.append(out[i:e + 1])
        if rng.random() < 0.5:   # insertion after residue e
            pieces.append(rng.integers(0, 20, n))
            i = e + 1
        else:                    # deletion of the n residues after e
            i = skip_to = e + 1 + n
    pieces.append(out[i:])
    return np.concatenate(pieces)


def search_queries(cfg, proteins):
    """[(name, AA bytes)]: cfg's homolog copies of proteins, then its
    decoys."""
    from tools.make_metagenome import AA

    lut = np.zeros(256, np.int64)
    lut[AA] = np.arange(20)
    rng = np.random.default_rng(cfg["query_seed"])
    queries = []
    for t in range(cfg["homolog_targets"]):
        codes = lut[np.frombuffer(proteins[t][1], np.uint8)]
        for k, pid in enumerate(cfg["identities"]):
            q = mutate(rng, codes, pid, cfg["indel_rate"], cfg["indel_max"])
            queries.append((f"q{len(queries)}_t{t}_{round(pid * 100)}",
                            AA[q].tobytes()))
    for k in range(cfg["decoys"]):
        queries.append((f"decoy{k}",
                        AA[rng.integers(0, 20, cfg["decoy_len"])].tobytes()))
    return queries


def search_slice(cfg, td):
    """Writes cfg's queries to td/q.faa and targets to td/t.faa; returns
    the two paths."""
    from tools.make_metagenome import make_metagenome, write_fasta

    _, proteins = make_metagenome(cfg["mbp"], cfg["targets"], cfg["seed"])
    td = pathlib.Path(td)
    write_fasta(td / "q.faa", search_queries(cfg, proteins))
    write_fasta(td / "t.faa", proteins)
    return td / "q.faa", td / "t.faa"


def sha256(path):
    return hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest()


def db_sha256(path):
    return {s: sha256(f"{path}{s}") for s in DB_SUFFIXES}


def _jax_cpu():
    import jax
    jax.config.update("jax_platforms", "cpu")


def _run_easy_search(td):
    """(a): metaeuk_tpu's easy_search at its defaults under td/es; returns
    its seconds."""
    _jax_cpu()
    from metaeuk_tpu.search.searchdb import easy_search
    t0 = time.perf_counter()
    easy_search(str(td / "q.faa"), str(td / "t.faa"), str(td / "es.m8"),
                str(td / "es"))
    return time.perf_counter() - t0


def _run_align_realign(td):
    """(b): metaeuk_tpu's align_db with add_backtrace=True, realign=True
    over the prefilter DB that easy_search's search_db writes, made here
    under td/b by the same createdb and prefilter_db calls (they are
    deterministic: main checks that the two prefilter DBs are equal), so
    that (a) and (b) run at once; returns its seconds."""
    _jax_cpu()
    from metaeuk_tpu.search.align_module import align_db
    from metaeuk_tpu.search.searchdb import _ensure_seqdb, prefilter_db
    t0 = time.perf_counter()
    b = td / "b"
    b.mkdir()
    q = _ensure_seqdb(str(td / "q.faa"), str(b / "query"))
    t = _ensure_seqdb(str(td / "t.faa"), str(b / "target"))
    prefilter_db(q, t, str(b / "pref_0"))
    align_db(q, t, str(b / "pref_0"), str(td / "realign"),
             add_backtrace=True, realign=True)
    return time.perf_counter() - t0


def main():
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from metaeuk_tpu.io import mmseqsdb

    out = {"command": COMMAND, "input": SEARCH_SLICE}
    with tempfile.TemporaryDirectory() as td:
        td = pathlib.Path(td)
        search_slice(SEARCH_SLICE, td)
        t0 = time.perf_counter()
        with ProcessPoolExecutor(
                2, mp_context=multiprocessing.get_context("spawn")) as ex:
            a = ex.submit(_run_easy_search, td)
            b = ex.submit(_run_align_realign, td)
            seconds = {"easy_search": round(a.result(), 1),
                       "align_realign": round(b.result(), 1)}
        seconds["both_at_once"] = round(time.perf_counter() - t0, 1)
        out["jax_cpu_seconds"] = seconds
        pref = td / "es" / "search_tmp" / "pref_0"
        if db_sha256(pref) != db_sha256(td / "b" / "pref_0"):
            raise AssertionError("the two prefilter DBs differ")
        out["counts"] = {
            "pairs": sum(len(p.splitlines())
                         for _, p in mmseqsdb.read_db(str(pref))),
            "hits": sum(len(p.splitlines()) for _, p in
                        mmseqsdb.read_db(str(td / "es" / "result"))),
            "realign_hits": sum(len(p.splitlines()) for _, p in
                                mmseqsdb.read_db(str(td / "realign")))}
        out["easy_search"] = {"m8": sha256(td / "es.m8"),
                              "result": db_sha256(td / "es" / "result")}
        out["align_realign"] = db_sha256(td / "realign")
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
