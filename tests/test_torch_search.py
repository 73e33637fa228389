"""The port's MMseqs2 search workflows against the reference goldens and the
JAX package, on the CPU.

search_db (with its prefilter DB), map_db, rbh_db (with its seven
intermediates), result2rbh_db, easy_search (plain and --greedy-best-hits),
easy_rbh and the 2- and 3-step --sens-steps searches (with their per-step
intermediates) are held to the MMseqs2 binary's goldens in
tests/golden/searchwf and tests/golden/senssteps, as tests/test_searchwf.py
and tests/test_senssteps.py hold the JAX package; SearchDriver.search +
backtraces to tests/golden/aln/search_a, as tests/test_search_backtrace.py
does; the port's CLI commands to the JAX CLI's output bytes. The port runs
with device="cpu" (the kernels' plain versions). Every comparison is of
bytes: the tolerance is exact equality.
"""

import pathlib
import sys

import pytest

from metaeuk_tpu import cli as jax_cli
from metaeuk_tpu_torch import cli, native
from metaeuk_tpu_torch.io.mmseqsdb import read_db
from metaeuk_tpu_torch.io.seqdb import DBTYPE_AA, SeqDB
from metaeuk_tpu_torch.ops import sw_cuda
from metaeuk_tpu_torch.params import Params
from metaeuk_tpu_torch.pipeline.alnformat import hits_to_aln_db_entries
from metaeuk_tpu_torch.search.driver import SearchDriver
from metaeuk_tpu_torch.search.searchdb import (easy_linsearch, easy_rbh,
                                               easy_search, map_db, rbh_db,
                                               result2rbh_db, search_db)

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
DATA = ROOT / "tests" / "data"
GOLDEN = ROOT / "tests" / "golden"
SEARCHWF = GOLDEN / "searchwf"
SENSSTEPS = GOLDEN / "senssteps"
DB_SUFFIXES = ("", ".index", ".dbtype")
RBH_STEPS = ("resAB", "resBA", "resA_best_B", "resB_best_A",
             "resB_best_A_swap", "res_best_merged", "res_best_merged_sorted")


def assert_db_equal(mine, golden):
    for s in DB_SUFFIXES:
        a = pathlib.Path(f"{mine}{s}").read_bytes()
        b = pathlib.Path(f"{golden}{s}").read_bytes()
        assert a == b, f"{mine}{s} != {golden}{s}"


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """The fixture's query and target sequence DBs, by the port's createdb."""
    td = tmp_path_factory.mktemp("searchwf")
    for fasta, db in (("queries_lin.faa", "qdb"), ("queries_steps.faa",
                                                   "sdb"),
                      ("proteins.faa", "tdb")):
        assert cli.main(["createdb", str(DATA / fasta), str(td / db)]) == 0
    return td


def test_search_workflow_defaults(dbs, tmp_path):
    out = tmp_path / "res"
    sw_cuda.reset_counts()
    search_db(str(dbs / "qdb"), str(dbs / "tdb"), str(out),
              str(tmp_path / "stmp"), device="cpu")
    assert_db_equal(tmp_path / "stmp" / "pref_0", SEARCHWF / "search_pref")
    assert_db_equal(out, SEARCHWF / "search")
    assert sw_cuda.PLAIN_CALLS["sw_pair_ends"] > 0
    assert sum(sw_cuda.LAUNCHES.values()) == 0


def test_map_workflow(dbs, tmp_path):
    map_db(str(dbs / "qdb"), str(dbs / "tdb"), str(tmp_path / "map"),
           str(tmp_path / "mtmp"))
    assert_db_equal(tmp_path / "map", SEARCHWF / "map")


def test_rbh_workflow_and_intermediates(dbs, tmp_path):
    out = tmp_path / "rbh"
    rbh_db(str(dbs / "qdb"), str(dbs / "tdb"), str(out),
           str(tmp_path / "rtmp"), device="cpu")
    for f in RBH_STEPS:
        assert_db_equal(tmp_path / "rtmp" / f, SEARCHWF / f"rbh_{f}")
    assert_db_equal(out, SEARCHWF / "rbh")


def test_result2rbh(tmp_path):
    result2rbh_db(str(SEARCHWF / "rbh_res_best_merged_sorted"),
                  str(tmp_path / "r2rbh"))
    assert_db_equal(tmp_path / "r2rbh", SEARCHWF / "r2rbh")


@pytest.mark.parametrize("greedy,golden", [(False, "easysearch.m8"),
                                           (True, "easysearch_greedy.m8")])
def test_easy_search(tmp_path, greedy, golden):
    easy_search(str(DATA / "queries_lin.faa"), str(DATA / "proteins.faa"),
                str(tmp_path / "es.m8"), str(tmp_path / "estmp"),
                greedy_best_hits=greedy, device="cpu")
    assert (tmp_path / "es.m8").read_bytes() == \
        (SEARCHWF / golden).read_bytes()


def test_easy_rbh(tmp_path):
    easy_rbh(str(DATA / "queries_lin.faa"), str(DATA / "proteins.faa"),
             str(tmp_path / "er.m8"), str(tmp_path / "ertmp"), device="cpu")
    assert (tmp_path / "er.m8").read_bytes() == \
        (SEARCHWF / "easyrbh.m8").read_bytes()


def test_three_step_search(dbs, tmp_path):
    out = tmp_path / "res"
    search_db(str(dbs / "sdb"), str(dbs / "tdb"), str(out),
              str(tmp_path / "stmp"), sensitivity=7.5, start_sens=1.0,
              sens_steps=3, device="cpu")
    for step in ("pref_0", "aln_0", "pref_1", "aln_1"):
        assert_db_equal(tmp_path / "stmp" / step,
                        SENSSTEPS / f"steps3_{step}")
    assert_db_equal(out, SENSSTEPS / "steps3")


def test_two_step_search(dbs, tmp_path):
    out = tmp_path / "res"
    search_db(str(dbs / "sdb"), str(dbs / "tdb"), str(out),
              str(tmp_path / "stmp"), sensitivity=7.0, start_sens=2.0,
              sens_steps=2, device="cpu")
    assert_db_equal(out, SENSSTEPS / "steps2")


def test_search_backtrace_byte_parity():
    """The driver's exhaustive self-search with backtraces (alignment mode
    3) gives the reference's result DB, as in test_search_backtrace.py."""
    assert native.get_lib() is not None
    targets = SeqDB.from_fasta(DATA / "proteins.faa", DBTYPE_AA)
    seqs = [targets.seq_bytes(i) for i in range(len(targets))]
    driver = SearchDriver(Params(aln_len_thr=0), targets, device="cpu")
    hits = driver.search(seqs)
    bts, seq_ids = driver.backtraces(hits, seqs)
    assert all(bts)
    mine = dict(hits_to_aln_db_entries(hits, len(targets), bts, seq_ids))
    golden = dict(read_db(GOLDEN / "aln" / "search_a"))
    assert mine == golden


def test_waiting_branches_raise(dbs, tmp_path):
    """The branches that once waited now run: search's nucleotide branch,
    taken on nucleotide FASTA input, writes the JAX CLI's bytes (with --m8
    too; tests/test_torch_dbcli.py holds its --search-type 3 run to the
    MMseqs2 golden); easy_linsearch runs (tests/test_torch_linsearch.py
    holds it)."""
    for tag, main, dev in (("jax", jax_cli.main, []),
                           ("port", cli.main, ["--device", "cpu"])):
        assert main(["search", str(DATA / "contigs.fna"),
                     str(DATA / "contigs.fna"), str(tmp_path / tag),
                     "--m8", str(tmp_path / f"{tag}.m8"), *dev]) == 0
    for s in (*DB_SUFFIXES, ".m8"):
        assert (tmp_path / f"port{s}").read_bytes() == \
            (tmp_path / f"jax{s}").read_bytes(), s
    assert (tmp_path / "port.m8").read_text().count("\n") > 0
    easy_linsearch(str(DATA / "queries_lin.faa"), str(DATA / "proteins.faa"),
                   str(tmp_path / "x.m8"), str(tmp_path / "t"),
                   device="cpu")
    assert (tmp_path / "x.m8").read_text().count("\n") > 0


def _cli_case(name, d, fix):
    """argv of command `name` (without --device) writing under d, and the
    files it writes; fix holds the fixture DBs."""
    q, t = str(DATA / "queries_lin.faa"), str(DATA / "proteins.faa")
    qdb, tdb = str(fix / "qdb"), str(fix / "tdb")
    pref = str(SEARCHWF / "search_pref")
    db = [f"{d}/out{s}" for s in DB_SUFFIXES]
    return {
        "createdb": (["createdb", q, f"{d}/out"],
                     db + [f"{d}/out_h{s}" for s in DB_SUFFIXES]
                     + [f"{d}/out.lookup", f"{d}/out.source"]),
        "search": (["search", q, t, f"{d}/out", "-a", "--m8",
                    f"{d}/out.m8"], db + [f"{d}/out.m8"]),
        "search_ungapped": (["search", q, t, f"{d}/out", "-a",
                             "--prefilter-mode", "ungapped"], db),
        "search_exhaustive": (["search", q, t, f"{d}/out", "--m8",
                               f"{d}/out.m8", "--prefilter-mode",
                               "exhaustive"], db + [f"{d}/out.m8"]),
        "search_profile": (["search", q, str(GOLDEN / "profile" /
                                             "profileDB"), f"{d}/out"], db),
        "search_steps": (["search", qdb, tdb, f"{d}/out", f"{d}/tmp",
                          "--sens-steps", "2", "-s", "7.0",
                          "--start-sens", "2.0"], db),
        "align": (["align", qdb, tdb, pref, f"{d}/out", "-a"], db),
        "align_realign": (["align", qdb, tdb, pref, f"{d}/out", "-a",
                           "--realign"], db),
        "convertalis": (["convertalis", qdb, tdb,
                         str(SEARCHWF / "search"), f"{d}/out.tsv"],
                        [f"{d}/out.tsv"]),
        "easy-search": (["easy-search", q, t, f"{d}/out.m8", f"{d}/tmp"],
                        [f"{d}/out.m8"]),
        "easy-rbh": (["easy-rbh", q, t, f"{d}/out.m8", f"{d}/tmp"],
                     [f"{d}/out.m8"]),
        "rbh": (["rbh", qdb, tdb, f"{d}/out", f"{d}/tmp"], db),
        "map": (["map", qdb, tdb, f"{d}/out", f"{d}/tmp"], db),
        "result2rbh": (["result2rbh",
                        str(SEARCHWF / "rbh_res_best_merged_sorted"),
                        f"{d}/out"], db),
        "lcaalign": (["lcaalign", qdb, tdb, pref, f"{d}/out"], db),
    }[name]


@pytest.mark.parametrize("name", [
    "createdb", "search", "search_ungapped", "search_exhaustive",
    "search_profile", "search_steps", "align", "align_realign",
    "convertalis", "easy-search", "easy-rbh", "rbh", "map", "result2rbh",
    "lcaalign"])
def test_cli_matches_jax_cli(dbs, tmp_path, name):
    """Each search-family command of the port's CLI writes the bytes the
    JAX CLI writes for the same arguments."""
    outs = {}
    for side, main in (("jax", jax_cli.main), ("port", cli.main)):
        d = tmp_path / side
        d.mkdir()
        argv, files = _cli_case(name, d, dbs)
        if side == "port" and name not in ("createdb", "convertalis", "map",
                                           "result2rbh"):
            argv = argv + ["--device", "cpu"]
        assert main(argv) == 0
        outs[side] = [pathlib.Path(f).read_bytes() for f in files]
    assert outs["port"] == outs["jax"]
    assert any(outs["port"])


def test_chip_smoke_search_workflows_on_cpu(tmp_path):
    """chip_smoke.py's phase 4e, rehearsed on the CPU."""
    chip_smoke.check_search_workflows(cli, "cpu", tmp_path)

