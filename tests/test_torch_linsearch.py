"""The port's linear search (createlinindex, kmersearch, linsearch,
easy-linsearch) on the CPU against the MMseqs2 goldens and the JAX package.

kmersearch_db and linsearch_workflow (with its ungapped-filter and gapped
intermediates) are held to the reference's goldens in tests/golden/linsearch,
as tests/test_linsearch.py holds metaeuk_tpu; build_linindex's index arrays,
kmersearch_db in both result directions and easy_linsearch to the JAX
package's on the same inputs (easy_linsearch also to the JAX package's
digests in tests/golden/cluster_slice.json); the CLI commands to the JAX
CLI's output bytes. The alignment runs with device="cpu" (the kernels' plain
versions). Every comparison is of bytes or exact values: the tolerance is
exact equality.
"""

import json
import pathlib
import sys

import numpy as np
import pytest

from metaeuk_tpu import cli as jax_cli
from metaeuk_tpu_torch.cli import main
from metaeuk_tpu_torch.ops import sw_cuda

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests" / "golden"))
import make_cluster_slice as mcs  # noqa: E402

DATA = ROOT / "tests" / "data"
GOLDEN = ROOT / "tests" / "golden"
G = GOLDEN / "linsearch"
DB_SUFFIXES = ("", ".index", ".dbtype")


def assert_db_equal(mine, golden, sufs=DB_SUFFIXES):
    for s in sufs:
        assert pathlib.Path(f"{mine}{s}").read_bytes() == \
            pathlib.Path(f"{golden}{s}").read_bytes(), f"{mine}{s}"


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """The fixture's query and target DBs by the port's createdb, and the
    target's linear index by its build_linindex."""
    from metaeuk_tpu_torch.search.linsearch_lin import build_linindex
    td = tmp_path_factory.mktemp("lin")
    assert main(["createdb", str(DATA / "proteins.faa"), str(td / "tdb")]) \
        == 0
    assert main(["createdb", str(DATA / "queries_lin.faa"),
                 str(td / "qdb")]) == 0
    build_linindex(str(td / "tdb"))
    return td


def test_linindex_equals_the_jax_packages(dbs, tmp_path):
    from metaeuk_tpu.search.linsearch_lin import build_linindex as jax_build
    for k in (None, 10):
        from metaeuk_tpu_torch.search.linsearch_lin import build_linindex
        a = build_linindex(str(dbs / "tdb"), str(tmp_path / "p.npz"),
                           kmer_size=k)
        b = jax_build(str(dbs / "tdb"), str(tmp_path / "j.npz"), kmer_size=k)
        pa, pb = np.load(a), np.load(b)
        assert sorted(pa.files) == sorted(pb.files)
        for f in pa.files:
            assert pa[f].dtype == pb[f].dtype
            np.testing.assert_array_equal(pa[f], pb[f])
        assert len(pa["kmer"]) > 0


def test_kmersearch_matches_golden(dbs, tmp_path):
    from metaeuk_tpu_torch.search.linsearch_lin import kmersearch_db
    kmersearch_db(str(dbs / "qdb"), str(dbs / "tdb.linidx.npz"),
                  str(tmp_path / "pref"))
    assert_db_equal(tmp_path / "pref", G / "pref")


@pytest.mark.parametrize("direction", [0, 1])
def test_kmersearch_cli_matches_jax_cli(dbs, tmp_path, direction):
    """kmersearch in both result directions (1, target-centric, is the
    default) through both CLIs."""
    outs = {}
    for side, run in (("port", main), ("jax", jax_cli.main)):
        out = tmp_path / side
        assert run(["kmersearch", str(dbs / "qdb"),
                    str(dbs / "tdb.linidx.npz"), str(out),
                    "--result-direction", str(direction)]) == 0
        outs[side] = [pathlib.Path(f"{out}{s}").read_bytes()
                      for s in DB_SUFFIXES]
    assert outs["port"] == outs["jax"]


def test_kmersearch_self_identity(tmp_path, dbs):
    """Self-search: every target's selected k-mers match its own centers
    (diagonal 0)."""
    from metaeuk_tpu_torch.io import mmseqsdb
    from metaeuk_tpu_torch.search.linsearch_lin import kmersearch_db
    kmersearch_db(str(dbs / "tdb"), str(dbs / "tdb.linidx.npz"),
                  str(tmp_path / "selfpref"))
    entries = dict(mmseqsdb.read_db(str(tmp_path / "selfpref")))
    assert entries
    for key, payload in entries.items():
        own = [ln for ln in payload.decode().splitlines()
               if int(ln.split("\t")[0]) == key]
        assert own and own[0].split("\t")[2] == "0"


def test_linsearch_workflow_matches_golden(tmp_path, dbs):
    """linsearch.sh with its filter: the ungapped rescore, the gapped
    alignment of what it leaves (on K1/K2's plain versions) and the swapped
    result equal the reference's."""
    from metaeuk_tpu_torch.search.linsearch_lin import linsearch_workflow
    sw_cuda.reset_counts()
    linsearch_workflow(str(dbs / "qdb"), str(dbs / "tdb"),
                       str(tmp_path / "lout"), str(tmp_path / "tmp"),
                       device="cpu")
    for f in ("pref", "reverse_ungapaln", "reverse_aln"):
        assert_db_equal(tmp_path / "tmp" / f, G / f)
    assert_db_equal(tmp_path / "lout", G / "lout")
    assert sw_cuda.PLAIN_CALLS["sw_pair_ends"] > 0
    assert not any(sw_cuda.LAUNCHES.values())


def test_easy_linsearch_matches_jax(tmp_path):
    """easy_linsearch (alignment mode 3): the m8 and the result DB equal the
    JAX package's run on the same FASTA files, and the digests its run
    left in cluster_slice.json."""
    from metaeuk_tpu.io.mmseqsdb import read_db
    from metaeuk_tpu.search.searchdb import easy_linsearch as jax_els
    from metaeuk_tpu_torch.search.searchdb import easy_linsearch
    q, t = str(DATA / "queries_lin.faa"), str(DATA / "proteins.faa")
    easy_linsearch(q, t, str(tmp_path / "p.m8"), str(tmp_path / "p"),
                   device="cpu")
    jax_els(q, t, str(tmp_path / "j.m8"), str(tmp_path / "j"))
    got = mcs.linsearch_summary(tmp_path / "p.m8", tmp_path / "p", read_db)
    assert got == mcs.linsearch_summary(tmp_path / "j.m8", tmp_path / "j",
                                        read_db)
    golden = json.loads((GOLDEN / "cluster_slice.json").read_text())
    assert got == (golden["counts"]["easy_linsearch_fixture"],
                   golden["sha256"]["easy_linsearch_fixture"])
    assert got[0]["m8"] > 0
    # the gapped step aligns in mode 3, so its DB differs from linsearch's
    assert (tmp_path / "p" / "search_tmp" / "reverse_aln").read_bytes() != \
        (G / "reverse_aln").read_bytes()


def _lin_case(name, d, fix):
    """argv of linear-search command `name` writing under d, and the files
    it writes; fix holds the fixture DBs."""
    q, t = str(DATA / "queries_lin.faa"), str(DATA / "proteins.faa")
    qdb, tdb = str(fix / "qdb"), str(fix / "tdb")
    db = [f"{d}/out{s}" for s in DB_SUFFIXES]
    return {
        "linsearch": (["linsearch", qdb, tdb, f"{d}/out", f"{d}/tmp"], db),
        "linsearch_cov": (["linsearch", qdb, tdb, f"{d}/out", f"{d}/tmp",
                           "-c", "0.5", "--cov-mode", "0", "--min-seq-id",
                           "0.3"], db),
        "easy-linsearch": (["easy-linsearch", q, t, f"{d}/out.m8",
                            f"{d}/tmp"], [f"{d}/out.m8"]),
        "easy-linsearch_e": (["easy-linsearch", q, t, f"{d}/out.m8",
                              f"{d}/tmp", "-e", "1e-10",
                              "--kmer-per-seq", "30"], [f"{d}/out.m8"]),
    }[name]


@pytest.mark.parametrize("name", ["linsearch", "linsearch_cov",
                                  "easy-linsearch", "easy-linsearch_e"])
def test_lin_cli_matches_jax_cli(dbs, tmp_path, name):
    """The aligning linear-search commands through the port's CLI on the
    CPU write the bytes the JAX CLI writes for the same arguments."""
    outs = {}
    for side, run in (("jax", jax_cli.main), ("port", main)):
        d = tmp_path / side
        d.mkdir()
        argv, files = _lin_case(name, d, dbs)
        assert run(argv + (["--device", "cpu"] if side == "port"
                           else [])) == 0
        outs[side] = [pathlib.Path(f).read_bytes() for f in files]
    assert outs["port"] == outs["jax"]
    assert all(outs["port"])


def test_createlinindex_cli_matches_jax_cli(tmp_path):
    """createlinindex writes <db>.linidx.npz next to the DB, with -k, as the
    JAX CLI does."""
    for side, run in (("port", main), ("jax", jax_cli.main)):
        assert run(["createdb", str(DATA / "proteins.faa"),
                    str(tmp_path / side)]) == 0
        assert run(["createlinindex", str(tmp_path / side), "-k", "11"]) == 0
    pa = np.load(f"{tmp_path / 'port'}.linidx.npz")
    pb = np.load(f"{tmp_path / 'jax'}.linidx.npz")
    for f in pb.files:
        np.testing.assert_array_equal(pa[f], pb[f])
    assert int(pa["params"][0]) == 11
