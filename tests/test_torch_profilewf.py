"""The port's profile tools through its CLI against the reference goldens
(and so against metaeuk_tpu, whose tests hold it to the same goldens):
result2profile (tests/golden/r2p), msa2profile (msa), sequence2profile
(util9/s2p*), profile2pssm and convertprofiledb (util), expandaln and
expand2profile (util7), the dbtools6 commands with alignall (util6) and
enrich (enrich/enriched); the rcp_nr binding bit for bit against the JAX
package's. All on the CPU: alignall and enrich with --device cpu, the
kernels' plain versions. The tolerance everywhere is exact equality.
"""

import pathlib
import shutil
import sys

import numpy as np
import pytest

from metaeuk_tpu import native as jax_native
from metaeuk_tpu_torch import native
from metaeuk_tpu_torch.cli import main
from metaeuk_tpu_torch.io.mmseqsdb import write_seqdb
from metaeuk_tpu_torch.io.seqdb import DBTYPE_AA, SeqDB
from metaeuk_tpu_torch.ops import sw_cuda

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from chip_smoke import MSA_CASES, R2P_CASES, copy_db  # noqa: E402

DATA = ROOT / "tests" / "data"
GOLDEN = ROOT / "tests" / "golden"
CRF = chip_smoke.CRF
DB_SUFFIXES = ("", ".index", ".dbtype")
CPU = ["--device", "cpu"]


def assert_db_equal(mine, golden, sufs=DB_SUFFIXES):
    for s in sufs:
        assert pathlib.Path(f"{mine}{s}").read_bytes() == \
            pathlib.Path(f"{golden}{s}").read_bytes(), f"{mine}{s}"


def test_rcp_nr_is_bit_equal_to_the_jax_packages():
    rng = np.random.default_rng(559)
    x = np.concatenate([
        rng.uniform(0.5, 400.0, 5000), rng.integers(1, 2000, 2000),
        np.float32(2.0) ** rng.integers(-120, 120, 500),
        [0.0, 1.0, 3.0, 7.0, 1e-40, 3e38]]).astype(np.float32)
    got, ref = native.rcp_nr(x), jax_native.rcp_nr(x)
    assert got.dtype == np.float32 and ref is not None
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    # one Newton-Raphson step on rcpps: not an exact division
    with np.errstate(divide="ignore", over="ignore"):
        assert not np.array_equal(got, np.float32(1.0) / x)


def test_rcp_nr_raises_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match="native host library"):
        native.rcp_nr(np.ones(3, np.float32))


@pytest.fixture(scope="module")
def r2p(tmp_path_factory):
    """The fixture proteins' DB and the reference's self-search alignment
    DB with backtraces (tests/golden/aln/search_a)."""
    td = tmp_path_factory.mktemp("r2p")
    write_seqdb(str(td / "targetsDB"),
                SeqDB.from_fasta(DATA / "proteins.faa", DBTYPE_AA), DBTYPE_AA)
    copy_db(GOLDEN / "aln" / "search_a", td / "aln")
    return td


@pytest.mark.parametrize("tag", list(R2P_CASES))
def test_result2profile_cli_matches_the_golden(r2p, tag):
    out = r2p / f"out_{tag}"
    db = str(r2p / "targetsDB")
    assert main(["result2profile", db, db, str(r2p / "aln"), str(out),
                 *R2P_CASES[tag]]) == 0
    assert_db_equal(out, GOLDEN / "r2p" / tag)


@pytest.mark.parametrize("tag", list(MSA_CASES))
def test_msa2profile_cli_matches_the_golden(tmp_path, tag):
    src, extra = MSA_CASES[tag]
    assert main(["msa2profile", str(GOLDEN / "msa" / src),
                 str(tmp_path / "prof"), "--match-mode", "1", *extra]) == 0
    assert_db_equal(tmp_path / "prof", GOLDEN / "msa" / tag)


def test_msa2profile_filter_options_match_the_golden(tmp_path):
    """The MsaFilter options the CLI has no flag for (max seq id, diff),
    through the port's msa_db_to_profile_db."""
    from metaeuk_tpu_torch.io.mmseqsdb import read_db
    from metaeuk_tpu_torch.pipeline.msa2profile import msa_db_to_profile_db
    entries = [(k, v.decode()) for k, v in read_db(GOLDEN / "msa" / "msadb2")]
    msa_db_to_profile_db(entries, str(tmp_path / "prof"), match_mode=1,
                         filter_msa=True, filter_max_seq_id=0.5, ndiff=2)
    assert read_db(tmp_path / "prof") == \
        read_db(GOLDEN / "msa" / "refprof2_f1s")


@pytest.fixture(scope="module")
def qdb(tmp_path_factory):
    td = tmp_path_factory.mktemp("s2p")
    assert main(["createdb", str(DATA / "proteins.faa"), str(td / "qdb")]) \
        == 0
    return td / "qdb"


@pytest.mark.parametrize("tag,extra", [("s2p", []),
                                       ("s2p_tau", ["--tau", "0.35"])])
def test_sequence2profile_cli_matches_the_golden(qdb, tmp_path, tag, extra):
    assert main(["sequence2profile", str(qdb), str(tmp_path / "o"),
                 "--context-lib", CRF, *extra]) == 0
    assert_db_equal(tmp_path / "o", GOLDEN / "util9" / tag)


def test_profile2pssm_and_convertprofiledb_cli_match_the_goldens(tmp_path):
    util = GOLDEN / "util"
    prof = str(GOLDEN / "r2p" / "refr2p")
    assert main(["profile2pssm", prof, str(tmp_path / "pssm")]) == 0
    assert (tmp_path / "pssm").read_bytes() == (util / "refpssm").read_bytes()
    assert main(["profile2pssm", prof, str(tmp_path / "pssmdb"),
                 "--db-output", "1"]) == 0
    assert_db_equal(tmp_path / "pssmdb", util / "refpssm_db", ("", ".index"))
    assert main(["convertprofiledb", str(DATA / "hhmdb"),
                 str(tmp_path / "cvt")]) == 0
    assert_db_equal(tmp_path / "cvt", util / "refcvt",
                    (*DB_SUFFIXES, "_h", "_h.index"))


@pytest.fixture(scope="module")
def searched(tmp_path_factory):
    """queries_lin against the fixture proteins through the port: createdb,
    prefilter_db and align_db with backtraces (alignment on the CPU), the
    inputs of tests/test_util6.py's and test_util7.py's goldens."""
    from metaeuk_tpu_torch.search.align_module import align_db
    from metaeuk_tpu_torch.search.searchdb import prefilter_db
    td = tmp_path_factory.mktemp("searched")
    for fasta, db in (("queries_lin.faa", "qdb"), ("proteins.faa", "tdb")):
        assert main(["createdb", str(DATA / fasta), str(td / db)]) == 0
    prefilter_db(str(td / "qdb"), str(td / "tdb"), str(td / "pref"),
                 sensitivity=4.0)
    align_db(str(td / "qdb"), str(td / "tdb"), str(td / "pref"),
             str(td / "aln"), evalue=1e-3, add_backtrace=True, device="cpu")
    copy_db(GOLDEN / "util7" / "selfaln", td / "selfaln")
    return td


@pytest.mark.parametrize("tool,tag", [("expandaln", "expaln"),
                                      ("expand2profile", "expprof")])
def test_expand_cli_matches_the_golden(searched, tmp_path, tool, tag):
    d = searched
    assert main([tool, str(d / "qdb"), str(d / "tdb"), str(d / "aln"),
                 str(d / "selfaln"), str(tmp_path / tag)]) == 0
    assert_db_equal(tmp_path / tag, GOLDEN / "util7" / tag)


def test_expand2profile_pcmode1_matches_the_golden(searched, tmp_path):
    """Context pseudocounts, which the CLI has no flag for, through the
    port's expandaln_db."""
    from metaeuk_tpu_torch.pipeline.expand import expandaln_db
    d = searched
    expandaln_db(str(d / "qdb"), str(d / "tdb"), str(d / "aln"),
                 str(d / "selfaln"), str(tmp_path / "expprof"),
                 return_aln=False, pcmode=1, context_lib=CRF)
    assert_db_equal(tmp_path / "expprof", GOLDEN / "util7" / "expprof_pc1")


def test_profile2seq_and_profile2neff_cli_match_the_goldens(searched,
                                                            tmp_path):
    d, u6 = searched, GOLDEN / "util6"
    assert main(["result2profile", str(d / "qdb"), str(d / "tdb"),
                 str(d / "aln"), str(tmp_path / "prof")]) == 0
    for tool, tag in (("profile2consensus", "p2c"),
                      ("profile2repseq", "p2r")):
        assert main([tool, str(tmp_path / "prof"), str(tmp_path / tag)]) == 0
        assert_db_equal(tmp_path / tag, u6 / tag)
    assert main(["profile2neff", str(tmp_path / "prof"),
                 str(tmp_path / "p2n.txt")]) == 0
    assert (tmp_path / "p2n.txt").read_bytes() == \
        (u6 / "p2n.txt").read_bytes()


def test_msa_and_tab_tools_cli_match_the_goldens(tmp_path):
    u6 = GOLDEN / "util6"
    for out, extra in (("msadb", []), ("msadb_ac",
                                       ["--identifier-field", "1"])):
        assert main(["convertmsa", str(u6 / "test.sto"), str(tmp_path / out),
                     *extra]) == 0
        assert_db_equal(tmp_path / out, u6 / out)
    for out, extra in (("filtered.a3m", ["--max-seq-id", "0.99"]),
                       ("filtered_diff1.a3m", ["--diff", "1", "--max-seq-id",
                                               "0.95"])):
        assert main(["filtera3m", str(u6 / "test.a3m"), str(tmp_path / out),
                     *extra]) == 0
        assert (tmp_path / out).read_bytes() == (u6 / out).read_bytes()
    copy_db(u6 / "m8db", tmp_path / "m8db")
    assert main(["summarizetabs", str(tmp_path / "m8db"),
                 str(u6 / "lengths.tsv"), str(tmp_path / "sumtabs")]) == 0
    assert_db_equal(tmp_path / "sumtabs", u6 / "sumtabs")
    assert main(["createdb", str(DATA / "contigs.fna"),
                 str(tmp_path / "ndb")]) == 0
    copy_db(u6 / "nres", tmp_path / "nres")
    assert main(["result2dnamsa", str(tmp_path / "ndb"), str(tmp_path / "ndb"),
                 str(tmp_path / "nres"), str(tmp_path / "dnamsa")]) == 0
    assert_db_equal(tmp_path / "dnamsa", u6 / "dnamsa")


def test_alignall_cli_matches_the_golden(tmp_path):
    """alignall: an exhaustive score-only search within each set, on the
    CPU through K1/K3's plain versions."""
    with open(tmp_path / "all.faa", "wb") as f:
        f.write((DATA / "queries_lin.faa").read_bytes()
                + (DATA / "proteins.faa").read_bytes())
    assert main(["createdb", str(tmp_path / "all.faa"),
                 str(tmp_path / "alldb")]) == 0
    copy_db(GOLDEN / "util6" / "sets", tmp_path / "sets")
    sw_cuda.reset_counts()
    assert main(["alignall", str(tmp_path / "alldb"), str(tmp_path / "sets"),
                 str(tmp_path / "allaln"), *CPU]) == 0
    assert_db_equal(tmp_path / "allaln", GOLDEN / "util6" / "allaln")
    assert sum(sw_cuda.PLAIN_CALLS.values()) > 0
    assert not any(sw_cuda.LAUNCHES.values())


@pytest.fixture(scope="module")
def enrich_dbs(tmp_path_factory):
    td = tmp_path_factory.mktemp("enrich")
    for f in (GOLDEN / "enrich").iterdir():
        shutil.copyfile(f, td / f.name)
    with open(td / "all.faa", "wb") as f:
        f.write((DATA / "queries_lin.faa").read_bytes()
                + (DATA / "proteins.faa").read_bytes())
    assert main(["createdb", str(td / "all.faa"), str(td / "alldb")]) == 0
    assert main(["createdb", str(DATA / "queries_lin.faa"),
                 str(td / "qdb")]) == 0
    return td


def test_enrich_cli_matches_the_golden(enrich_dbs, tmp_path):
    """enrich: the backtraced sliced profile search (K1/K2's PSSM entries),
    result2profile, then three rounds of the profile-query prefilter,
    ProfileQueryAligner (their uncapped instances) and expandaln."""
    d = enrich_dbs
    sw_cuda.reset_counts()
    assert main(["enrich", str(d / "qdb"), str(d / "alldb"),
                 str(d / "profdb"), str(d / "saln"), str(tmp_path / "enr"),
                 str(tmp_path / "tmp"), *CPU]) == 0
    assert_db_equal(tmp_path / "enr", GOLDEN / "enrich" / "enriched")
    assert_db_equal(tmp_path / "tmp" / "search_slice",
                    GOLDEN / "enrich" / "search_slice")
    assert_db_equal(tmp_path / "tmp" / "prof_slice",
                    GOLDEN / "enrich" / "prof_slice")
    plain = sw_cuda.PLAIN_CALLS
    assert plain["sw_pair_ends_prof"] > 0
    assert plain["sw_pair_ends_prof_nocap"] > 0
    assert plain["sw_pair_starts_prof_nocap"] > 0


def test_chip_smoke_profile_workflows_on_cpu(tmp_path):
    """chip_smoke.py's phase 4g, rehearsed on the CPU: every output of the
    iterative search and the profile tools on the fixtures equal to its
    golden, the alignment through the plain versions."""
    from metaeuk_tpu_torch import cli
    sw_cuda.reset_counts()
    n = chip_smoke.check_profile_workflows(cli, "cpu", tmp_path)
    assert n == len(chip_smoke.ITER_GOLDENS) + len(R2P_CASES) \
        + len(MSA_CASES) + 1 + 2 + 3 + 13 + 1
    assert not any(sw_cuda.LAUNCHES.values())
    assert sw_cuda.PLAIN_CALLS["sw_pair_ends_prof_nocap"] > 0


@pytest.mark.parametrize("argv", [
    ["alignall", "a", "b", "c"],
    ["enrich", "a", "b", "c", "d", "e", "f"]])
def test_aligning_profile_commands_default_to_cuda(argv, monkeypatch):
    """alignall and enrich take --device, default cuda, and raise without
    a card."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
