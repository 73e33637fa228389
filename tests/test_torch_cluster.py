"""The port's clustering family on the CPU against the MMseqs2 goldens and
the JAX package.

cluster_workflow (its linclust pre-step and every cascade step's
intermediates), easy_cluster in both modes, linclust_exact, kmermatcher_db,
clust_db / mergeclusters, pickconsensusrep, clusterupdate, result2msa_db,
convertca3m and the dbtools3 commands are held to the MMseqs2 binary's
goldens in tests/golden/{clusterwf,kmermatcher,ca3m,util8,utils}, as the
JAX package's tests hold metaeuk_tpu, and to metaeuk_tpu's functions and
CLI on the same inputs; cluster_db (pipeline/cluster.py) and the linclust
module of search/linclust.py to the JAX package's. The repaired precision
tables of rescorediagonal's --filter-hits branch against the JAX package's.
chip_smoke.py's phases 4h and 5h, rehearsed on the CPU. The port runs with
device="cpu" (the kernels' plain versions). Every comparison is of bytes
or exact values: the tolerance is exact equality.
"""

import contextlib
import json
import pathlib
import shutil
import sys

import numpy as np
import pytest

from metaeuk_tpu import cli as jax_cli
from metaeuk_tpu_torch import cli, native
from metaeuk_tpu_torch.cli import main
from metaeuk_tpu_torch.ops import sw_cuda

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests" / "golden"))
import chip_smoke  # noqa: E402
import make_cluster_slice as mcs  # noqa: E402

DATA = ROOT / "tests" / "data"
GOLDEN = ROOT / "tests" / "golden"
CW = GOLDEN / "clusterwf"
KM = GOLDEN / "kmermatcher"
U8 = GOLDEN / "util8"
UTILS = GOLDEN / "utils"
DB_SUFFIXES = ("", ".index", ".dbtype")
CPU = ["--device", "cpu"]


def assert_db_equal(mine, golden, sufs=DB_SUFFIXES):
    for s in sufs:
        assert pathlib.Path(f"{mine}{s}").read_bytes() == \
            pathlib.Path(f"{golden}{s}").read_bytes(), f"{mine}{s}"


def test_precision_tables_are_byte_copies():
    for name in ("CovSeqidQscPercMinDiag.lib",
                 "CovSeqidQscPercMinDiagTargetCov.lib", "README.md"):
        assert (ROOT / "metaeuk_tpu_torch" / "data" / "resources" /
                name).read_bytes() == \
            (ROOT / "metaeuk_tpu" / "data" / "resources" / name).read_bytes()


@pytest.mark.parametrize("cov_mode", [0, 1])
@pytest.mark.parametrize("seq_id", [0.0, 0.3, 0.5, 0.72, 0.9, 0.95, 1.0])
def test_precision_lib_matches_the_jax_packages(seq_id, cov_mode):
    """_parse_precision_lib over every coverage of the grid, both tables."""
    from metaeuk_tpu.pipeline.rescorediagonal import \
        _parse_precision_lib as jax_parse
    from metaeuk_tpu_torch.pipeline.rescorediagonal import \
        _parse_precision_lib
    for cov in np.round(np.arange(0.0, 1.01, 0.1), 2):
        assert _parse_precision_lib(seq_id, cov, cov_mode=cov_mode) == \
            jax_parse(seq_id, cov, cov_mode=cov_mode), cov
    assert _parse_precision_lib(0.9, 0.8) == 2.4


@pytest.mark.parametrize("seq_id,cov,cov_mode", [(0.9, 0.8, 0), (0.5, 0.8, 0),
                                                 (0.7, 0.9, 1)])
def test_rescorediagonal_filter_hits_matches_jax(tmp_path, seq_id, cov,
                                                 cov_mode):
    """rescorediagonal's --filter-hits branch (linclust's second rescore)
    on the kmermatcher fixture: the port's output bytes equal the JAX
    package's, and the branch keeps hits."""
    from metaeuk_tpu.pipeline.rescorediagonal import \
        rescorediagonal as jax_rescore
    from metaeuk_tpu_torch.io.mmseqsdb import read_db
    from metaeuk_tpu_torch.pipeline.rescorediagonal import rescorediagonal
    kw = dict(rescore_mode=1, filter_hits=True, seq_id_thr=seq_id,
              cov_thr=cov, cov_mode=cov_mode)
    db, pref = str(KM / "kmF"), str(KM / "refkm2")
    rescorediagonal(db, db, pref, str(tmp_path / "port"), **kw)
    jax_rescore(db, db, pref, str(tmp_path / "jax"), **kw)
    assert_db_equal(tmp_path / "port", tmp_path / "jax")
    assert sum(len(p) for _, p in read_db(str(tmp_path / "port"))) > 0


@pytest.mark.parametrize("tag", list(chip_smoke.KMER_CASES))
def test_kmermatcher_matches_golden_and_jax(tmp_path, tag):
    from metaeuk_tpu.search.kmermatcher import kmermatcher_db as jax_km
    src, extra = chip_smoke.KMER_CASES[tag]
    assert main(["kmermatcher", str(src), str(tmp_path / tag), *extra]) == 0
    assert_db_equal(tmp_path / tag, KM / tag, ("", ".index"))
    kw = {"refkm3": dict(kmers_per_seq=40),
          "refkm4": dict(kmer_size=10)}.get(tag, {})
    jax_km(str(src), str(tmp_path / "jax"), **kw)
    assert_db_equal(tmp_path / tag, tmp_path / "jax")


def test_linclust_exact_matches_golden_and_jax(tmp_path):
    """The linclust chain on the kmermatcher fixture: the cluster DB and
    three intermediates equal the reference's, every intermediate equals
    the JAX package's; the alignment runs on the plain versions."""
    from metaeuk_tpu.search.kmermatcher import linclust_exact as jax_lc
    from metaeuk_tpu_torch.search.kmermatcher import linclust_exact
    sw_cuda.reset_counts()
    linclust_exact(str(KM / "kmF"), str(tmp_path / "clu"),
                   str(tmp_path / "tmp"), device="cpu")
    assert_db_equal(tmp_path / "clu", KM / "reflc", ("", ".index"))
    for st in ("pref_rescore1", "pre_clust", "clust"):
        assert (tmp_path / "tmp" / st).read_bytes() == (KM / st).read_bytes()
    assert sw_cuda.PLAIN_CALLS["sw_pair_ends"] > 0
    assert not any(sw_cuda.LAUNCHES.values())
    jax_lc(str(KM / "kmF"), str(tmp_path / "jclu"), str(tmp_path / "jtmp"))
    assert_db_equal(tmp_path / "clu", tmp_path / "jclu")
    for st in ("pref", "pref_rescore1", "pre_clust", "pref_filter2",
               "pref_rescore2", "aln", "clust"):
        assert_db_equal(tmp_path / "tmp" / st, tmp_path / "jtmp" / st)


def test_clust_and_mergeclusters_match_jax(tmp_path):
    from metaeuk_tpu.pipeline.clust import clust_db as jax_clust
    from metaeuk_tpu.pipeline.clust import mergeclusters as jax_merge
    db = str(KM / "kmF")
    assert main(["clust", db, str(KM / "refkm2"), str(tmp_path / "c")]) == 0
    jax_clust(db, str(KM / "refkm2"), str(tmp_path / "jc"))
    assert_db_equal(tmp_path / "c", tmp_path / "jc")
    steps = [str(KM / "pre_clust"), str(KM / "clust")]
    assert main(["mergeclusters", db, str(tmp_path / "m"), *steps]) == 0
    jax_merge(db, str(tmp_path / "jm"), steps)
    assert_db_equal(tmp_path / "m", tmp_path / "jm")
    assert_db_equal(tmp_path / "m", KM / "reflc", ("",))


@pytest.fixture(scope="module")
def seq_db(tmp_path_factory):
    td = tmp_path_factory.mktemp("clusterwf")
    assert main(["createdb", str(CW / "clusterwf_input.faa"),
                 str(td / "qdb")]) == 0
    return td / "qdb"


def test_cluster_workflow_cascade_matches_golden_and_jax(seq_db, tmp_path):
    """The default cascade (sensitivity 6, 3 steps): the linclust pre-step,
    every step's prefilter, alignment and cluster DB and the result equal
    the reference's; the cascade's subset DBs equal the JAX package's."""
    from metaeuk_tpu.pipeline.clusterwf import cluster_workflow as jax_cw
    from metaeuk_tpu_torch.pipeline.clusterwf import cluster_workflow
    cluster_workflow(str(seq_db), str(tmp_path / "clu"),
                     str(tmp_path / "ctmp"), device="cpu")
    for f in chip_smoke.CASCADE:
        assert_db_equal(tmp_path / "ctmp" / f, CW / f)
    assert_db_equal(tmp_path / "clu", CW / "clu")
    jax_cw(str(seq_db), str(tmp_path / "jclu"), str(tmp_path / "jtmp"))
    for f in ("input_step_redundancy", "input_step1", "input_step2"):
        assert_db_equal(tmp_path / "ctmp" / f, tmp_path / "jtmp" / f)


def test_cluster_workflow_high_seqid_matches_golden(seq_db, tmp_path):
    from metaeuk_tpu_torch.pipeline.clusterwf import cluster_workflow
    cluster_workflow(str(seq_db), str(tmp_path / "clu90"),
                     str(tmp_path / "ctmp"), min_seq_id=0.9, device="cpu")
    assert_db_equal(tmp_path / "clu90", CW / "clu90")


@pytest.mark.parametrize("linclust,tag", [(False, "easycluster"),
                                          (True, "easylinclust")])
def test_easy_cluster_matches_golden(tmp_path, linclust, tag):
    from metaeuk_tpu_torch.pipeline.clusterwf import easy_cluster
    easy_cluster(str(CW / "clusterwf_input.faa"), str(tmp_path / tag),
                 str(tmp_path / "tmp"), use_linclust=linclust, device="cpu")
    for f in chip_smoke.EASY_CLUSTER_FILES:
        assert pathlib.Path(f"{tmp_path / tag}{f}").read_bytes() == \
            (CW / f"{tag}{f}").read_bytes(), f


def test_cluster_db_matches_jax():
    """pipeline/cluster.py: the all-vs-all search + set cover on two
    families; the clusters equal the JAX package's."""
    from metaeuk_tpu.io.seqdb import SeqDB as JaxSeqDB
    from metaeuk_tpu.params import Params as JaxParams
    from metaeuk_tpu.pipeline.cluster import cluster_db as jax_cluster_db
    from metaeuk_tpu_torch.io.seqdb import SeqDB
    from metaeuk_tpu_torch.params import Params
    from metaeuk_tpu_torch.pipeline.cluster import cluster_db
    fam_a = b"MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQAPILSRVGDGTQDNLSG"
    fam_b = b"GCWPNEDTHYFRAMVLDSWQIKNPTTVGGYECLRHSMDAFKVPGLIWEQN"
    seqs = [fam_a, fam_a[:-1] + b"R", fam_b, fam_b[:-1] + b"D",
            fam_a[5:] + b"W"]
    heads = [f"s{i}" for i in range(len(seqs))]
    got = cluster_db(Params(), SeqDB.from_sequences(seqs, headers=heads),
                     device="cpu")
    want = jax_cluster_db(JaxParams(), JaxSeqDB.from_sequences(
        seqs, headers=heads))
    assert got == want
    assert sorted(tuple(sorted(v)) for v in got.values()) == \
        [(0, 1, 4), (2, 3)]


@pytest.fixture(scope="module")
def alldb(tmp_path_factory):
    td = tmp_path_factory.mktemp("util8")
    (td / "all.faa").write_bytes((DATA / "queries_lin.faa").read_bytes()
                                 + (DATA / "proteins.faa").read_bytes())
    assert main(["createdb", str(td / "all.faa"), str(td / "alldb")]) == 0
    return td / "alldb"


def test_pickconsensusrep_matches_golden(alldb, tmp_path):
    """pickconsensusrep: the recomputed cluster alignments on K1/K2's plain
    versions, the profile-vs-member step on the uncapped PSSM instances'."""
    chip_smoke.copy_db(U8 / "clu", tmp_path / "clu")
    sw_cuda.reset_counts()
    assert main(["pickconsensusrep", str(alldb), str(tmp_path / "clu"),
                 str(tmp_path / "consrep"), str(tmp_path / "tmp"),
                 *CPU]) == 0
    assert_db_equal(tmp_path / "consrep", U8 / "consrep")
    assert sw_cuda.PLAIN_CALLS["sw_pair_ends"] > 0
    assert sw_cuda.PLAIN_CALLS["sw_pair_ends_prof_nocap"] > 0
    assert sw_cuda.PLAIN_CALLS["sw_pair_ends_prof"] == 0


def test_clusterupdate_matches_golden(alldb, tmp_path):
    from metaeuk_tpu_torch.pipeline.clusterwf import clusterupdate
    assert main(["createdb", str(DATA / "queries_lin.faa"),
                 str(tmp_path / "olddb")]) == 0
    chip_smoke.copy_db(U8 / "oldclu", tmp_path / "oldclu")
    clusterupdate(str(tmp_path / "olddb"), str(alldb),
                  str(tmp_path / "oldclu"), str(tmp_path / "newmapdb"),
                  str(tmp_path / "newclu"), str(tmp_path / "cutmp"),
                  device="cpu")
    assert_db_equal(tmp_path / "newmapdb", U8 / "newmapdb")
    assert_db_equal(tmp_path / "newclu", U8 / "newclu")


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    td = tmp_path_factory.mktemp("dbt3")
    for fasta, db in (("proteins.faa", "qdb"), ("contigs.fna", "cdb"),
                      ("queries_lin.faa", "ldb")):
        assert main(["createdb", str(DATA / fasta), str(td / db)]) == 0
    return td


@pytest.mark.parametrize("tag", list(chip_smoke.RESULT2MSA_CASES))
def test_result2msa_matches_golden(dbs, tmp_path, tag):
    from metaeuk_tpu_torch.pipeline.result2msa import result2msa_db
    kw = {"msa_sto": dict(msa_format_mode=4),
          "msa_filt": dict(filter_msa=True)}.get(tag, {})
    q = str(dbs / "qdb")
    result2msa_db(q, q, str(UTILS / "selfres"), str(tmp_path / "o"), **kw)
    assert (tmp_path / "o").read_bytes() == (UTILS / tag).read_bytes()
    if tag != "msa_sto":
        assert_db_equal(tmp_path / "o", UTILS / tag)


def test_convertca3m_matches_golden(tmp_path):
    from metaeuk_tpu_torch.pipeline.ca3m import convertca3m
    for f in (GOLDEN / "ca3m").iterdir():
        shutil.copyfile(f, tmp_path / f.name)
    convertca3m(str(tmp_path / "ca3mdb"), str(tmp_path / "conv"))
    assert_db_equal(tmp_path / "conv", GOLDEN / "ca3m" / "convout")


@pytest.mark.parametrize("mode", [0, 1])
def test_result2msa_ca3m_matches_jax(dbs, tmp_path, mode):
    """result2msa --msa-format-mode 0 (compressed A3M, read back by
    convertca3m to the original alignments' coordinates) and 1 (with a
    consensus), through both packages' CLIs."""
    from metaeuk_tpu_torch.io.mmseqsdb import read_db
    chip_smoke.copy_db(GOLDEN / "ca3m" / "aln", tmp_path / "aln")
    files = {}
    for side, run in (("port", main), ("jax", jax_cli.main)):
        out = tmp_path / side
        assert run(["result2msa", str(dbs / "ldb"), str(dbs / "qdb"),
                    str(tmp_path / "aln"), str(out), "--msa-format-mode",
                    str(mode)]) == 0
        files[side] = [pathlib.Path(f"{out}{s}").read_bytes() for s in (
            "_ca3m.ffdata", "_ca3m.ffindex", "_sequence.ffdata",
            "_sequence.ffindex")]
    assert files["port"] == files["jax"]
    if mode == 0:
        assert main(["convertca3m", str(tmp_path / "port"),
                     str(tmp_path / "rt")]) == 0
        orig = dict(read_db(str(tmp_path / "aln")))
        rt = dict(read_db(str(tmp_path / "rt")))
        assert set(rt) == set(orig)
        for key, payload in orig.items():
            for o, r in zip(payload.decode().splitlines(),
                            rt[key].decode().splitlines()):
                assert r.split("\t")[4:11] == o.split("\t")[4:11]
    else:
        assert files["port"][0].startswith(b">consensus_")


def _dbtool3_case(name, d, fix):
    """argv of dbtools3 command `name` writing under d, and the golden
    files its outputs must equal ({output: golden})."""
    q, c, sr = str(fix / "qdb"), str(fix / "cdb"), str(UTILS / "selfres")
    db = {f"{d}/o{s}": UTILS / f"{{}}{s}" for s in DB_SUFFIXES}
    cases = {
        "result2repseq": (["result2repseq", q, sr, f"{d}/o"], "repseq", db),
        "masksequence_aa": (["masksequence", q, f"{d}/o"], "maskaa", db),
        "masksequence_nt": (["masksequence", c, f"{d}/o"], "masknt", db),
        "gff2db": (["gff2db", str(UTILS / "test.gff"), c, f"{d}/o"], "gffdb",
                   {f"{d}/o{s}": UTILS / f"{{}}{s}" for s in (
                       *DB_SUFFIXES, "_h", "_h.index", ".lookup",
                       ".source")}),
        "gff2db_cds": (["gff2db", str(UTILS / "test.gff"), c, f"{d}/o",
                        "--gff-type", "CDS"], "gffcds",
                       {f"{d}/o{s}": UTILS / f"{{}}{s}" for s in (
                           *DB_SUFFIXES, "_h", "_h.index", ".lookup",
                           ".source")}),
        "apply": (["apply", sr, f"{d}/o", "--", "head", "-n", "1"],
                  "applied",
                  {f"{d}/o{s}": UTILS / f"{{}}{s}" for s in ("", ".index")}),
        "diffseqdbs": (["diffseqdbs", q, str(fix / "ndb"), f"{d}/rm",
                        f"{d}/kept", f"{d}/new"], None,
                       {f"{d}/rm": UTILS / "d.removed",
                        f"{d}/kept": UTILS / "d.kept",
                        f"{d}/new": UTILS / "d.new"}),
    }
    for stat in ("linecount", "firstline", "mean", "sum", "max", "min"):
        cases[f"result2stats_{stat}"] = (
            ["result2stats", sr, f"{d}/o", "--stat", stat], f"st_{stat}",
            {f"{d}/o{s}": UTILS / f"{{}}{s}" for s in ("", ".index")})
    argv, tag, files = cases[name]
    return argv, {k: pathlib.Path(str(v).format(tag)) for k, v in
                  files.items()}


@pytest.mark.parametrize("name", [
    "result2repseq", "masksequence_aa", "masksequence_nt", "gff2db",
    "gff2db_cds", "apply", "diffseqdbs", "result2stats_linecount",
    "result2stats_firstline", "result2stats_mean", "result2stats_sum",
    "result2stats_max", "result2stats_min"])
def test_dbtools3_cli_matches_golden_and_jax_cli(dbs, tmp_path, name):
    """Each dbtools3 command of the port's CLI writes the reference's golden
    bytes, and the bytes the JAX CLI writes for the same arguments."""
    if not (dbs / "ndb.dbtype").exists():
        assert main(["createdb", str(UTILS / "diff_sub.faa"),
                     str(dbs / "ndb")]) == 0
    outs = {}
    for side, run in (("port", main), ("jax", jax_cli.main)):
        d = tmp_path / side
        d.mkdir()
        argv, files = _dbtool3_case(name, d, dbs)
        assert run(argv) == 0
        outs[side] = [pathlib.Path(f).read_bytes() for f in files]
        if side == "port":
            for mine, golden in files.items():
                assert pathlib.Path(mine).read_bytes() == \
                    golden.read_bytes(), mine
    assert outs["port"] == outs["jax"]


def test_maskbygff_matches_golden(tmp_path):
    """maskbygff on a string-keyed DB, through the port's CLI."""
    g = GOLDEN / "maskbygff"
    for suf in ("", ".index", ".dbtype", "_h", "_h.index", "_h.dbtype"):
        shutil.copy(g / f"strdb{suf}", tmp_path / f"strdb{suf}")
    assert main(["maskbygff", str(g / "test.gff"), str(tmp_path / "strdb"),
                 str(tmp_path / "masked"), "--gff-type", "gene"]) == 0
    for suf in ("", ".index", "_h", "_h.index"):
        assert (tmp_path / f"masked{suf}").read_bytes() == \
            (g / f"refmasked{suf}").read_bytes(), suf


def _cluster_case(name, d, fix):
    """argv of clustering command `name` writing under d, and the files it
    writes; fix holds the fixture DBs."""
    faa = str(CW / "clusterwf_input.faa")
    db = [f"{d}/out{s}" for s in DB_SUFFIXES]
    three = [f"{d}/out{f}" for f in chip_smoke.EASY_CLUSTER_FILES]
    return {
        "cluster": (["cluster", faa, f"{d}/out", f"{d}/tmp"], db),
        "cluster_90": (["cluster", faa, f"{d}/out", f"{d}/tmp",
                        "--min-seq-id", "0.9", "--cluster-steps", "2"], db),
        "easy-cluster": (["easy-cluster", faa, f"{d}/out", f"{d}/tmp",
                          "--min-seq-id", "0.5"], three),
        "easy-linclust": (["easy-linclust", faa, f"{d}/out", f"{d}/tmp"],
                          three),
        "linclust": (["linclust", str(KM / "kmF"), f"{d}/out", f"{d}/tmp",
                      "--min-seq-id", "0.5"], db),
        "pickconsensusrep": (["pickconsensusrep", str(fix / "alldb"),
                              str(U8 / "clu"), f"{d}/out", f"{d}/tmp"], db),
    }[name]


@pytest.mark.parametrize("name", ["cluster", "cluster_90", "easy-cluster",
                                  "easy-linclust", "linclust",
                                  "pickconsensusrep"])
def test_cluster_cli_matches_jax_cli(alldb, tmp_path, name):
    """Each aligning command of the family writes, through the port's CLI
    on the CPU, the bytes the JAX CLI writes for the same arguments."""
    outs = {}
    for side, run in (("jax", jax_cli.main), ("port", main)):
        d = tmp_path / side
        d.mkdir()
        (d / "tmp").mkdir()
        argv, files = _cluster_case(name, d, alldb.parent)
        assert run(argv + (CPU if side == "port" else [])) == 0
        outs[side] = [pathlib.Path(f).read_bytes() for f in files]
    assert outs["port"] == outs["jax"]
    assert all(outs["port"])


def test_linclust_module_matches_jax():
    """search/linclust.py (a copy, with the port's SW oracle ops/sw.py and
    the native banded traceback for true identities): the clusters, the
    selected k-mers and the candidate pairs equal the JAX package's."""
    from metaeuk_tpu.ops.sw import sw_align as jax_sw
    from metaeuk_tpu.search import linclust as jax_lc
    from metaeuk_tpu_torch.data.submat import encode_aa
    from metaeuk_tpu_torch.ops.sw import sw_align
    from metaeuk_tpu_torch.search import linclust
    # without the host library _real_identity falls back to the estimate
    assert native.get_lib() is not None
    rng = np.random.default_rng(7)
    aa = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)

    def mutate(s, rate):
        s = s.copy()
        i = rng.choice(len(s), int(len(s) * rate), replace=False)
        s[i] = aa[rng.integers(0, 20, len(i))]
        return s
    b1, b2 = aa[rng.integers(0, 20, 200)], aa[rng.integers(0, 20, 150)]
    seqs = [x.tobytes() for x in (b1, mutate(b1, 0.03), mutate(b1, 0.05),
                                  b2, mutate(b2, 0.04),
                                  aa[rng.integers(0, 20, 180)])]
    for thr in (0.9, 0.999):
        assert linclust.linclust(seqs, min_seq_id=thr) == \
            jax_lc.linclust(seqs, min_seq_id=thr)
    assert sorted(linclust.linclust(seqs)[0]) == [0, 1, 2]
    encs = [encode_aa(s) for s in seqs]
    np.testing.assert_array_equal(linclust.candidate_pairs(encs),
                                  jax_lc.candidate_pairs(encs))
    assert sw_align(encs[0], encs[1]) == jax_sw(encs[0], encs[1])


@pytest.mark.parametrize("argv", [
    ["cluster", "a", "b", "c"], ["easy-cluster", "a", "b", "c"],
    ["easy-linclust", "a", "b", "c"], ["linclust", "a", "b"],
    ["linsearch", "a", "b", "c"], ["easy-linsearch", "a", "b", "c", "d"],
    ["pickconsensusrep", "a", "b", "c", "d"],
    ["clusterupdate", "a", "b", "c", "d", "e", "f"]])
def test_aligning_cluster_commands_default_to_cuda(argv, monkeypatch):
    """The family's aligning commands take --device, default cuda, and
    raise without a card."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_chip_smoke_cluster_workflows_on_cpu(tmp_path):
    """chip_smoke.py's phase 4h, rehearsed on the CPU: every output of the
    family on the fixtures equal to its golden, the alignment through the
    plain versions, pickconsensusrep's through the uncapped PSSM
    instances'."""
    sw_cuda.reset_counts()
    n, pcr = chip_smoke.check_cluster_workflows(cli, "cpu", tmp_path)
    assert n == len(chip_smoke.CASCADE) + 2 + 6 \
        + len(chip_smoke.KMER_CASES) + 4 + 8 \
        + len(chip_smoke.RESULT2MSA_CASES) + 2 + 3
    assert not any(sw_cuda.LAUNCHES.values())
    assert sw_cuda.PLAIN_CALLS["sw_pair_ends"] > 0
    assert pcr["plain"]["sw_pair_ends_prof_nocap"] > 0
    assert pcr["plain"]["sw_pair_starts_prof_nocap"] > 0
    assert not any(pcr["launches"].values()) and not pcr["events"]
    assert pcr["cells"][0] > 0 and pcr["cells"][1] >= pcr["cells"][2] > 0


@contextlib.contextmanager
def _cpu_probe():
    """chip_smoke's probe_run on the CPU: the plain versions' calls stand in
    for launches, with no events."""
    sw_cuda.reset_counts()
    rec = {}
    yield rec
    rec["events"] = {}
    rec["launches"] = dict(sw_cuda.PLAIN_CALLS)
    rec["plain"] = dict.fromkeys(sw_cuda.KERNELS, 0)


def test_chip_smoke_cluster_slice_on_cpu_matches_jax(tmp_path):
    """chip_smoke.py's phase 5h on a small cluster slice (60 targets, copies
    of 6, 4 decoys; its cut: 3 families, 3 other targets and 2 decoys), on
    the CPU: the cut's three runs give the JAX package's counts and digests
    as make_cluster_slice.py takes them, and on the whole small slice
    every align step's hits and every output agree between the default
    routing and METAEUK_QM=off."""
    from metaeuk_tpu.io.mmseqsdb import read_db
    from metaeuk_tpu.pipeline.clusterwf import easy_cluster
    from metaeuk_tpu.search.searchdb import easy_linsearch
    cfg = dict(search=dict(mcs.CLUSTER_SLICE["search"], mbp=0.05,
                           targets=60, homolog_targets=6, decoys=4),
               cut=dict(family_targets=[0, 3], other_targets=[10, 13],
                        decoys=[0, 2]))
    (tmp_path / "port").mkdir()
    records, got = chip_smoke.check_cluster_slice(
        np, cli, tmp_path / "port", "cpu", _cpu_probe, cfg=cfg)
    td = tmp_path / "jax"
    td.mkdir()
    mcs.cluster_slice(cfg, td)
    for run, linclust in (("easy_cluster", False), ("easy_linclust", True)):
        tag = f"j_{run}"
        easy_cluster(str(td / "cut.faa"), str(td / tag),
                     str(td / f"{tag}_tmp"), use_linclust=linclust)
        assert got[run] == mcs.cluster_summary(td / tag, td / f"{tag}_tmp",
                                               linclust, read_db)
    easy_linsearch(str(td / "q_cut.faa"), str(td / "t_cut.faa"),
                   str(td / "ls.m8"), str(td / "ls"))
    assert got["easy_linsearch_cut"] == mcs.linsearch_summary(
        td / "ls.m8", td / "ls", read_db)
    assert got["easy_cluster"][0]["pref_step0"] > 0
    assert set(got) == {"easy_cluster", "easy_linclust",
                        "easy_linsearch_cut", "easy_cluster_full",
                        "easy_linclust_full", "easy_linsearch_full"}
    steps = [s for s, _, _ in records["easy_cluster QM auto"]["steps"]]
    assert steps.count("prefilter") == 3 and steps.count("align") == 3
    assert {"kmermatcher", "linclust", "clust", "mergeclusters",
            "result2repseq"} <= set(steps)


def test_cluster_slice_json_matches_its_input():
    """tests/golden/cluster_slice.json was made from CLUSTER_SLICE and holds
    every digest phase 5h compares."""
    golden = json.loads((GOLDEN / "cluster_slice.json").read_text())
    assert golden["input"] == json.loads(json.dumps(mcs.CLUSTER_SLICE))
    assert set(golden["sha256"]) == {
        "easy_cluster", "easy_linclust", "easy_linsearch_fixture",
        "easy_linsearch_cut", "easy_cluster_full", "easy_linclust_full",
        "easy_linsearch_full"}
    assert golden["counts"]["easy_cluster"]["clusters"] > 0


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("tool,tag", [("easy-cluster", "easycluster"),
                                      ("easy-linclust", "easylinclust")])
def test_easy_cluster_on_card_matches_golden(cuda_device, tmp_path, tool,
                                             tag):
    """Phase 4h's easy-cluster and easy-linclust: the CLI with --device
    cuda gives the goldens through K1/K2, with no plain version called."""
    import torch
    sw_cuda.reset_counts()
    assert main([tool, str(CW / "clusterwf_input.faa"), str(tmp_path / tag),
                 str(tmp_path / "tmp"), "--device", "cuda"]) == 0
    torch.cuda.synchronize()
    for f in chip_smoke.EASY_CLUSTER_FILES:
        assert pathlib.Path(f"{tmp_path / tag}{f}").read_bytes() == \
            (CW / f"{tag}{f}").read_bytes(), f
    assert min(sw_cuda.LAUNCHES[k] for k in chip_smoke.PAIR_KERNELS) > 0
    assert not any(sw_cuda.PLAIN_CALLS.values())
