"""The port's taxonomy against the goldens and the JAX package, on the CPU.

taxtocontig is held to the MetaEuk binary's TSVs (tests/golden/tax), as
tests/test_taxtocontig.py holds the JAX package; taxonomy, easy-taxonomy,
summarizealis and the taxonomy module's commands to the MMseqs2 goldens in
tests/golden/tax2, as tests/test_taxworkflow.py and tests/test_mmtax.py do
(chip_smoke.py's phase 4f, rehearsed here); each command of the port's CLI
also writes the bytes the JAX CLI writes for the same arguments. On the tax
slice's synthetic taxonomy (tests/golden/make_tax_slice.py), the port's
NcbiTaxonomy equals the JAX one, and taxtocontig on three homologs of
slice targets (110 aa each, against all 3,000 targets: about 3.2e8 cells
of exhaustive search) gives the JAX package's hit array and TSVs. The
aligning commands run with --device cpu (the kernels' plain versions).
Every comparison is exact equality.
"""

import pathlib
import shutil
import sys

import numpy as np
import pytest
import torch

from metaeuk_tpu import cli as jax_cli
from metaeuk_tpu.tax import workflow as jax_workflow
from metaeuk_tpu.tax.ncbi import NcbiTaxonomy as JaxTaxonomy
from metaeuk_tpu.tax.ncbi import WeightedTaxHit as JaxWeightedTaxHit
from metaeuk_tpu_torch import cli
from metaeuk_tpu_torch.ops import sw_cuda
from metaeuk_tpu_torch.tax.ncbi import NcbiTaxonomy, WeightedTaxHit

from test_mmtax import mask_node_padding
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests" / "golden"))
import chip_smoke  # noqa: E402
import make_search_slice as mss  # noqa: E402
import make_tax_slice as mts  # noqa: E402
DATA = ROOT / "tests" / "data"
GOLDEN = ROOT / "tests" / "golden"
TAX, TAX2 = GOLDEN / "tax", GOLDEN / "tax2"
DB_SUFFIXES = ("", ".index", ".dbtype")
ALIGNING = ("taxtocontig", "taxonomy", "easy-taxonomy")


@pytest.fixture(scope="module")
def ptax(tmp_path_factory):
    """The fixture proteins as a sequence DB with createtaxdb's attachments
    (tests/golden/tax2's taxdump and mapping), the queries' DB and the
    goldens' shared result, set and LCA DBs, by the port's CLI."""
    td = tmp_path_factory.mktemp("torch_tax")
    assert cli.main(["createdb", str(DATA / "proteins.faa"),
                     str(td / "ptax")]) == 0
    assert cli.main(["createtaxdb", str(td / "ptax"), str(td / "tmp"),
                     "--ncbi-tax-dump", str(TAX2 / "taxdump"),
                     "--tax-mapping-file", str(TAX2 / "accmap.tsv")]) == 0
    assert cli.main(["createdb", str(DATA / "queries_lin.faa"),
                     str(td / "qdb")]) == 0
    for name in ("res", "lca_default"):
        for s in DB_SUFFIXES:
            shutil.copyfile(TAX2 / f"{name}{s}", td / f"{name}{s}")
    from metaeuk_tpu_torch.io import mmseqsdb
    mmseqsdb.write_db(str(td / "sets"), [(100, b"10\n11\n"), (101, b"13\n")],
                      12)
    return td


def test_chip_smoke_tax_workflows_on_cpu(tmp_path):
    """chip_smoke.py's phase 4f (its taxonomy part), rehearsed on the CPU:
    taxtocontig equals the MetaEuk binary's TSVs, taxonomy and
    easy-taxonomy the MMseqs2 goldens, through the plain versions only."""
    sw_cuda.reset_counts()
    chip_smoke.check_tax_workflows(cli, "cpu", tmp_path)
    assert sw_cuda.PLAIN_CALLS["sw_pair_ends"] > 0
    assert sum(sw_cuda.LAUNCHES.values()) == 0


# golden DB in tests/golden/tax2: the port's CLI argv writing it, {td} the
# ptax fixture and {out} the output
GOLDEN_CASES = {
    "lca_default": ["lca", "{td}/ptax", "{td}/res", "{out}"],
    "lca_ranks": ["lca", "{td}/ptax", "{td}/res", "{out}", "--lca-ranks",
                  "species,genus,family,superkingdom"],
    "lca_lin2": ["lca", "{td}/ptax", "{td}/res", "{out}", "--tax-lineage",
                 "2"],
    "lca_nobl": ["lca", "{td}/ptax", "{td}/res", "{out}", "--blacklist", ""],
    "maj_v0": ["majoritylca", "{td}/ptax", "{td}/res", "{out}",
               "--vote-mode", "0"],
    "maj_thr": ["majoritylca", "{td}/ptax", "{td}/res", "{out}",
                "--majority", "0.9"],
    "aggtax": ["aggregatetax", "{td}/ptax", "{td}/sets", "{td}/lca_default",
               "{out}", "--lca-ranks", "genus,superkingdom"],
    "aggw": ["aggregatetaxweights", "{td}/ptax", "{td}/sets",
             "{td}/lca_default", "{td}/res", "{out}"],
    "addtax": ["addtaxonomy", "{td}/ptax", "{td}/res", "{out}"],
    "addtax_ranks": ["addtaxonomy", "{td}/ptax", "{td}/res", "{out}",
                     "--lca-ranks", "species,phylum", "--tax-lineage", "1"],
    "ftd_expr": ["filtertaxdb", "{td}/ptax", "{td}/lca_default", "{out}",
                 "--taxon-list", "2||562"],
    "ftsq_hard": ["filtertaxseqdb", "{td}/ptax", "{out}", "--taxon-list",
                  "2759"],
    "sumali": ["summarizealis", "{td}/res", "{out}"],
}


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_tax_commands_match_goldens(ptax, tmp_path, name):
    out = tmp_path / name
    argv = [a.format(td=ptax, out=out) for a in GOLDEN_CASES[name]]
    assert cli.main(argv) == 0
    for s in DB_SUFFIXES:
        assert pathlib.Path(f"{out}{s}").read_bytes() == \
            (TAX2 / f"{name}{s}").read_bytes(), s


def test_taxonomy_files_match_goldens(ptax, tmp_path):
    """createtaxdb's attachments, createbintaxonomy, createbintaxmapping,
    createdmptaxonomy and taxonomyreport against the MMseqs2 goldens."""
    assert (ptax / "ptax_mapping").read_bytes() == \
        (TAX2 / "ptax_mapping").read_bytes()
    assert mask_node_padding((ptax / "ptax_taxonomy").read_bytes()) == \
        mask_node_padding((TAX2 / "ptax_taxonomy").read_bytes())
    dump = TAX2 / "taxdump"
    assert cli.main(["createbintaxonomy", str(dump / "names.dmp"),
                     str(dump / "nodes.dmp"), str(dump / "merged.dmp"),
                     str(tmp_path / "tax.bin")]) == 0
    assert mask_node_padding((tmp_path / "tax.bin").read_bytes()) == \
        mask_node_padding((TAX2 / "taxonomy.bin").read_bytes())
    assert cli.main(["createbintaxmapping", str(ptax / "ptax_mapping"),
                     str(tmp_path / "mapping.bin")]) == 0
    assert (tmp_path / "mapping.bin").read_bytes() == \
        (TAX2 / "mapping.bin").read_bytes()
    assert cli.main(["createdmptaxonomy", str(ptax / "ptax"),
                     str(tmp_path / "dmpout")]) == 0
    for s in ("_nodes.dmp", "_names.dmp", "_merged.dmp"):
        assert (tmp_path / f"dmpout{s}").read_bytes() == \
            (TAX2 / f"dmpout{s}").read_bytes(), s
    assert cli.main(["taxonomyreport", str(ptax / "ptax"),
                     str(ptax / "lca_default"),
                     str(tmp_path / "report")]) == 0
    assert (tmp_path / "report").read_bytes() == \
        (TAX2 / "report_kraken").read_bytes()


def _cli_case(name, d, fix):
    """argv of command `name` (without --device) writing under d, and the
    files it writes; fix holds the ptax fixture."""
    dump = TAX / "taxdump"
    ttc = ["taxtocontig", str(GOLDEN / "easypredict.fas"),
           str(GOLDEN / "easypredict.headersMap.tsv"),
           str(DATA / "proteins.faa"), str(TAX / "tax_mapping.tsv"),
           str(dump / "names.dmp"), str(dump / "nodes.dmp"), f"{d}/tc",
           "--merged-dmp", str(dump / "merged.dmp")]
    tsvs = [f"{d}/tc_tax_per_pred.tsv", f"{d}/tc_tax_per_contig.tsv"]
    db = [f"{d}/out{s}" for s in DB_SUFFIXES]
    qdb, ptax = str(fix / "qdb"), str(fix / "ptax")
    return {
        "taxtocontig": (ttc + ["--contigs", str(DATA / "contigs.fna")],
                        tsvs),
        "taxtocontig_tophit": (ttc + ["--lca-mode", "top-hit"], tsvs),
        "taxtocontig_lca": (ttc + ["--lca-mode", "lca", "-e", "100",
                                   "--vote-mode", "0"], tsvs),
        "taxonomy": (["taxonomy", qdb, ptax, f"{d}/out", f"{d}/tmp"],
                     db + [f"{d}/tmp/first{s}" for s in DB_SUFFIXES]),
        "taxonomy_tophit": (["taxonomy", qdb, ptax, f"{d}/out", f"{d}/tmp",
                             "--lca-mode", "4", "--tax-output-mode", "2"],
                            db + [f"{d}/out_aln{s}" for s in DB_SUFFIXES]),
        "easy-taxonomy": (["easy-taxonomy", str(DATA / "queries_lin.faa"),
                           ptax, f"{d}/et", f"{d}/tmp", "--lca-ranks",
                           "genus"],
                          [f"{d}/et{s}" for s in ("_lca.tsv", "_report",
                                                  "_tophit_report",
                                                  "_tophit_aln")]),
        "lca": (["lca", ptax, str(fix / "res"), f"{d}/out", "--tax-lineage",
                 "1"], db),
        "taxonomyreport_krona": (["taxonomyreport", ptax,
                                  str(fix / "lca_default"), f"{d}/kr",
                                  "--report-mode", "1"], [f"{d}/kr"]),
        "filtertaxseqdb_soft": (["filtertaxseqdb", ptax, f"{d}/out",
                                 "--taxon-list", "2759", "--subdb-mode",
                                 "1"], [f"{d}/out.index"]),
    }[name]


@pytest.mark.parametrize("name", [
    "taxtocontig", "taxtocontig_tophit", "taxtocontig_lca", "taxonomy",
    "taxonomy_tophit", "easy-taxonomy", "lca", "taxonomyreport_krona",
    "filtertaxseqdb_soft"])
def test_cli_matches_jax_cli(ptax, tmp_path, name):
    """Each taxonomy command of the port's CLI writes the bytes the JAX CLI
    writes for the same arguments."""
    outs = {}
    for side, main in (("jax", jax_cli.main), ("port", cli.main)):
        d = tmp_path / side
        d.mkdir()
        argv, files = _cli_case(name, d, ptax)
        if side == "port" and argv[0] in ALIGNING:
            argv = argv + ["--device", "cpu"]
        assert main(argv) == 0
        outs[side] = [pathlib.Path(f).read_bytes() for f in files]
    assert outs["port"] == outs["jax"]
    assert any(outs["port"])


@pytest.mark.parametrize("name", ["taxtocontig", "taxonomy",
                                  "easy-taxonomy"])
def test_aligning_commands_default_to_cuda(ptax, tmp_path, monkeypatch,
                                           name):
    """Without --device the command asks for a CUDA device, and raises
    where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv, _ = _cli_case(name, tmp_path, ptax)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


@pytest.fixture(scope="module")
def tax_slice(tmp_path_factory):
    """The tax slice's files (make_tax_slice.tax_slice)."""
    td = tmp_path_factory.mktemp("tax_slice")
    return mts.tax_slice(mts.TAX_SLICE, td)


def test_slice_taxonomy_matches_jax(tax_slice):
    """NcbiTaxonomy from the slice's dumps: parents, ranks, names, merged
    ids, lca, lineages and weighted-majority votes equal the JAX
    package's, on 300 random sets of taxa."""
    args = (tax_slice["names"], tax_slice["nodes"], tax_slice["merged"])
    port, ref = NcbiTaxonomy.from_dumps(*args), JaxTaxonomy.from_dumps(*args)
    assert (port.parent, port.rank, port.name, port.merged) == \
        (ref.parent, ref.rank, ref.name, ref.merged)
    assert sum(r == "species" for r in port.rank.values()) > 250
    assert len(port.merged) == 30
    rng = np.random.default_rng(0)
    ids = np.array(sorted(port.parent) + sorted(port.merged) + [0, 77])
    for _ in range(300):
        taxa = [int(t) for t in rng.choice(ids, int(rng.integers(1, 6)))]
        assert port.lca(taxa) == ref.lca(taxa), taxa
        assert port.tax_lineage(taxa[0]) == ref.tax_lineage(taxa[0])
        evalues = rng.choice([0.0, 1e-40, 1e-5, 0.3], len(taxa))
        got = port.weighted_majority_lca(
            [WeightedTaxHit(t, e, 1) for t, e in zip(taxa, evalues)], 0.5)
        want = ref.weighted_majority_lca(
            [JaxWeightedTaxHit(t, e, 1) for t, e in zip(taxa, evalues)], 0.5)
        assert vars(got) == vars(want), taxa


def _probe_predictions(paths, td):
    """Three homologs (80% identity) of the first 110 residues of implanted
    slice targets, as a predictions FASTA and headersMap: a homolog-family
    source (its family member sits in the same genus), a target whose taxid
    merged.dmp redirects, and a blacklisted target; the first two on
    contig 0, the third on contig 1."""
    from tools.make_metagenome import AA, make_metagenome
    cfg = mts.TAX_SLICE
    _, prots = make_metagenome(cfg["mbp"], cfg["targets"], cfg["seed"])
    taxid = {n: int(t) for n, t in (ln.split() for ln in
                                    open(paths["mapping"]))}
    implanted = range(int(cfg["targets"] * 0.3))
    picks = [mts.family_sources(prots, len(implanted), 1)[0],
             next(i for i in implanted if mts.MERGED_FROM
                  <= taxid.get(prots[i][0], 0) < mts.UNCLASSIFIED_IDS),
             next(i for i in implanted
                  if taxid.get(prots[i][0], 0) >= mts.UNCLASSIFIED_IDS)]
    lut = np.zeros(256, np.int64)
    lut[AA] = np.arange(20)
    rng = np.random.default_rng(cfg["tax_seed"])
    with open(td / "probe.fas", "wb") as fas, \
            open(td / "probe.headersMap.tsv", "w") as hm:
        for k, i in enumerate(picks):
            codes = lut[np.frombuffer(prots[i][1][:110], np.uint8)]
            q = AA[mss.mutate(rng, codes, 0.8, 0.0, 1)].tobytes()
            fas.write(b">%s|probe%d\n%s\n" % (prots[i][0].encode(), k, q))
            hm.write(f"{int(k == 2)}\t{prots[i][0]}|probe{k}\n")
    return td / "probe"


def test_chip_smoke_taxtocontig_on_slice_probe_matches_jax(tax_slice,
                                                          tmp_path):
    """chip_smoke.py's taxtocontig run of phase 5f on three probe
    predictions against the slice's 3,000 targets and taxonomy, on the CPU:
    the port's hit array (exhaustive search) equals the JAX driver's field
    by field, and both TSVs the JAX CLI's byte for byte."""
    preds = _probe_predictions(tax_slice, tmp_path)
    args = mts.taxtocontig_args(mts.TAX_SLICE, tax_slice, preds,
                                tmp_path / "port", tax_slice["cut"])
    run = chip_smoke.run_taxtocontig(cli, args, "cpu")
    jax_hits = []
    search = jax_workflow.SearchDriver.search

    def kept(self, *a, **kw):
        jax_hits.append(search(self, *a, **kw))
        return jax_hits[-1]
    jax_workflow.SearchDriver.search = kept
    try:
        assert jax_cli.main(mts.taxtocontig_args(
            mts.TAX_SLICE, tax_slice, preds, tmp_path / "jax",
            tax_slice["cut"])) == 0
    finally:
        jax_workflow.SearchDriver.search = search
    ref, got = jax_hits[0], run["hits"]
    assert len(got) == len(ref) >= 3
    for f in ref.dtype.names:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    assert mts.tsv_digests(tmp_path / "port") == \
        mts.tsv_digests(tmp_path / "jax")
    assert run["pairs"] == 3 * mts.TAX_SLICE["targets"]
    assert set(run["stages"]) == {"load", "search", "per_query", "io"}
    assert run["routes"]["pair"]["fwd"][0] == run["pairs"]
    assert len((tmp_path / "port_tax_per_pred.tsv").read_text()
               .splitlines()) == 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_taxtocontig_on_card(cuda_device, tmp_path):
    """Phase 4f's taxtocontig on the card: the MetaEuk binary's TSVs,
    through K1/K2 with no plain version called."""
    dump = TAX / "taxdump"
    sw_cuda.reset_counts()
    assert cli.main(["taxtocontig", str(GOLDEN / "easypredict.fas"),
                     str(GOLDEN / "easypredict.headersMap.tsv"),
                     str(DATA / "proteins.faa"), str(TAX / "tax_mapping.tsv"),
                     str(dump / "names.dmp"), str(dump / "nodes.dmp"),
                     str(tmp_path / "reftax"), "--merged-dmp",
                     str(dump / "merged.dmp"), "--contigs",
                     str(DATA / "contigs.fna"), "--device", "cuda"]) == 0
    for s in ("tax_per_pred", "tax_per_contig"):
        assert pathlib.Path(f"{tmp_path / 'reftax'}_{s}.tsv").read_bytes() \
            == (TAX / f"reftax_{s}.tsv").read_bytes(), s
    assert sw_cuda.LAUNCHES["sw_pair_ends"] > 0
    assert sum(sw_cuda.PLAIN_CALLS.values()) == 0
