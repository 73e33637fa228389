"""metaeuk_tpu_torch imports neither jax nor metaeuk_tpu: the machine with the
GPU has no jax, and the port keeps its own copy of every host module."""

import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).parent.parent
PKG = ROOT / "metaeuk_tpu_torch"
# an import of the JAX package or of one of its modules (not of the port)
JAX_PACKAGE_IMPORT = re.compile(
    r"^\s*(from\s+metaeuk_tpu(\.\S+)?\s+import|import\s+metaeuk_tpu(\.|\s|$))",
    re.M)

_BLOCK = r"""
import hashlib, json, sys
# an interpreter may import jax at start-up: drop it, then block it and the
# JAX package
for name in [k for k in sys.modules
             if k.split(".")[0].startswith("jax")
             or k.split(".")[0] == "metaeuk_tpu"]:
    del sys.modules[name]
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["metaeuk_tpu"] = None
"""

_BLOCKED_RUN = _BLOCK + r"""

import metaeuk_tpu_torch.cli
import metaeuk_tpu_torch.pipeline.predict
from metaeuk_tpu_torch.params import Params
from metaeuk_tpu_torch.pipeline.predict import EasyPredict

data, golden, out, mode = sys.argv[1:5]
EasyPredict(Params(prefilter_mode=mode), device="cpu").run(
    f"{data}/contigs.fna", f"{data}/proteins.faa", out)
suffixes = ("fas", "codon.fas", "headersMap.tsv", "gff")
if mode == "kmer":
    for s in suffixes:
        with open(f"{out}.{s}", "rb") as a, \
                open(f"{golden}/easypredict.{s}", "rb") as b:
            assert a.read() == b.read(), s
else:
    with open(f"{golden}/ungapped_slice.json") as f:
        want = json.load(f)["fixture"]["sha256"]
    for s in suffixes:
        with open(f"{out}.{s}", "rb") as a:
            assert hashlib.sha256(a.read()).hexdigest() == want[s], s
loaded = [k for k, v in sys.modules.items() if v is not None and (
    k.split(".")[0].startswith("jax") or k.split(".")[0] == "metaeuk_tpu")]
assert not loaded, loaded
print("jax-free run ok")
"""

# chip_smoke.py's long-frame phases import the generator of
# tests/golden/make_long_slice.py (whose golden writer alone imports jax)
_BLOCKED_LONG_SLICE = _BLOCK + r"""
sys.path.insert(0, "tests/golden")
import make_long_slice as mls
from metaeuk_tpu_torch.ops.orf import OrfExtractor
from metaeuk_tpu_torch.params import Params

contigs, _ = mls.long_slice(mls.GOLDEN_INPUT)
ex = OrfExtractor(Params())
long_frames = []
for name, seq in contigs:
    _, frags = ex.extract_contig(seq, 0)
    long_frames += [len(a) for a in ex.translate_fragments(frags)
                    if len(a) > 4096]
assert sorted(long_frames) == mls.GOLDEN_INPUT["frame_lengths"], long_frames
loaded = [k for k in sys.modules if sys.modules[k] is not None and (
    k.split(".")[0].startswith("jax") or k.split(".")[0] == "metaeuk_tpu")]
assert not loaded, loaded
print("jax-free run ok")
"""

# chip_smoke.py's profile phases import the profile-slice writer of
# tests/golden/make_profile_slice.py (whose golden writer alone imports jax);
# the port's easy-predict against the fixture's HMM-profile DB
_BLOCKED_PROFILE = _BLOCK + r"""
sys.path.insert(0, "tests/golden")
import make_profile_slice as mps
from metaeuk_tpu_torch.io.profiledb import ProfileDB
from metaeuk_tpu_torch.params import Params
from metaeuk_tpu_torch.pipeline.predict import EasyPredict

data, golden, out, mode = sys.argv[1:5]
mps.write_profile_db([("p0 one", b"MKVLAW"), ("p1", b"GGCY")],
                     out + "_db", 1)
db = ProfileDB.from_db(out + "_db")
assert [len(x) for x in db.pssms] == [6, 4] and db.accession(0) == "p0"
EasyPredict(Params(), device="cpu").run(
    f"{data}/contigs.fna", f"{golden}/profile/profileDB", out)
for s in ("fas", "codon.fas", "headersMap.tsv", "gff"):
    with open(f"{out}.{s}", "rb") as a, \
            open(f"{golden}/profile/pp.{s}", "rb") as b:
        assert a.read() == b.read(), s
loaded = [k for k in sys.modules if sys.modules[k] is not None and (
    k.split(".")[0].startswith("jax") or k.split(".")[0] == "metaeuk_tpu")]
assert not loaded, loaded
print("jax-free run ok")
"""

# chip_smoke.py's search phases import the search-slice writer of
# tests/golden/make_search_slice.py (whose golden writer alone imports jax);
# the port's easy-search and align --realign on the fixture
_BLOCKED_SEARCH = _BLOCK + r"""
sys.path.insert(0, "tests/golden")
import make_search_slice as mss
from metaeuk_tpu_torch.cli import main

data, golden, out, mode = sys.argv[1:5]
cfg = dict(mss.SEARCH_SLICE, homolog_targets=4, decoys=2)
queries = mss.search_queries(cfg, [("p", b"ACDEFGHIKLMNPQRSTVWY" * 5)] * 4)
assert len(queries) == 14 and queries[0][0] == "q0_t0_90", queries[0]
assert main(["easy-search", f"{data}/queries_lin.faa",
             f"{data}/proteins.faa", out + ".m8", out + "_tmp",
             "--device", "cpu"]) == 0
with open(out + ".m8", "rb") as a, \
        open(f"{golden}/searchwf/easysearch.m8", "rb") as b:
    assert a.read() == b.read()
assert main(["align", out + "_tmp/query", out + "_tmp/target",
             out + "_tmp/search_tmp/pref_0", out + "_re", "-a", "--realign",
             "--device", "cpu"]) == 0
loaded = [k for k in sys.modules if sys.modules[k] is not None and (
    k.split(".")[0].startswith("jax") or k.split(".")[0] == "metaeuk_tpu")]
assert not loaded, loaded
print("jax-free run ok")
"""


# MetaEuk's modular chain and taxtocontig through the port's CLI on the
# fixture; chip_smoke.py's phase 5f imports the tax-slice writer of
# tests/golden/make_tax_slice.py (whose golden writer alone imports jax)
_BLOCKED_MODULAR = _BLOCK + r"""
sys.path.insert(0, "tests/golden")
import make_tax_slice as mts
from metaeuk_tpu_torch.cli import main

data, golden, out, mode = sys.argv[1:5]
dev = ["--device", "cpu"]
c, t = f"{data}/contigs.fna", f"{data}/proteins.faa"
assert main(["predictexons", c, t, out + "_dp", *dev]) == 0
assert main(["reduceredundancy", out + "_dp", out + "_red",
             out + "_clust"]) == 0
assert main(["unitesetstofasta", c, t, out + "_red", out, *dev]) == 0
for s in ("fas", "codon.fas", "headersMap.tsv", "gff"):
    with open(f"{out}.{s}", "rb") as a, \
            open(f"{golden}/easypredict.{s}", "rb") as b:
        assert a.read() == b.read(), s
tax = f"{golden}/tax"
assert main(["taxtocontig", out + ".fas", out + ".headersMap.tsv", t,
             f"{tax}/tax_mapping.tsv", f"{tax}/taxdump/names.dmp",
             f"{tax}/taxdump/nodes.dmp", out + "_tax", "--contigs", c,
             *dev]) == 0
for s in ("tax_per_pred", "tax_per_contig"):
    with open(f"{out}_tax_{s}.tsv", "rb") as a, \
            open(f"{tax}/reftax_{s}.tsv", "rb") as b:
        assert a.read() == b.read(), s
nodes, mapping, merged = mts.target_taxa(
    mts.TAX_SLICE, [(f"prot{i}", b"ACDEFGHIKL" * (i % 7 + 2))
                    for i in range(100)])
assert len(mapping) == 98 and len(merged) == 1 and 1 in nodes
loaded = [k for k in sys.modules if sys.modules[k] is not None and (
    k.split(".")[0].startswith("jax") or k.split(".")[0] == "metaeuk_tpu")]
assert not loaded, loaded
print("jax-free run ok")
"""

# search --num-iterations 2 through the port's CLI on the fixture (the
# reference's golden); chip_smoke.py's phase 5g imports the iterative
# slice's writer, tests/golden/make_iter_slice.py (whose golden writer alone
# imports jax)
_BLOCKED_ITERATIVE = _BLOCK + r"""
sys.path.insert(0, "tests/golden")
import make_iter_slice as mis
from metaeuk_tpu_torch.cli import main

data, golden, out, mode = sys.argv[1:5]
assert main(["createdb", f"{data}/proteins.faa", out + "_db"]) == 0
assert main(["search", out + "_db", out + "_db", out, out + "_tmp",
             "--num-iterations", "2", "-a", "--device", "cpu"]) == 0
for s in ("", ".index", ".dbtype"):
    with open(out + s, "rb") as a, open(f"{golden}/pref/iter2{s}", "rb") as b:
        assert a.read() == b.read(), s
args = mis.search_args(mis.ITER_SLICE, "q", "t", "o", "tmp")
assert args[:5] == ["search", "q", "t", "o", "tmp"] and "-a" in args
assert sorted(mis.step_dbs(mis.ITER_SLICE, "o", "tmp")) == [
    "aln_0", "aln_1", "aln_2", "pref_0", "pref_1", "pref_2", "profile_0",
    "profile_1", "result"]
loaded = [k for k in sys.modules if sys.modules[k] is not None and (
    k.split(".")[0].startswith("jax") or k.split(".")[0] == "metaeuk_tpu")]
assert not loaded, loaded
print("jax-free run ok")
"""

# every module of the clustering and linear-search family; easy-cluster,
# easy-linclust and easy-linsearch through the port's CLI on the fixtures
# (the reference's goldens, the JAX package's digests in cluster_slice.json);
# chip_smoke.py's phase 5h imports the cluster slice's writer,
# tests/golden/make_cluster_slice.py (whose golden writer alone imports jax)
_BLOCKED_CLUSTER = _BLOCK + r"""
import importlib
import pathlib
for m in ("pipeline.clust", "pipeline.cluster", "pipeline.clusterwf",
          "pipeline.dbtools3", "pipeline.result2msa", "pipeline.ca3m",
          "data.nucl", "ops.sw", "search.kmermatcher", "search.linclust",
          "search.linsearch_lin"):
    importlib.import_module(f"metaeuk_tpu_torch.{m}")
sys.path.insert(0, "tests/golden")
import make_cluster_slice as mcs
from metaeuk_tpu_torch.cli import main
from metaeuk_tpu_torch.io.mmseqsdb import read_db

data, golden, out, mode = sys.argv[1:5]
cw = f"{golden}/clusterwf"
for tool, tag in (("easy-cluster", "easycluster"),
                  ("easy-linclust", "easylinclust")):
    assert main([tool, f"{cw}/clusterwf_input.faa", out + tag,
                 out + tag + "_tmp", "--device", "cpu"]) == 0
    for f in ("_cluster.tsv", "_rep_seq.fasta", "_all_seqs.fasta"):
        with open(out + tag + f, "rb") as a, open(f"{cw}/{tag}{f}", "rb") as b:
            assert a.read() == b.read(), f
assert main(["easy-linsearch", f"{data}/queries_lin.faa",
             f"{data}/proteins.faa", out + ".m8", out + "_ls",
             "--device", "cpu"]) == 0
with open(f"{golden}/cluster_slice.json") as f:
    want = json.load(f)
got = mcs.linsearch_summary(out + ".m8", out + "_ls", read_db)
assert list(got) == [want["counts"]["easy_linsearch_fixture"],
                     want["sha256"]["easy_linsearch_fixture"]]
paths = mcs.cluster_slice(mcs.CLUSTER_SLICE, pathlib.Path(out).parent)
assert sum(1 for ln in open(paths["cut"]) if ln.startswith(">")) == 1200
loaded = [k for k in sys.modules if sys.modules[k] is not None and (
    k.split(".")[0].startswith("jax") or k.split(".")[0] == "metaeuk_tpu")]
assert not loaded, loaded
print("jax-free run ok")
"""

# the multihit family, the DB utilities and the resident server: every new
# module imports; multihitdb and multihitsearch through the port's CLI on
# tests/golden/util7 give its goldens; the server answers a ping and a search;
# chip_smoke.py's phase 5i imports the multihit slice's writer,
# tests/golden/make_multihit_slice.py (whose golden writer alone imports jax)
_BLOCKED_MULTIHIT = _BLOCK + r"""
import importlib
import os
import threading
import time
for m in ("pipeline.dbtools5", "pipeline.multihit", "pipeline.multihit_wf",
          "server"):
    importlib.import_module(f"metaeuk_tpu_torch.{m}")
sys.path.insert(0, "tests/golden")
import make_multihit_slice as mms
from metaeuk_tpu_torch.cli import main
from metaeuk_tpu_torch.server import TpuSearchServer, client_request

data, golden, out, mode = sys.argv[1:5]
u7 = f"{golden}/util7"
assert main(["multihitdb", f"{u7}/set0.fna", f"{u7}/set1.fna", out + "_mh",
             out + "_mhtmp"]) == 0
assert main(["multihitsearch", out + "_mh", out + "_mh", out + "_mhres",
             out + "_mhstmp", "--device", "cpu"]) == 0
for mine, ref in (("_mh_set_to_member", "mhdb_set_to_member"),
                  ("_mhres", "mhres"), ("_mhstmp/aggregate", "mh_aggregate")):
    for s in ("", ".index", ".dbtype"):
        with open(out + mine + s, "rb") as a, \
                open(f"{u7}/{ref}{s}", "rb") as b:
            assert a.read() == b.read(), mine + s
sock = out + ".sock"
srv = TpuSearchServer(out + "_mh", sock, device="cpu")
threading.Thread(target=srv.serve_forever, daemon=True).start()
while not os.path.exists(sock):
    time.sleep(0.05)
assert client_request(sock, {"op": "ping"})["ok"]
assert client_request(sock, {"op": "search", "query_db": out + "_mh",
                             "out_db": out + "_srv"})["ok"]
assert client_request(sock, {"op": "shutdown"})["ok"]
paths = mms.multihit_slice(mms.MULTIHIT_SLICE,
                           os.path.dirname(out), 1)
assert len(paths) == 1 and paths[0].name == "set00.fna"
loaded = [k for k in sys.modules if sys.modules[k] is not None and (
    k.split(".")[0].startswith("jax") or k.split(".")[0] == "metaeuk_tpu")]
assert not loaded, loaded
print("jax-free run ok")
"""

# the port's microbenchmarks and its bench: their entry points on the CPU
# (the bench at 0.01 Mbp, then its selftest on one small tile and batch),
# jax blocked
_BLOCKED_TOOLS = _BLOCK + r"""
import os
import tempfile
import metaeuk_tpu_torch.ops.kbench_cuda
import metaeuk_tpu_torch.ops.kbench_torch
import metaeuk_tpu_torch.ops.qm_variants_cuda
import metaeuk_tpu_torch.ops.qm_variants_torch
from metaeuk_tpu_torch.tools import bench, kbench, kernel_variants

res = kbench.main(["--device", "cpu", "alu_i32"])
assert int(res["alu_i32"][2].min()) == 512 * 4
res = kernel_variants.main(["--device", "cpu", "--lq", "32", "--lt", "64",
                            "--tiles", "1", "base"])
assert int(res["base"][1][0]) > 0
data, golden, out, mode = sys.argv[1:5]
tempfile.tempdir = os.path.dirname(out)
os.environ.update(METAEUK_BENCH_MBP="0.01", METAEUK_BENCH_TARGETS="300",
                  METAEUK_BENCH_RUNS="1")
assert bench.main(["--device", "cpu", "--no-ref", "--no-selftest"]) == 0
bench.QM_CONFIGS, bench.PAIR_CONFIGS = ((64, 96, 1),), ((64, 96, 4),)
assert bench.main(["--selftest", "--device", "cpu"]) == 0
loaded = [k for k in sys.modules if sys.modules[k] is not None and (
    k.split(".")[0].startswith("jax") or k.split(".")[0] in (
        "metaeuk_tpu", "tools"))]
assert not loaded, loaded
print("jax-free run ok")
"""

# an import of the repository's tools/ package, whose modules import jax
TOOLS_IMPORT = re.compile(
    r"^\s*(from\s+tools(\.|\s)|import\s+tools(\.|\s|$))", re.M)


def _sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    return files


def test_no_jax_import_in_port_sources():
    for f in _sources():
        text = f.read_text()
        assert "import jax" not in text and "from jax" not in text, f


def test_no_jax_package_import_in_port_sources():
    for f in _sources():
        hit = JAX_PACKAGE_IMPORT.search(f.read_text())
        assert hit is None, (f, hit and hit.group(0))


def test_no_repo_tools_import_in_port_package():
    for f in sorted(PKG.rglob("*.py")):
        hit = TOOLS_IMPORT.search(f.read_text())
        assert hit is None, (f, hit and hit.group(0))
    assert TOOLS_IMPORT.search("from tools import kbench")
    assert not TOOLS_IMPORT.search("from .tools import kbench")
    assert not TOOLS_IMPORT.search("from metaeuk_tpu_torch.tools import x")


def test_import_pattern_catches_the_jax_package_only():
    for line in ("from metaeuk_tpu.io.seqdb import SeqDB",
                 "    from metaeuk_tpu import native",
                 "import metaeuk_tpu.search.driver as d", "import metaeuk_tpu"):
        assert JAX_PACKAGE_IMPORT.search(line), line
    for line in ("from metaeuk_tpu_torch.ops import sw_cuda",
                 "import metaeuk_tpu_torch.cli", "from .io import seqdb",
                 "# copied from metaeuk_tpu/search/driver.py"):
        assert not JAX_PACKAGE_IMPORT.search(line), line


def _blocked_run(tmp_path, mode, code=_BLOCKED_RUN):
    res = subprocess.run(
        [sys.executable, "-c", code, str(ROOT / "tests" / "data"),
         str(ROOT / "tests" / "golden"), str(tmp_path / "preds"), mode],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "jax-free run ok" in res.stdout


def test_port_runs_with_jax_blocked(tmp_path):
    """The k-mer fixture run with jax and metaeuk_tpu blocked."""
    _blocked_run(tmp_path, "kmer")


def test_ungapped_port_runs_with_jax_blocked(tmp_path):
    """The ungapped fixture run with jax and metaeuk_tpu blocked."""
    _blocked_run(tmp_path, "ungapped")


def test_long_slice_generator_runs_with_jax_blocked(tmp_path):
    """The long-frame generator that chip_smoke.py imports plants, with jax
    and metaeuk_tpu blocked, one open frame of each asked length."""
    _blocked_run(tmp_path, "kmer", _BLOCKED_LONG_SLICE)


def test_profile_path_runs_with_jax_blocked(tmp_path):
    """The profile-slice writer that chip_smoke.py imports writes a profile
    DB, and easy-predict against the fixture's HMM-profile DB gives the
    goldens, with jax and metaeuk_tpu blocked."""
    _blocked_run(tmp_path, "kmer", _BLOCKED_PROFILE)


def test_microbenchmark_entry_points_run_with_jax_blocked(tmp_path):
    """The six modules of T1-T4 import, and `kbench --device cpu alu_i32`,
    `kernel_variants --device cpu base`, the bench's main run (at 0.01 Mbp)
    and its selftest (one small tile and batch) run, with jax, metaeuk_tpu
    and the repository's tools/ blocked."""
    _blocked_run(tmp_path, "kmer", _BLOCKED_TOOLS.replace(
        'sys.modules["metaeuk_tpu"] = None',
        'sys.modules["metaeuk_tpu"] = None\nsys.modules["tools"] = None'))


def test_search_workflows_run_with_jax_blocked(tmp_path):
    """The search-slice generator that chip_smoke.py imports makes queries,
    and the port's easy-search (equal to the reference's BLAST-tab golden)
    and align --realign run, with jax and metaeuk_tpu blocked."""
    _blocked_run(tmp_path, "kmer", _BLOCKED_SEARCH)


def test_modular_chain_and_taxtocontig_run_with_jax_blocked(tmp_path):
    """predictexons -> reduceredundancy -> unitesetstofasta and taxtocontig
    through the port's CLI give the MetaEuk binary's goldens, and the
    tax-slice writer that chip_smoke.py imports assigns taxa, with jax and
    metaeuk_tpu blocked."""
    _blocked_run(tmp_path, "kmer", _BLOCKED_MODULAR)


def test_iterative_search_runs_with_jax_blocked(tmp_path):
    """search --num-iterations 2 through the port's CLI gives the
    reference's golden, and the iterative slice's writer that chip_smoke.py
    imports names the slice's DBs, with jax and metaeuk_tpu blocked."""
    _blocked_run(tmp_path, "kmer", _BLOCKED_ITERATIVE)


def test_cluster_family_runs_with_jax_blocked(tmp_path):
    """Every module of the clustering and linear-search family imports, and
    easy-cluster, easy-linclust and easy-linsearch through the port's CLI
    give the goldens, and the cluster slice's writer that chip_smoke.py
    imports writes the slice, with jax and metaeuk_tpu blocked."""
    _blocked_run(tmp_path, "kmer", _BLOCKED_CLUSTER)


def test_multihit_family_and_server_run_with_jax_blocked(tmp_path):
    """Every module of the multihit family and the server imports;
    multihitdb and multihitsearch through the port's CLI give util7's
    goldens, the server answers ping and search, and the multihit slice's
    writer that chip_smoke.py imports writes a set file, with jax and
    metaeuk_tpu blocked."""
    _blocked_run(tmp_path, "kmer", _BLOCKED_MULTIHIT)


# the M11b modules and the runtime Gumbel fit: every new module imports; the
# nucleotide search through the port's CLI gives its golden; a small fit of
# each scoring system of tests/golden/make_gumbel_slice.py (which
# chip_smoke.py's phase 5k imports; its golden writer alone imports jax)
# runs on the plain versions
_BLOCKED_UTIL = _BLOCK + r"""
import importlib
for m in ("data.submat_file", "search.gumbel", "search.evalue",
          "search.prefilter_nucl", "search.nucl_align", "search.nucl_search",
          "pipeline.offsetaln", "pipeline.dbtools4", "pipeline.dbtools7",
          "pipeline.dbtools8", "pipeline.pairaln", "search.alignbykmer",
          "search.fwbw", "search.exhaustive", "pipeline.databases"):
    importlib.import_module(f"metaeuk_tpu_torch.{m}")
sys.path.insert(0, "tests/golden")
import make_gumbel_slice as mgs
from metaeuk_tpu_torch.cli import main
from metaeuk_tpu_torch.data import submat, vtml80
from metaeuk_tpu_torch.search import gumbel

data, golden, out, mode = sys.argv[1:5]
assert main(["createdb", f"{data}/contigs.fna", out + "_cdb"]) == 0
assert main(["search", out + "_cdb", out + "_cdb", out, out + "_tmp",
             "--search-type", "3", "--max-seq-len", "700", "-a",
             "--device", "cpu"]) == 0
for s in ("", ".index", ".dbtype"):
    with open(out + s, "rb") as a, \
            open(f"{golden}/utils/nucl_search_out{s}", "rb") as b:
        assert a.read() == b.read(), s
for name in mgs.GUMBEL_SYSTEMS:
    sc, pb, go, ge = mgs.scoring_system(name, submat, vtml80)
    p = gumbel.fit_gapped(sc, pb, go, ge, n_pairs=64, length=64, chunk=32,
                          isl_pairs=32, isl_length=128, device="cpu")
    assert p["lam"] > 0 and p["K"] > 0, (name, p)
loaded = [k for k in sys.modules if sys.modules[k] is not None and (
    k.split(".")[0].startswith("jax") or k.split(".")[0] == "metaeuk_tpu")]
assert not loaded, loaded
print("jax-free run ok")
"""


def test_util_modules_and_gumbel_fit_run_with_jax_blocked(tmp_path):
    """The M11b modules import, search's nucleotide branch gives its
    golden, and the runtime Gumbel fit runs on the plain versions, with jax
    and metaeuk_tpu blocked."""
    _blocked_run(tmp_path, "kmer", _BLOCKED_UTIL)


# the multi-process and multi-GPU layers: every new module imports; the dry
# run's kernel steps on a one-rank gloo mesh, its fanned prefilter at one
# process and its fixture easy-predict over ["cpu", "cpu"]
_BLOCKED_PARALLEL = _BLOCK + r"""
import importlib
for m in ("parallel.multihost", "parallel.dist_prefilter", "parallel.dist",
          "tools.dist_worker", "tools.dryrun"):
    importlib.import_module(f"metaeuk_tpu_torch.{m}")
from metaeuk_tpu_torch.tools import dryrun

with dryrun.one_rank_group("cpu"):
    dryrun.check_kernel_steps("cpu")
    dryrun.check_dist_prefilter()
dryrun.check_fixture("cpu", ["cpu", "cpu"])
loaded = [k for k in sys.modules if sys.modules[k] is not None and (
    k.split(".")[0].startswith("jax") or k.split(".")[0] in (
        "metaeuk_tpu", "tools"))]
assert not loaded, loaded
print("jax-free run ok")
"""


def test_parallel_layers_run_with_jax_blocked(tmp_path):
    """parallel/{multihost,dist_prefilter,dist}.py and tools/{dist_worker,
    dryrun}.py import, and the dry run's one-rank mesh steps, fanned
    prefilter and fanned fixture run pass, with jax, metaeuk_tpu and the
    repository's tools/ blocked."""
    _blocked_run(tmp_path, "kmer", _BLOCKED_PARALLEL.replace(
        'sys.modules["metaeuk_tpu"] = None',
        'sys.modules["metaeuk_tpu"] = None\nsys.modules["tools"] = None'))


# the k-mer-index prefilter: the module imports, and candidate_pairs on the
# CPU scores the planted cut of tests/golden/make_kmerpf_slice.py (which
# chip_smoke.py's phase 5n imports; its golden writer alone imports jax) in
# its short and long buckets
_BLOCKED_KMERPF = _BLOCK + r"""
sys.path.insert(0, "tests/golden")
import make_kmerpf_slice as mks
from metaeuk_tpu_torch.io.seqdb import DBTYPE_AA, SeqDB
from metaeuk_tpu_torch.ops import ungapped_cuda
from metaeuk_tpu_torch.ops.orf import OrfExtractor
from metaeuk_tpu_torch.params import Params
from metaeuk_tpu_torch.search.kmer_prefilter import KmerPrefilter

frags, targets = mks.planted_cut(mks.PLANTED_CUT, OrfExtractor, Params,
                                 SeqDB, DBTYPE_AA)
pf = KmerPrefilter(Params(), targets, device="cpu",
                   **mks.prefilter_kwargs(mks.KMERPF_SLICE))
kept = pf.candidate_pairs(frags)
assert {0, 1} <= set(kept[kept[:, 0] == mks.PLANTED_CUT["at"], 1].tolist())
assert min(ungapped_cuda.PLAIN_CALLS[k]
           for k in ("gapless_pair", "gapless_long")) > 0
loaded = [k for k in sys.modules if sys.modules[k] is not None and (
    k.split(".")[0].startswith("jax") or k.split(".")[0] == "metaeuk_tpu")]
assert not loaded, loaded
print("jax-free run ok")
"""


def test_kmer_index_prefilter_runs_with_jax_blocked(tmp_path):
    """search/kmer_prefilter.py imports, and candidate_pairs on the planted
    cut that chip_smoke.py's phase 5n builds runs its short and long
    buckets on the plain versions, with jax and metaeuk_tpu blocked."""
    _blocked_run(tmp_path, "kmer", _BLOCKED_KMERPF)
