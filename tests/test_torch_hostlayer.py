"""The port's own host layer against metaeuk_tpu's.

Each copied module stays its original apart from a one-line origin note (and,
in one module, the branch that waits for code the port lacks; in the
modules that take a device keyword, that keyword; in utils/log.py, its stage
timing and the Stats class it drops); the loader builds and
loads the port's host library once, under a lock, and search/fwbw.py's
library into the package's build directory; the CLI helpers map flags to
the same Params.
"""

import argparse
import ast
import functools
import dataclasses
import difflib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from metaeuk_tpu import cli as jax_cli
from metaeuk_tpu.io.seqdb import DBTYPE_AA, DBTYPE_NUCL, SeqDB
from metaeuk_tpu.ops.orf import OrfExtractor
from metaeuk_tpu.params import Params as JaxParams
from metaeuk_tpu.search import prefilter_kmer as jax_prefilter_kmer
from metaeuk_tpu.search.evalue import EvalueComputation as JaxEvalue
from metaeuk_tpu_torch import cli, native
from metaeuk_tpu_torch.params import Params
from metaeuk_tpu_torch.search import evalue, prefilter_kmer

ROOT = pathlib.Path(__file__).parent.parent
DATA = ROOT / "tests" / "data"
COPIES = ["params.py", "utils/log.py", "utils/session.py", "io/fasta.py",
          "io/seqdb.py", "io/mmseqsdb.py", "io/zstdio.py", "io/profiledb.py",
          "data/submat.py", "data/gencode.py", "data/vtml80.py",
          "ops/orf.py", "ops/chain.py", "ops/masker.py",
          "pipeline/output.py", "pipeline/reduce.py",
          "pipeline/dpformat.py", "pipeline/alnformat.py",
          "pipeline/dbtools.py", "pipeline/dbtools2.py",
          "pipeline/filterdb.py", "pipeline/rescorediagonal.py",
          "pipeline/percontig.py", "pipeline/groups.py", "tax/ncbi.py",
          "tax/mmtax.py", "ops/pssm.py", "ops/msafilter.py",
          "ops/csprofile.py", "pipeline/result2profile.py",
          "pipeline/msa2profile.py", "pipeline/sequence2profile.py",
          "pipeline/profile2pssm.py", "pipeline/convertprofiledb.py",
          "pipeline/expand.py", "pipeline/clust.py", "pipeline/dbtools3.py",
          "pipeline/result2msa.py", "pipeline/ca3m.py", "data/nucl.py",
          "ops/sw.py", "search/linclust.py", "pipeline/dbtools5.py",
          "pipeline/multihit.py", "data/submat_file.py",
          "search/prefilter_nucl.py", "search/nucl_align.py",
          "search/nucl_search.py", "pipeline/dbtools4.py",
          "pipeline/dbtools7.py", "pipeline/dbtools8.py",
          "pipeline/pairaln.py", "search/alignbykmer.py",
          "search/exhaustive.py", "pipeline/databases.py"]
# data files the port carries byte for byte
DATA_COPIES = ["data/resources/CovSeqidQscPercMinDiag.lib",
               "data/resources/CovSeqidQscPercMinDiagTargetCov.lib",
               "data/resources/README.md"]
# copies whose one branch asks the torch process group where the original
# asks jax: (the lines it drops, the lines it adds), stripped
WAITING = {"search/prefilter_kmer.py": (
    ["import jax", "n_proc = jax.process_count()"],
    ["from ..parallel.multihost import process_count",
     "n_proc = process_count()"])}
# copies that add a device keyword (default cuda) and pass it on, with the
# words that the other changed lines of their code may carry: gumbel's
# _simulate aligns through ops/sw_cuda.py where the original imports
# ops/sw_jax.py, and its default cache file carries the port's name
DEVICE_COPIES = {
    "search/evalue.py": (), "pipeline/offsetaln.py": (),
    "search/gumbel.py": ("sw_jax", "sw_cuda", "_gumbel.json"),
    "search/kmermatcher.py": (), "search/linsearch_lin.py": (),
    "search/searchdb.py": (), "pipeline/cluster.py": (),
    "pipeline/clusterwf.py": ()}


# copies that rework part of their original: (the lines they drop, the
# lines they add). utils/log.py times a stage by a span of utils/trace.py
# and drops the Stats class, which nothing calls
REWORKED = {"utils/log.py": (
    ["        self.t0 = time.perf_counter()",
     "        dt = time.perf_counter() - self.t0",
     "", "",
     "class Stats:",
     '    """Per-run counters (the reference prints k-mers/pos, '
     'matches/query',
     '    etc. after the prefilter; we track the analogous numbers)."""',
     "",
     "    def __init__(self):",
     "        self.counters = {}",
     "",
     "    def add(self, name, value=1):",
     "        self.counters[name] = self.counters.get(name, 0) + value",
     "",
     "    def set(self, name, value):",
     "        self.counters[name] = value",
     "",
     "    def report(self):",
     "        for name in sorted(self.counters):",
     '            info(f"{name}: {self.counters[name]}")',
     "        return dict(self.counters)"],
    ["", "from . import trace",
     "        self.span = trace.span(self.name).__enter__()",
     "        self.span.__exit__(*exc)",
     "        dt = self.span.t1 - self.span.t0"])}


def _changed(rel):
    """(lines only in the original, lines only in the copy), the copy's
    leading origin note left out."""
    orig = (ROOT / "metaeuk_tpu" / rel).read_text().splitlines()
    copy = (ROOT / "metaeuk_tpu_torch" / rel).read_text().splitlines()
    assert copy[0].startswith(f"# Copy of metaeuk_tpu/{rel};")
    while copy[0].startswith("#"):
        copy = copy[1:]
    diff = list(difflib.ndiff(orig, copy))
    return ([d[2:] for d in diff if d.startswith("- ")],
            [d[2:] for d in diff if d.startswith("+ ")])


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_its_original(rel):
    assert _changed(rel) == REWORKED.get(rel, ([], []))


@pytest.mark.parametrize("rel", DATA_COPIES)
def test_data_copy_is_its_original(rel):
    assert (ROOT / "metaeuk_tpu_torch" / rel).read_bytes() == \
        (ROOT / "metaeuk_tpu" / rel).read_bytes()


@pytest.mark.parametrize("rel", sorted(WAITING))
def test_waiting_copy_differs_only_in_its_branch(rel):
    gone, added = _changed(rel)
    assert ([g.strip() for g in gone], [a.strip() for a in added]) == \
        WAITING[rel]


def _code(path):
    """The statements of a module, one line each as ast.unparse writes
    them, with its docstrings, every parameter named device (and its
    default) and every device= keyword of a call left out."""
    tree = ast.parse(pathlib.Path(path).read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(
                body[0], ast.Expr) and isinstance(
                    getattr(body[0], "value", None), ast.Constant) and \
                isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
        if isinstance(node, ast.arguments):
            for i, a in reversed(list(enumerate(node.args))):
                if a.arg == "device":
                    k = i - (len(node.args) - len(node.defaults))
                    del node.args[i]
                    if k >= 0:
                        del node.defaults[k]
            for i, a in reversed(list(enumerate(node.kwonlyargs))):
                if a.arg == "device":
                    del node.kwonlyargs[i], node.kw_defaults[i]
        if isinstance(node, ast.Call):
            node.keywords = [k for k in node.keywords if k.arg != "device"]
    return ast.unparse(tree).splitlines()


@pytest.mark.parametrize("rel", sorted(DEVICE_COPIES))
def test_device_keyword_copy_differs_only_in_it(rel):
    """With its device parameters and device= keywords left out, the
    copy's code is its original's but for lines that carry device (the
    copy's own, such as a device check) or one of the module's own words;
    and the copy has a device parameter."""
    diff = [d for d in difflib.ndiff(_code(ROOT / "metaeuk_tpu" / rel),
                                     _code(ROOT / "metaeuk_tpu_torch" / rel))
            if d[:2] in ("- ", "+ ")]
    words = ("device", *DEVICE_COPIES[rel])
    assert all(any(w in d for w in words) for d in diff), \
        [d for d in diff if not any(w in d for w in words)]
    assert "device=" in (ROOT / "metaeuk_tpu_torch" / rel).read_text()


def test_evalues_match_at_default_and_non_default_scoring(tmp_path,
                                                          monkeypatch):
    """The tabulated BLOSUM62 11/1 system and the runtime fit of VTML80 at
    10/1 (both packages' fits at a small size, their caches in tmp_path)
    give the JAX package's E-values."""
    from metaeuk_tpu.data import vtml80 as jax_vtml80
    from metaeuk_tpu.search import gumbel as jax_gumbel
    from metaeuk_tpu_torch.data import vtml80
    from metaeuk_tpu_torch.data.submat import BLOSUM62_PBACK, BLOSUM62_SCORES
    from metaeuk_tpu_torch.search import gumbel
    small = dict(n_pairs=256, length=96, chunk=128, isl_pairs=128,
                 isl_length=192)
    for mod, tag in ((jax_gumbel, "jax"), (gumbel, "port")):
        monkeypatch.setattr(mod, "_FIT_CACHE_PATH",
                            str(tmp_path / f"{tag}.json"))
        monkeypatch.setattr(mod, "_mem_cache", {})
        monkeypatch.setattr(mod, "fit_gapped",
                            functools.partial(mod.fit_gapped, **small))
    scores = np.arange(0, 200, 7, dtype=np.float64)
    lens = np.full(len(scores), 150.0)
    port = evalue.EvalueComputation.for_scoring(1e6, BLOSUM62_SCORES,
                                                BLOSUM62_PBACK, 11, 1)
    np.testing.assert_array_equal(port.compute_evalue(scores, lens),
                                  JaxEvalue(1e6).compute_evalue(scores, lens))
    assert not gumbel._mem_cache
    sc, pb, _ = vtml80._build(2.0)
    port = evalue.EvalueComputation.for_scoring(1e6, sc, pb, 10, 1,
                                                device="cpu")
    jsc, jpb, _ = jax_vtml80._build(2.0)
    want = JaxEvalue.for_scoring(1e6, jsc, jpb, 10, 1)
    assert port.p == want.p
    np.testing.assert_array_equal(port.compute_evalue(scores, lens),
                                  want.compute_evalue(scores, lens))


_FWBW_RUN = r"""
import sys, threading
sys.modules["metaeuk_tpu"] = None
from metaeuk_tpu_torch.search import fwbw
got = []
barrier = threading.Barrier(4)
def ask():
    barrier.wait()
    got.append(fwbw._get_lib())
threads = [threading.Thread(target=ask) for _ in range(4)]
for t in threads: t.start()
for t in threads: t.join()
assert len(got) == 4 and all(g is got[0] for g in got), got
print(got[0]._name)
"""


def test_fwbw_loader_builds_into_the_package():
    """Four threads ask for fwbw's library at once in a fresh process: each
    gets the same library, built from native/fwbw.cpp with -ffp-contract=off
    into metaeuk_tpu_torch/build/ under a digest name, never
    native/libmetaeuk_fwbw.so."""
    from metaeuk_tpu_torch.search import fwbw
    res = subprocess.run([sys.executable, "-c", _FWBW_RUN], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    path = pathlib.Path(res.stdout.strip())
    assert path.parent == ROOT / "metaeuk_tpu_torch" / "build"
    assert path.name.startswith("libmetaeuk_fwbw-")
    assert "-ffp-contract=off" in fwbw._FLAGS
    assert path == native.build_library("libmetaeuk_fwbw", ["fwbw.cpp"],
                                        fwbw._FLAGS)


def test_fwbw_loader_raises_when_the_build_fails(tmp_path, monkeypatch):
    from metaeuk_tpu_torch.search import fwbw
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(fwbw, "_LIB", None)
    monkeypatch.setattr(fwbw, "_FLAGS", ("-no-such-flag", *fwbw._FLAGS))
    with pytest.raises(subprocess.CalledProcessError):
        fwbw._get_lib()
    assert fwbw._LIB is None and not list(tmp_path.glob("*.so"))


def _fixture_fragments():
    contigs = SeqDB.from_fasta(DATA / "contigs.fna", DBTYPE_NUCL)
    ex = OrfExtractor(JaxParams())
    frags = []
    for ci in range(len(contigs)):
        _, f = ex.extract_contig(contigs.seq_bytes(ci), ci)
        frags.extend(ex.translate_fragments(f))
    return frags


def test_target_split_prefilter_matches_jax_and_dist_split_waits(
        monkeypatch, tmp_path):
    """The split prefilter's candidate pairs equal the JAX package's, also
    with METAEUK_DIST_TMP set and no process group (one process: the
    sequential split engine; the fanned one is tests/test_torch_dist.py's)."""
    targets = SeqDB.from_fasta(DATA / "proteins.faa", DBTYPE_AA)
    frags = _fixture_fragments()
    p = Params(split=2)
    ref = jax_prefilter_kmer.ReferenceKmerPrefilter(
        JaxParams(split=2), targets).candidate_pairs(frags)
    got = prefilter_kmer.ReferenceKmerPrefilter(p, targets).candidate_pairs(
        frags)
    assert len(ref) > 0
    np.testing.assert_array_equal(ref, got)
    # METAEUK_DIST_TMP with no process group: one process, the sequential
    # split engine, the same candidate pairs
    monkeypatch.setenv("METAEUK_DIST_TMP", str(tmp_path / "dist"))
    ref_dist = jax_prefilter_kmer.ReferenceKmerPrefilter(
        JaxParams(split=2), targets).candidate_pairs(frags)
    pref = prefilter_kmer.ReferenceKmerPrefilter(p, targets)
    assert isinstance(pref.pf, prefilter_kmer.SplitKmerPrefilter)
    np.testing.assert_array_equal(ref_dist, pref.candidate_pairs(frags))
    np.testing.assert_array_equal(ref, ref_dist)


_LOADER_RUN = r"""
import sys, threading
sys.modules["metaeuk_tpu"] = None
from metaeuk_tpu_torch import native
got = []
barrier = threading.Barrier(8)
def ask():
    barrier.wait()
    got.append(native.get_lib())
threads = [threading.Thread(target=ask) for _ in range(8)]
for t in threads: t.start()
for t in threads: t.join()
assert len(got) == 8 and got[0] is not None, got
assert all(g is got[0] for g in got)
print(got[0]._name)
"""


def test_loader_is_thread_safe_and_builds_into_the_package():
    """Eight threads ask for the library at once in a fresh process: every
    one gets the same loaded library, from metaeuk_tpu_torch/build/."""
    res = subprocess.run([sys.executable, "-c", _LOADER_RUN], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    path = pathlib.Path(res.stdout.strip())
    assert path == native.library_path()
    assert path.parent == ROOT / "metaeuk_tpu_torch" / "build"
    assert path.name.startswith("libmetaeuk_host-")


def test_native_chain_dp_matches_python():
    from metaeuk_tpu_torch.pipeline.predict import _chain_dp_py
    rng = np.random.default_rng(0)
    n = 12
    cs = np.sort(rng.integers(0, 3000, n))
    ce = cs + rng.integers(30, 300, n)
    ts = np.sort(rng.integers(0, 200, n))
    te = ts + rng.integers(10, 60, n)
    bit = rng.integers(20, 90, n)
    aa = (ce - cs + 1) // 3
    p = Params()
    got = native.chain_dp(cs, ce, ts, te, bit, aa, 250, p)
    ref = _chain_dp_py(cs, ce, ts, te, bit, aa, 250, p)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[2:] == ref[2:]


@pytest.mark.parametrize("argv", [[], ["--prefilter-mode", "ungapped",
                                       "--max-seqs", "50", "-e", "0.5",
                                       "--split-memory-limit", "4G",
                                       "--comp-bias-corr", "0"]])
def test_cli_flags_map_to_the_same_params(argv):
    parsed = []
    for mod in (jax_cli, cli):
        ap = argparse.ArgumentParser()
        mod._add_predict_flags(ap)
        parsed.append(mod._params_from_args(ap.parse_args(argv)))
    assert dataclasses.asdict(parsed[0]) == dataclasses.asdict(parsed[1])
