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


# the port's microbenchmarks: both entry points on the CPU, jax blocked
_BLOCKED_TOOLS = _BLOCK + r"""
import metaeuk_tpu_torch.ops.kbench_cuda
import metaeuk_tpu_torch.ops.kbench_torch
import metaeuk_tpu_torch.ops.qm_variants_cuda
import metaeuk_tpu_torch.ops.qm_variants_torch
from metaeuk_tpu_torch.tools import kbench, kernel_variants

res = kbench.main(["--device", "cpu", "alu_i32"])
assert int(res["alu_i32"][2].min()) == 512 * 4
res = kernel_variants.main(["--device", "cpu", "--lq", "32", "--lt", "64",
                            "--tiles", "1", "base"])
assert int(res["base"][1][0]) > 0
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


def test_microbenchmark_entry_points_run_with_jax_blocked(tmp_path):
    """The six modules of T1-T4 import, and `kbench --device cpu alu_i32`
    and `kernel_variants --device cpu base` run, with jax, metaeuk_tpu and
    the repository's tools/ blocked."""
    _blocked_run(tmp_path, "kmer", _BLOCKED_TOOLS.replace(
        'sys.modules["metaeuk_tpu"] = None',
        'sys.modules["metaeuk_tpu"] = None\nsys.modules["tools"] = None'))
