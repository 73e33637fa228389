"""The port's multihit family on the CPU against the MMseqs2 goldens and the
JAX package.

multihitdb and multihitsearch through the port's CLI (device="cpu", the
kernels' plain versions) on tests/golden/util7's two set files give the ten
DBs tests/test_util7.py holds the JAX package to, and every file the JAX
package's multihitdb / multihitsearch write on the same input;
besthitperset and combinepvalperset give tests/golden/multihit. The
multihit slice's writer (tests/golden/make_multihit_slice.py) bins the
k-mer slice's contigs as chip_smoke.py does, and phase 5i runs on its
first three sets against multihit_slice.json's rehearsal digests (the JAX
package's). The tolerance is exact equality.
"""

import contextlib
import json
import os
import pathlib
import sys

import numpy as np
import pytest

from metaeuk_tpu_torch import cli
from metaeuk_tpu_torch.ops import sw_cuda

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests" / "golden"))
import chip_smoke  # noqa: E402
import make_multihit_slice as mms  # noqa: E402

GOLDEN = ROOT / "tests" / "golden"
U7 = GOLDEN / "util7"
MH = GOLDEN / "multihit"
DB_SUFFIXES = ("", ".index", ".dbtype")
# the DBs tests/test_util7.py holds to util7's goldens: (ours, golden)
UTIL7_DBS = [(f"mhdb{s}", f"mhdb{s}") for s in mms.MULTIHITDB_DBS] + [
    ("mhstmp/result", "mh_result"), ("mhstmp/aggregate", "mh_aggregate"),
    ("mhres", "mhres")]


def files(d):
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(pathlib.Path(d).rglob("*")) if p.is_file()}


def test_multihit_matches_util7_goldens_and_jax(tmp_path):
    """The port's CLI writes util7's ten DBs; every file under the port's
    and the JAX package's output directories (the nucleotide, ORF and
    translated DBs, the set maps, the prefilter, result and aggregate DBs)
    is equal."""
    from metaeuk_tpu.pipeline.multihit_wf import multihitdb, multihitsearch
    sets = [str(U7 / "set0.fna"), str(U7 / "set1.fna")]
    port, jax = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    jax.mkdir()
    sw_cuda.reset_counts()
    assert cli.main(["multihitdb", *sets, str(port / "mhdb"),
                     str(port / "mhtmp")]) == 0
    assert cli.main(["multihitsearch", str(port / "mhdb"), str(port / "mhdb"),
                     str(port / "mhres"), str(port / "mhstmp"), "--device",
                     "cpu"]) == 0
    assert sw_cuda.PLAIN_CALLS["sw_pair_ends"] > 0
    assert not any(sw_cuda.LAUNCHES.values())
    for ours, golden in UTIL7_DBS:
        for s in DB_SUFFIXES:
            assert (port / f"{ours}{s}").read_bytes() == \
                (U7 / f"{golden}{s}").read_bytes(), f"{ours}{s}"
    multihitdb(sets, str(jax / "mhdb"), str(jax / "mhtmp"))
    multihitsearch(str(jax / "mhdb"), str(jax / "mhdb"), str(jax / "mhres"),
                   str(jax / "mhstmp"))
    got, want = files(port), files(jax)
    assert len(got) > 40 and got == want


@pytest.mark.parametrize("case", [
    ("besthitperset", dict(), "refbh"),
    ("besthitperset", dict(simple_best_hit=False), "refbh_ns"),
    *(("combinepvalperset", dict(aggregation_mode=m), f"refcp_m{m}")
      for m in range(4))], ids=lambda c: f"{c[0]}-{c[2]}")
def test_multihit_aggregation_matches_goldens(tmp_path, case):
    from metaeuk_tpu_torch.pipeline.multihit import (besthitperset,
                                                     combinepvalperset)
    name, kw, golden = case
    out = tmp_path / golden
    if name == "besthitperset":
        besthitperset(str(MH / "mh_res"), str(MH / "mh_tmap_member_to_set"),
                      str(MH / "mh_tmap_set_size"), str(out), **kw)
    else:
        combinepvalperset(str(MH / "mh_logp"), str(MH / "mh_qsize_set_size"),
                          str(MH / "mh_tmap_member_to_set"),
                          str(MH / "mh_tmap_set_size"), str(out), **kw)
    for s in ("", ".index"):
        assert pathlib.Path(f"{out}{s}").read_bytes() == \
            (MH / f"{golden}{s}").read_bytes(), s


def test_multihitdb_calls_the_ports_cli(tmp_path, monkeypatch):
    """multihitdb's createdb, tsv2db, extractorfs, translatenucs and
    orftocontig go through the port's CLI, never the JAX package's."""
    from metaeuk_tpu_torch.pipeline.multihit_wf import multihitdb
    called = []
    main = cli.main

    def recorded(argv):
        called.append(argv[0])
        return main(argv)
    monkeypatch.setattr(cli, "main", recorded)
    multihitdb([str(U7 / "set0.fna")], str(tmp_path / "db"),
               str(tmp_path / "tmp"))
    assert called == ["createdb", "tsv2db", "tsv2db", "extractorfs",
                      "translatenucs", "orftocontig"]


def test_multihit_slice_bins_the_kmer_slices_contigs(tmp_path):
    """The writer puts contigs 7i .. 7i + 6 of make_metagenome(1.6, 3000)
    into set i, for the 35 sets (245 contigs), in order."""
    from tools.make_metagenome import make_metagenome
    cfg = mms.MULTIHIT_SLICE
    paths = mms.multihit_slice(cfg, tmp_path)
    assert [p.name for p in paths] == [f"set{i:02d}.fna" for i in range(35)]
    contigs, _ = make_metagenome(cfg["mbp"], cfg["targets"], cfg["seed"])
    for i in (0, 17, 34):
        names = [ln[1:].split()[0] for ln in paths[i].read_text().split("\n")
                 if ln.startswith(">")]
        assert names == [c[0].split()[0] for c in contigs[7 * i:7 * i + 7]]
    (tmp_path / "cut").mkdir()
    assert len(mms.multihit_slice(cfg, tmp_path / "cut", 3)) == 3


def test_multihit_slice_json_matches_its_input():
    """tests/golden/multihit_slice.json was made from MULTIHIT_SLICE, holds
    the whole slice, its cut and the rehearsal, each with the ten digests
    phase 5i compares (the prefilter's counted only)."""
    golden = json.loads((GOLDEN / "multihit_slice.json").read_text())
    assert golden["input"] == mms.MULTIHIT_SLICE
    assert set(golden["sha256"]) == set(mms.RUNS) == set(golden["counts"])
    for run in mms.RUNS:
        assert len(golden["sha256"][run]) == 10
        assert golden["counts"][run]["mhdb_set_size"] == \
            mms.MULTIHIT_SLICE[mms.RUNS[run]]
    whole = golden["counts"]["whole"]
    assert whole["mhdb"] == 28098 and whole["pref"] == 281294
    assert whole["mhdb_nucl_contig_to_set"] == 245


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


def test_chip_smoke_multihit_slice_rehearsal_on_cpu(tmp_path):
    """chip_smoke.py's phase 5i on the slice's first three sets, on the CPU:
    both routings' hits and outputs equal, the counts and digests equal
    multihit_slice.json's rehearsal (the JAX package's), and every step of
    the workflow timed."""
    records = chip_smoke.check_multihit_slice(np, cli, tmp_path, "cpu",
                                              _cpu_probe, run="rehearsal")
    assert set(records) == {"multihitdb", "multihitsearch QM auto",
                            "multihitsearch QM off"}
    steps = [s for s, _, _ in records["multihitdb"]["steps"]]
    assert steps == ["createdb", "tsv2db", "tsv2db", "extractorfs",
                     "translatenucs", "orftocontig", "filterdb", "filterdb",
                     "swapdb", "result2stats"]
    r = records["multihitsearch QM auto"]
    assert [s for s, _, _ in r["steps"]] == [
        "prefilter", "align", "SearchDriver.search", "besthitperset",
        "mergeresultsbyset"]
    assert r["pairs"] == 4085 and len(r["hits"]) == 1
    assert os.environ.get("METAEUK_QM") is None
