"""MetaEuk's modular commands in the port against the goldens and the JAX
package's CLI, on the CPU.

predictexons -> reduceredundancy -> unitesetstofasta are held to the
MetaEuk binary's stage DBs (tests/golden/dbs) and outputs
(tests/golden/easypredict.*), extractorfs -> resultspercontig ->
collectoptimalset to tests/golden/percontig, as tests/test_intermediates.py
and tests/test_percontig.py hold the JAX package (chip_smoke.py's phase 4f,
rehearsed here); each command of the port's CLI also writes the bytes the
JAX CLI writes for the same arguments, groupstoacc, translatenucs and
createtsv among them. The aligning commands run with --device cpu (the
kernels' plain versions). Every comparison is of bytes: the tolerance is
exact equality.
"""

import pathlib
import sys

import pytest
import torch

from metaeuk_tpu import cli as jax_cli
from metaeuk_tpu_torch import cli
from metaeuk_tpu_torch.ops import sw_cuda

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
DATA = ROOT / "tests" / "data"
GOLDEN = ROOT / "tests" / "golden"
DB_SUFFIXES = ("", ".index", ".dbtype")
SUFFIXES = ("fas", "codon.fas", "headersMap.tsv", "gff")
# the commands that align, each with --device
ALIGNING = ("predictexons", "unitesetstofasta")


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """The fixture's contig and target DBs and its six-frame fragments at
    predictexons' preset (--min-length 15), by the port's CLI."""
    td = tmp_path_factory.mktemp("modular")
    for fasta, db in (("contigs.fna", "contigs"), ("proteins.faa",
                                                   "targets")):
        assert cli.main(["createdb", str(DATA / fasta), str(td / db)]) == 0
    assert cli.main(["extractorfs", str(td / "contigs"), str(td / "nucl_6f"),
                     "--min-length", "15"]) == 0
    return td


def test_chip_smoke_modular_workflows_on_cpu(tmp_path):
    """chip_smoke.py's phase 4f (its modular part), rehearsed on the CPU:
    the DBs and outputs equal the MetaEuk binary's goldens, through the
    plain versions only."""
    sw_cuda.reset_counts()
    chip_smoke.check_modular_workflows(cli, "cpu", tmp_path)
    assert sw_cuda.PLAIN_CALLS["sw_pair_ends"] > 0
    assert sum(sw_cuda.LAUNCHES.values()) == 0


def test_chip_smoke_modular_run_on_cpu(tmp_path):
    """chip_smoke.py's phase 5f (a) on the fixture, on the CPU: the three
    commands' outputs equal easypredict.*, with each command's seconds and
    the DP-format round trip's."""
    secs = chip_smoke.run_modular(cli, DATA / "contigs.fna",
                                  DATA / "proteins.faa", tmp_path, "cpu")
    assert set(secs) == {"predictexons", "reduceredundancy",
                         "unitesetstofasta", "dp_write", "dp_parse"}
    for s in SUFFIXES:
        assert pathlib.Path(f"{tmp_path / 'slice'}.{s}").read_bytes() == \
            (GOLDEN / f"easypredict.{s}").read_bytes(), s


def _db(path):
    return [f"{path}{s}" for s in DB_SUFFIXES]


def _cli_case(name, d, fix):
    """argv of command `name` (without --device) writing under d, and the
    files it writes; fix holds the fixture DBs."""
    c, t = str(DATA / "contigs.fna"), str(DATA / "proteins.faa")
    dbs, pc = GOLDEN / "dbs", GOLDEN / "percontig"
    return {
        "predictexons": (["predictexons", c, t, f"{d}/dp"], _db(f"{d}/dp")),
        "predictexons_db": (["predictexons", str(fix / "contigs"),
                             str(fix / "targets"), f"{d}/dp",
                             "--metaeuk-tcov", "0.3"], _db(f"{d}/dp")),
        "reduceredundancy": (["reduceredundancy", str(dbs / "dp_preds"),
                              f"{d}/red", f"{d}/clust"],
                             _db(f"{d}/red") + _db(f"{d}/clust")),
        "unitesetstofasta": (["unitesetstofasta", c, t,
                              str(dbs / "red_preds"), f"{d}/ep"],
                             [f"{d}/ep.{s}" for s in SUFFIXES]),
        "unitesetstofasta_db": (["unitesetstofasta", str(fix / "contigs"),
                                 str(fix / "targets"), str(dbs / "red_preds"),
                                 f"{d}/ep", "--target-key"],
                                [f"{d}/ep.{s}" for s in SUFFIXES]),
        "groupstoacc": (["groupstoacc", c, t, str(dbs / "red_clust"),
                         f"{d}/groups.tsv"], [f"{d}/groups.tsv"]),
        "extractorfs": (["extractorfs", str(fix / "contigs"), f"{d}/orfs",
                         "--min-length", "15"],
                        _db(f"{d}/orfs") + _db(f"{d}/orfs_h")),
        "extractorfs_translate": (["extractorfs", c, f"{d}/orfs",
                                   "--translate"],
                                  _db(f"{d}/orfs") + _db(f"{d}/orfs_h")),
        "translatenucs": (["translatenucs", str(fix / "nucl_6f"),
                           f"{d}/aa", "--translation-table", "4"],
                          _db(f"{d}/aa") + _db(f"{d}/aa_h")),
        "resultspercontig": (["resultspercontig", str(fix / "contigs"),
                              str(fix / "nucl_6f"), str(pc / "search_res"),
                              f"{d}/bc"], _db(f"{d}/bc")),
        "collectoptimalset": (["collectoptimalset", str(pc / "by_contig"),
                               str(fix / "targets"), f"{d}/dp",
                               "--metaeuk-eval", "0.01"], _db(f"{d}/dp")),
        "createtsv": (["createtsv", str(fix / "contigs"),
                       str(pc / "by_contig"), f"{d}/bc.tsv"],
                      [f"{d}/bc.tsv"]),
    }[name]


CASES = ["predictexons", "predictexons_db", "reduceredundancy",
         "unitesetstofasta", "unitesetstofasta_db", "groupstoacc",
         "extractorfs", "extractorfs_translate", "translatenucs",
         "resultspercontig", "collectoptimalset", "createtsv"]


@pytest.mark.parametrize("name", CASES)
def test_cli_matches_jax_cli(dbs, tmp_path, name):
    """Each modular command of the port's CLI writes the bytes the JAX CLI
    writes for the same arguments."""
    outs = {}
    for side, main in (("jax", jax_cli.main), ("port", cli.main)):
        d = tmp_path / side
        d.mkdir()
        argv, files = _cli_case(name, d, dbs)
        if side == "port" and argv[0] in ALIGNING:
            argv = argv + ["--device", "cpu"]
        assert main(argv) == 0
        outs[side] = [pathlib.Path(f).read_bytes() for f in files]
    assert outs["port"] == outs["jax"]
    assert any(outs["port"])


@pytest.mark.parametrize("name", ["predictexons", "unitesetstofasta"])
def test_aligning_commands_default_to_cuda(dbs, tmp_path, monkeypatch,
                                           name):
    """Without --device the command asks for a CUDA device, and raises
    where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv, _ = _cli_case(name, tmp_path, dbs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
