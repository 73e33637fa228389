"""The commands the port's CLI wires over modules it already carries, on the
CPU, against the JAX CLI and the MMseqs2 goldens.

Every case of chip_smoke.DB_CLI_CASES (the dbtools, dbtools2 and dbtools5
families, filterdb, rescorediagonal, createindex, prefilter with and
without the persisted index, indexdb, kmerindexdb, nrtotaxmapping,
filterresult, the multihit commands and version) runs through
metaeuk_tpu's CLI and through the port's on the same fixture: the files
each writes, and what it prints, are equal byte for byte (a link's target
read relative to the case's directory), and equal to the case's MMseqs2
goldens. version prints the port's own line. The port's subcommands are
the JAX CLI's, all 150 (none is queued), pinned here; multihitsearch and
gpuserver take --device (default cuda), the other new commands none.
chip_smoke.py's phase 4i, rehearsed on the CPU. The same for every case of
chip_smoke.UTIL_CLI_CASES (the commands of dbtools4, dbtools7, dbtools8,
pairaln, alignbykmer, fwbw, the exhaustive prefilters, databases,
offsetalignment, proteinaln2nucl, and search's nucleotide branch): phase 4j.
The tolerance is exact equality.
"""

import argparse
import contextlib
import os
import pathlib
import sys
import unittest.mock

import pytest

from metaeuk_tpu import cli as jax_cli
from metaeuk_tpu_torch import cli
from metaeuk_tpu_torch.ops import sw_cuda

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

GOLDEN = ROOT / "tests" / "golden"
# the JAX CLI's subcommands the port does not have yet: none since bench
QUEUED = set()
# the subcommands of the last slices: the M11b commands, all host-only
UTIL = {
    # dbtools4
    "aliasdb", "compress", "decompress", "dbtype", "diskspaceavail",
    "setextendeddbtype", "translateaa", "view",
    # dbtools7
    "createclusearchdb", "msa2result", "transitivealign", "tsv2exprofiledb",
    # dbtools8
    "appenddbtoindex", "calculatelambda", "convertkb", "extractdomains",
    "pairaln", "alignbykmer", "fwbw", "ungappedprefilter", "gappedprefilter",
    "databases", "offsetalignment", "proteinaln2nucl"}
# and the multihit family, the server and the M11a commands
NEW = {
    "reverseseq", "sortresult", "tsv2db", "mergedbs", "createsubdb",
    "extractframes", "splitsequence", "convert2fasta",
    "swapdb", "swapresults", "prefixid", "suffixid", "subtractdbs",
    "summarizeresult", "result2flat", "createseqfiledb", "splitdb",
    "orftocontig", "renamedbkeys", "concatdbs", "rmdb", "mvdb", "cpdb",
    "lndb", "touchdb",
    "extractalignedregion", "summarizeheaders", "clusthash",
    "mergeresultsbyset", "makepaddedseqdb", "unpackdb", "countkmer",
    "recoverlongestorf", "tar2db", "db2tar",
    "besthitperset", "combinepvalperset", "multihitdb", "multihitsearch",
    "gpuserver", "serverclient",
    "filterdb", "rescorediagonal", "createindex", "prefilter", "indexdb",
    "kmerindexdb", "nrtotaxmapping", "filterresult", "version"}
ALIGNING = {"multihitsearch", "gpuserver"}


def subparsers(main):
    """{subcommand: its parser} of a CLI's main."""
    got = {}

    def capture(self, argv=None, namespace=None):
        for a in self._actions:
            if isinstance(a, argparse._SubParsersAction):
                got.update(a.choices)
        raise SystemExit(0)
    with unittest.mock.patch.object(argparse.ArgumentParser, "parse_args",
                                    capture), \
            contextlib.suppress(SystemExit):
        main([])
    return got


def tree(d):
    """{path under d: bytes, or ("link", target)}, d written as <out> in
    both."""
    out = {}
    for p in sorted(pathlib.Path(d).rglob("*")):
        rel = str(p.relative_to(d))
        if p.is_symlink():
            out[rel] = ("link", os.readlink(p).replace(str(d), "<out>"))
        elif p.is_file():
            out[rel] = p.read_bytes().replace(str(d).encode(), b"<out>")
    return out


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    return chip_smoke.db_cli_fixture(cli, "cpu",
                                     tmp_path_factory.mktemp("dbcli_fx"))


@pytest.fixture(scope="module")
def util_fx(tmp_path_factory):
    return chip_smoke.util_cli_fixture(cli, "cpu",
                                       tmp_path_factory.mktemp("util_fx"))


def run_both(case, fx, tmp_path):
    """(the JAX CLI's, the port's) (printed text, tree of outputs) of a
    case; the port's outputs are left under tmp_path / "port"."""
    got = []
    for tag, main, device in (("jax", jax_cli.main, None),
                              ("port", cli.main, "cpu")):
        out = tmp_path / tag
        rc, text = chip_smoke.run_db_cli_case(main, case, fx, out, device)
        assert rc == 0, tag
        got.append((text.replace(str(out), "<out>"), tree(out)))
    return got


@pytest.mark.parametrize("name", list(chip_smoke.DB_CLI_CASES))
def test_command_matches_the_jax_cli_and_goldens(fx, tmp_path, name):
    case = chip_smoke.DB_CLI_CASES[name]
    (j_text, j_tree), (p_text, p_tree) = run_both(case, fx, tmp_path)
    assert p_tree == j_tree
    if name == "version":
        assert p_text == cli.VERSION + "\n"
        assert j_text.startswith("metaeuk-tpu 1.0 ")
    else:
        assert p_text == j_text
    chip_smoke.check_golden(name, case, p_text, tmp_path / "port")


@pytest.mark.parametrize("name", list(chip_smoke.UTIL_CLI_CASES))
def test_util_command_matches_the_jax_cli_and_goldens(util_fx, tmp_path,
                                                       name):
    case = chip_smoke.UTIL_CLI_CASES[name]
    (j_text, j_tree), (p_text, p_tree) = run_both(case, util_fx, tmp_path)
    assert p_tree == j_tree
    if not case.get("text_varies"):
        assert p_text == j_text
    assert chip_smoke.check_golden(name, case, p_text,
                                   tmp_path / "port") == len(case["goldens"])


def test_cases_cover_every_new_command():
    """The cases run every new command but the server's two, which
    tests/test_torch_server.py runs."""
    covered = {c["argv"][0] for c in chip_smoke.DB_CLI_CASES.values()}
    assert covered | {"gpuserver", "serverclient"} == NEW
    assert len(NEW) == 50
    assert chip_smoke.UNPACKED == sorted(
        p.name for p in (GOLDEN / "util5" / "unpacked").iterdir())


def test_util_cases_cover_every_util_command():
    """The M11b cases run each of the 24 commands, and search's nucleotide
    branch."""
    covered = {c["argv"][0] for c in chip_smoke.UTIL_CLI_CASES.values()}
    assert covered == UTIL | {"search"} and len(UTIL) == 24


def test_port_subcommands_are_the_jax_clis_minus_the_queued():
    jax_cmds, port_cmds = set(subparsers(jax_cli.main)), set(
        subparsers(cli.main))
    assert len(jax_cmds) == 150 and len(QUEUED) == 0
    assert QUEUED <= jax_cmds
    assert port_cmds == jax_cmds - QUEUED
    assert len(port_cmds) == 150 == len(jax_cmds) and NEW | UTIL <= port_cmds


def test_device_flag_only_where_the_command_aligns():
    parsers = subparsers(cli.main)
    for name in NEW | UTIL:
        dev = [a for a in parsers[name]._actions if a.dest == "device"]
        if name in ALIGNING:
            assert dev and dev[0].default == "cuda", name
        else:
            assert not dev, name


def test_new_commands_take_the_jax_clis_flags():
    """Each new command's options and positionals are the JAX CLI's, plus
    --device where it aligns."""
    jax_parsers, parsers = subparsers(jax_cli.main), subparsers(cli.main)
    for name in NEW | UTIL:
        want = [(a.dest, tuple(a.option_strings), a.default, a.nargs)
                for a in jax_parsers[name]._actions]
        have = [(a.dest, tuple(a.option_strings), a.default, a.nargs)
                for a in parsers[name]._actions if a.dest != "device"]
        assert have == want, name


@pytest.mark.parametrize("name", ["easy-predict", "mergepredictions"])
def test_multiprocess_commands_take_the_jax_clis_flags(name):
    """easy-predict (with --contig-split) and mergepredictions take the JAX
    CLI's options and positionals, plus easy-predict's --device (default
    cuda); mergepredictions is host-only."""
    jax_parsers, parsers = subparsers(jax_cli.main), subparsers(cli.main)
    want = [(a.dest, tuple(a.option_strings), a.default, a.nargs)
            for a in jax_parsers[name]._actions]
    have = [(a.dest, tuple(a.option_strings), a.default, a.nargs)
            for a in parsers[name]._actions if a.dest != "device"]
    assert have == want
    assert "contig_split" in {a.dest for a in parsers[name]._actions} or \
        name == "mergepredictions"
    dev = [a.default for a in parsers[name]._actions if a.dest == "device"]
    assert dev == (["cuda"] if name == "easy-predict" else [])


def test_aligning_commands_raise_without_a_card(tmp_path, monkeypatch):
    """--device cuda (the default) with no CUDA device raises: nothing falls
    back to the plain versions."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["multihitsearch", "q", "t", str(tmp_path / "o"),
                  str(tmp_path / "tmp")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["gpuserver", "t", "--socket", str(tmp_path / "s")])
    assert not (tmp_path / "s").exists()


def test_chip_smoke_db_cli_on_cpu(tmp_path):
    """chip_smoke.py's phase 4i (check_db_cli) on the CPU: every golden of
    every case, and multihitsearch through the plain versions."""
    rec = {}

    @contextlib.contextmanager
    def probe():
        sw_cuda.reset_counts()
        yield rec
        rec.update(launches=dict(sw_cuda.LAUNCHES),
                   plain=dict(sw_cuda.PLAIN_CALLS))
    n, got = chip_smoke.check_db_cli(cli, "cpu", tmp_path, probe)
    assert got is rec
    assert n == sum(len(c["goldens"]) for c in
                    chip_smoke.DB_CLI_CASES.values()) > 100
    assert rec["plain"]["sw_pair_ends"] > 0 and \
        rec["plain"]["sw_pair_starts"] > 0
    assert not any(rec["launches"].values())


def test_chip_smoke_util_cli_on_cpu(tmp_path):
    """chip_smoke.py's phase 4j (check_db_cli over UTIL_CLI_CASES) on the
    CPU: every golden of every case."""
    n, _ = chip_smoke.check_db_cli(cli, "cpu", tmp_path,
                                   cases=chip_smoke.UTIL_CLI_CASES,
                                   fixture=chip_smoke.util_cli_fixture)
    assert n == sum(len(c["goldens"]) for c in
                    chip_smoke.UTIL_CLI_CASES.values()) > 80
