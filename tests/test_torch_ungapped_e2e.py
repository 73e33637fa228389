"""The port's easy-predict --prefilter-mode ungapped (alignment and gapless
scores on device "cpu", the kernels' plain versions) against the JAX
package: the four outputs byte-identical to metaeuk_tpu's, live and through
the digests of tests/golden/ungapped_slice.json (which
tests/golden/make_ungapped_slice.py made from metaeuk_tpu)."""

import hashlib
import json
import pathlib

import pytest

from metaeuk_tpu.params import Params as JaxParams
from metaeuk_tpu.pipeline.predict import EasyPredict as JaxEasyPredict
from metaeuk_tpu_torch import cli
from metaeuk_tpu_torch.ops import sw_cuda, ungapped_cuda
from metaeuk_tpu_torch.params import Params
from metaeuk_tpu_torch.pipeline.predict import EasyPredict
from metaeuk_tpu_torch.search import driver

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

DATA = pathlib.Path(__file__).parent / "data"
GOLDEN = json.loads((pathlib.Path(__file__).parent / "golden"
                     / "ungapped_slice.json").read_text())
SUFFIXES = ("fas", "codon.fas", "headersMap.tsv", "gff")


def _digests(prefix):
    return {s: hashlib.sha256(pathlib.Path(f"{prefix}.{s}").read_bytes())
            .hexdigest() for s in SUFFIXES}


def _run(out, tmp_dir=None):
    EasyPredict(Params(prefilter_mode="ungapped"), device="cpu").run(
        DATA / "contigs.fna", DATA / "proteins.faa", str(out),
        tmp_dir=tmp_dir)
    return out


def test_golden_file_names_its_command_and_inputs():
    assert GOLDEN["command"] == "python3 tests/golden/make_ungapped_slice.py"
    assert GOLDEN["params"] == {"prefilter_mode": "ungapped"}
    assert GOLDEN["metagenome"]["mbp"] == 0.01
    assert GOLDEN["metagenome"]["targets"] == 500


def test_ungapped_easypredict_matches_jax_digests(tmp_path):
    ungapped_cuda.reset_counts()
    out = _run(tmp_path / "preds")
    assert _digests(out) == GOLDEN["fixture"]["sha256"]
    assert ungapped_cuda.PLAIN_CALLS["gapless_rows"] > 0


def test_ungapped_easypredict_matches_jax_live(tmp_path):
    JaxEasyPredict(JaxParams(prefilter_mode="ungapped")).run(
        DATA / "contigs.fna", DATA / "proteins.faa", str(tmp_path / "jax"))
    _run(tmp_path / "torch")
    assert pathlib.Path(f"{tmp_path}/jax.gff").stat().st_size > 0
    for s in SUFFIXES:
        assert (tmp_path / f"torch.{s}").read_bytes() \
            == (tmp_path / f"jax.{s}").read_bytes(), s


def test_ungapped_through_the_query_major_path(tmp_path, monkeypatch):
    """With METAEUK_QM=force and QM_MIN_CANDS=1 every candidate pair aligns
    query-major; the outputs stay the JAX package's."""
    monkeypatch.setenv("METAEUK_QM", "force")
    monkeypatch.setattr(driver, "QM_MIN_CANDS", 1)
    sw_cuda.reset_counts()
    out = _run(tmp_path / "preds")
    assert sw_cuda.PLAIN_CALLS["sw_qm_ends"] > 0
    assert sw_cuda.PLAIN_CALLS["sw_pair_ends"] == 0
    assert _digests(out) == GOLDEN["fixture"]["sha256"]


def test_ungapped_cli_on_cpu(tmp_path, capsys):
    out = tmp_path / "preds"
    assert cli.main(["easy-predict", str(DATA / "contigs.fna"),
                     str(DATA / "proteins.faa"), str(out), "--device", "cpu",
                     "--prefilter-mode", "ungapped"]) == 0
    assert "wrote" in capsys.readouterr().out
    assert _digests(out) == GOLDEN["fixture"]["sha256"]


@pytest.mark.parametrize("resume", ["pref_pairs", "search_hits"])
def test_ungapped_checkpoints_resume_to_the_same_bytes(tmp_path, capfd,
                                                       resume):
    """The pref_pairs.npy and search_hits.npy checkpoints are written, and a
    run that finds one resumes from it to the same outputs."""
    tmp = tmp_path / "tmp"
    _run(tmp_path / "first", tmp_dir=str(tmp))
    assert (tmp / "pref_pairs.npy").exists()
    assert (tmp / "search_hits.npy").exists()
    (tmp / "dp_predictions").unlink()
    (tmp / "dp_predictions.index").unlink()
    (tmp / "dp_predictions.dbtype").unlink()
    if resume == "pref_pairs":
        (tmp / "search_hits.npy").unlink()
    capfd.readouterr()
    ungapped_cuda.reset_counts()
    _run(tmp_path / "resumed", tmp_dir=str(tmp))
    assert f"resumed {tmp / (resume + '.npy')}" in capfd.readouterr().err
    assert not any(ungapped_cuda.PLAIN_CALLS.values())
    assert _digests(tmp_path / "resumed") == GOLDEN["fixture"]["sha256"]
