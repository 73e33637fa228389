"""The port's easy-predict (alignment on device "cpu", the kernels' plain
versions) against the committed goldens and against metaeuk_tpu: outputs
byte-identical."""

import pathlib
import sys

import pytest
import torch

from metaeuk_tpu.params import Params
from metaeuk_tpu_torch import cli
from metaeuk_tpu_torch.pipeline.predict import EasyPredict

from test_e2e_variants import VARIANTS
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

DATA = pathlib.Path(__file__).parent / "data"
GOLDEN = pathlib.Path(__file__).parent / "golden"
SUFFIXES = ("fas", "codon.fas", "headersMap.tsv", "gff")


def _run(out, params=None):
    EasyPredict(params or Params(), device="cpu").run(
        DATA / "contigs.fna", DATA / "proteins.faa", str(out))
    return out


def _assert_golden(out, name="easypredict"):
    for s in SUFFIXES:
        assert pathlib.Path(f"{out}.{s}").read_bytes() \
            == (GOLDEN / f"{name}.{s}").read_bytes(), f"{name}.{s}"


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("torch_e2e") / "preds")


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_easypredict_byte_parity(outputs, suffix):
    assert pathlib.Path(f"{outputs}.{suffix}").read_bytes() \
        == (GOLDEN / f"easypredict.{suffix}").read_bytes()


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_byte_parity(name, tmp_path):
    _assert_golden(_run(tmp_path / "preds", Params(**VARIANTS[name])), name)


def test_easypredict_fine_tiers_parity(tmp_path, monkeypatch):
    import metaeuk_tpu_torch.search.driver as drv
    monkeypatch.setattr(drv, "FINE_TIER_MIN_FRAGS", 1)
    _assert_golden(_run(tmp_path / "preds"))


def test_easypredict_pipelined_batches_parity(tmp_path, monkeypatch, capfd):
    monkeypatch.setenv("METAEUK_PIPELINE_BATCHES", "3")
    _assert_golden(_run(tmp_path / "preds"))
    assert "pipelined batches" in capfd.readouterr().err


def test_cli_easy_predict_on_cpu(tmp_path, capsys):
    out = tmp_path / "preds"
    assert cli.main(["easy-predict", str(DATA / "contigs.fna"),
                     str(DATA / "proteins.faa"), str(out),
                     "--device", "cpu"]) == 0
    assert "wrote" in capsys.readouterr().out
    _assert_golden(out)


def test_cli_cuda_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["easy-predict", str(DATA / "contigs.fna"),
                  str(DATA / "proteins.faa"), str(tmp_path / "p")])


def test_easypredict_matches_jax_on_metagenome(tmp_path):
    """A 50 kbp / 200-target synthetic metagenome: the port's four outputs
    equal the JAX package's."""
    from metaeuk_tpu.pipeline.predict import EasyPredict as JaxEasyPredict
    sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
    from tools.make_metagenome import make_metagenome, write_fasta
    contigs, proteins = make_metagenome(0.05, 200)
    write_fasta(tmp_path / "c.fna", contigs)
    write_fasta(tmp_path / "p.faa", proteins)
    JaxEasyPredict(Params()).run(str(tmp_path / "c.fna"),
                                 str(tmp_path / "p.faa"),
                                 str(tmp_path / "jax"))
    ep = EasyPredict(Params(), device="cpu")
    ep.run(str(tmp_path / "c.fna"), str(tmp_path / "p.faa"),
           str(tmp_path / "torch"))
    assert pathlib.Path(f"{tmp_path}/jax.gff").stat().st_size > 0
    for s in SUFFIXES:
        assert (tmp_path / f"torch.{s}").read_bytes() \
            == (tmp_path / f"jax.{s}").read_bytes(), s
    assert "align" in ep.predict_stage_seconds


def test_exhaustive_prefilter_mode_matches_jax(tmp_path):
    from metaeuk_tpu.pipeline.predict import EasyPredict as JaxEasyPredict
    p = Params(prefilter_mode="exhaustive")
    JaxEasyPredict(p).run(DATA / "contigs.fna", DATA / "proteins.faa",
                          str(tmp_path / "jax"))
    _run(tmp_path / "torch", Params(prefilter_mode="exhaustive"))
    for s in SUFFIXES:
        assert (tmp_path / f"torch.{s}").read_bytes() \
            == (tmp_path / f"jax.{s}").read_bytes(), s


def test_checkpointed_run_resumes_to_the_same_bytes(tmp_path, capfd):
    tmp = tmp_path / "tmp"
    for name in ("first", "resumed"):
        EasyPredict(Params(), device="cpu").run(
            DATA / "contigs.fna", DATA / "proteins.faa",
            str(tmp_path / name), tmp_dir=str(tmp))
        _assert_golden(tmp_path / name)
    assert "resumed" in capfd.readouterr().err
