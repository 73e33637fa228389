"""The runtime Gumbel fit (search/gumbel.py) of the port against the JAX
package's, on the CPU.

For the four scoring systems of tests/golden/make_gumbel_slice.py (BLOSUM62
at 8/2, VTML80 at bit factor 2 at 10/1, proteinaln2nucl's +2/-3 nucleotide
matrix at 4/2, and the ungapped fit of VTML80 at 32000/0) at a small size,
and for one at length 384 (the length class whose uncapped K1/K2 instances
run on a card): _simulate's arrays and fit_gapped's 12 parameters are equal
to the JAX package's (XLA on the CPU), with zero tolerance. for_scoring's
E-values at non-default gapped and ungapped scoring, and proteinaln2nucl at
4/2, equal the JAX package's, with both packages' fits at the same small
size and their caches in a fresh directory. fit_gapped on a CUDA device
with no card raises. chip_smoke.py's phase 5k, rehearsed on the CPU at the
small size against the JAX package's fits. No test reads a matrix file
outside the repository.
"""

import functools
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from metaeuk_tpu.data import submat as jax_submat
from metaeuk_tpu.data import vtml80 as jax_vtml80
from metaeuk_tpu.pipeline import offsetaln as jax_offsetaln
from metaeuk_tpu.search import evalue as jax_evalue
from metaeuk_tpu.search import gumbel as jax_gumbel
from metaeuk_tpu_torch import cli
from metaeuk_tpu_torch.data import submat, vtml80
from metaeuk_tpu_torch.pipeline import offsetaln
from metaeuk_tpu_torch.search import evalue, gumbel

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden"
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(GOLDEN))
import chip_smoke  # noqa: E402
import make_gumbel_slice as mgs  # noqa: E402

SMALL = dict(n_pairs=512, length=128, chunk=256, isl_pairs=256,
             isl_length=256)
# one fit at length 384, fit_gapped's default length
AT_384 = dict(SMALL, n_pairs=256, length=384, chunk=128)


def systems(name):
    """(the JAX package's, the port's) scoring system of a name."""
    return (mgs.scoring_system(name, jax_submat, jax_vtml80),
            mgs.scoring_system(name, submat, vtml80))


@pytest.fixture
def fresh_caches(tmp_path, monkeypatch):
    """Both packages' fit caches in tmp_path, their in-process caches
    empty, and both fits at SMALL's size."""
    for mod, tag in ((jax_gumbel, "jax"), (gumbel, "port")):
        monkeypatch.setattr(mod, "_FIT_CACHE_PATH",
                            str(tmp_path / f"{tag}_cache.json"))
        monkeypatch.setattr(mod, "_mem_cache", {})
        monkeypatch.setattr(mod, "fit_gapped",
                            functools.partial(mod.fit_gapped, **SMALL))
    return tmp_path


@pytest.mark.parametrize("name,kw", [
    *[(s, SMALL) for s in mgs.GUMBEL_SYSTEMS], ("blosum62_8_2", AT_384)])
def test_simulate_and_fit_equal_the_jax_packages(name, kw):
    (j_sc, j_pb, go, ge), (p_sc, p_pb, p_go, p_ge) = systems(name)
    assert (go, ge) == (p_go, p_ge)
    np.testing.assert_array_equal(j_sc, p_sc)
    np.testing.assert_array_equal(j_pb, p_pb)
    sim = dict(seed=42, n_pairs=kw["n_pairs"], length=kw["length"],
               chunk=kw["chunk"])
    want = jax_gumbel._simulate(np.asarray(j_sc, np.int64), j_pb, go, ge,
                                **sim)
    got = gumbel._simulate(np.asarray(p_sc, np.int64), p_pb, go, ge,
                           device="cpu", **sim)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    assert want[0].min() > 0
    assert gumbel.fit_gapped(p_sc, p_pb, go, ge, device="cpu", **kw) == \
        jax_gumbel.fit_gapped(j_sc, j_pb, go, ge, **kw)


@pytest.mark.parametrize("name", ["vtml80_10_1", "vtml80_ungapped",
                                  "blosum62_8_2"])
def test_for_scoring_equals_the_jax_packages(fresh_caches, name):
    (j_sc, j_pb, go, ge), (p_sc, p_pb, _, _) = systems(name)
    gapped = name != "vtml80_ungapped"
    if not gapped:
        go, ge = 10, 1
    want = jax_evalue.EvalueComputation.for_scoring(1e6, j_sc, j_pb, go, ge,
                                                    gapped=gapped)
    got = evalue.EvalueComputation.for_scoring(1e6, p_sc, p_pb, go, ge,
                                               gapped=gapped, device="cpu")
    assert got.p == want.p
    assert len(gumbel._mem_cache) == 1
    scores = np.arange(0, 200, 7, dtype=np.float64)
    lens = np.full(len(scores), 150.0)
    np.testing.assert_array_equal(got.compute_evalue(scores, lens),
                                  want.compute_evalue(scores, lens))
    np.testing.assert_array_equal(got.compute_bit_score(scores),
                                  want.compute_bit_score(scores))


def test_proteinaln2nucl_at_4_2_equals_the_jax_packages(fresh_caches):
    u = GOLDEN / "utils"
    td = fresh_caches
    assert cli.main(["translatenucs", str(u / "orfs"),
                     str(td / "orfsaa")]) == 0
    for tag, fn, extra in (("jax", jax_offsetaln.proteinaln2nucl, {}),
                           ("port", offsetaln.proteinaln2nucl,
                            {"device": "cpu"})):
        fn(str(u / "orfs"), str(u / "orfs"), str(td / "orfsaa"),
           str(td / "orfsaa"), str(u / "orfself_aln"), str(td / tag),
           gap_open=4, gap_extend=2, **extra)
    for s in mgs.DB_SUFFIXES:
        assert (td / f"port{s}").read_bytes() == (td / f"jax{s}").read_bytes()
    assert len(gumbel._mem_cache) == 1 and len(jax_gumbel._mem_cache) == 1
    # the gap costs reach the fit: 4/2 scores differ from the tabulated 5/2
    assert (td / "port").read_bytes() != (u / "p2n").read_bytes()


def test_fit_on_a_cuda_device_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(gumbel, "_FIT_CACHE_PATH",
                        str(tmp_path / "cache.json"))
    monkeypatch.setattr(gumbel, "_mem_cache", {})
    sc, pb, go, ge = mgs.scoring_system("blosum62_8_2", submat, vtml80)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gumbel.fit_gapped(sc, pb, go, ge, **SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evalue.EvalueComputation.for_scoring(1e6, sc, pb, go, ge)
    assert not (tmp_path / "cache.json").exists()


def test_the_packages_keep_their_fits_apart(tmp_path):
    """Without METAEUK_GUMBEL_CACHE the two packages' default cache files
    differ (the port's carries its name); with it, both use it."""
    run = ("from metaeuk_tpu_torch.search import gumbel as p; "
           "from metaeuk_tpu.search import gumbel as j; "
           "print(p._FIT_CACHE_PATH); print(j._FIT_CACHE_PATH)")
    env = {k: v for k, v in os.environ.items()
           if k != "METAEUK_GUMBEL_CACHE"}
    for extra, want in (({}, None), ({"METAEUK_GUMBEL_CACHE": "x.json"},
                                     "x.json")):
        res = subprocess.run([sys.executable, "-c", run], cwd=ROOT,
                             capture_output=True, text=True, check=True,
                             env=dict(env, HOME=str(tmp_path), **extra))
        port, jax = res.stdout.split()
        if want:
            assert port == jax == want
        else:
            assert port == str(tmp_path / ".cache" /
                               "metaeuk_tpu_torch_gumbel.json")
            assert port != jax


def test_chip_smoke_gumbel_phase_on_cpu(tmp_path):
    """chip_smoke.py's phase 5k (check_gumbel_slice) on the CPU at SMALL's
    size, against the JAX package's fits made by make_gumbel_slice._run:
    the plain versions run and no kernel."""
    golden = {s: mgs._run(s, SMALL) for s in mgs.GUMBEL_SYSTEMS}
    recs = chip_smoke.check_gumbel_slice(
        np, torch, cli, tmp_path, "cpu", golden, SMALL)
    for name, rec in recs.items():
        assert rec["params"] == golden[name]["params"]
        assert rec["plain"]["sw_pair_ends_nocap"] > 0
        assert rec["plain"]["sw_pair_starts_nocap"] > 0
        assert not any(rec["launches"].values())
        assert rec["cells"]["fwd"] == SMALL["n_pairs"] * SMALL["length"] ** 2


def test_golden_holds_every_system_at_fit_gapped_defaults():
    """tests/golden/gumbel_slice.json, which phase 5k holds the card's fits
    to, has each system's entry at make_gumbel_slice's FIT_DEFAULTS and
    gap costs, with the fields phase 5k compares."""
    golden = json.loads((GOLDEN / "gumbel_slice.json").read_text())
    assert golden["fit_defaults"] == mgs.FIT_DEFAULTS
    assert list(golden["systems"]) == list(mgs.GUMBEL_SYSTEMS)
    for name, entry in golden["systems"].items():
        go, ge = mgs.scoring_system(name, submat, vtml80)[2:]
        assert entry["fit"] == mgs.FIT_DEFAULTS and entry["gaps"] == [go, ge]
        assert list(entry["params"]) == list(mgs.PARAM_KEYS)
        assert float(entry["params"]["lam"]) > 0 < float(
            entry["params"]["K"])
        assert len(entry["simulate_sha256"]) == 64 and entry["islands"] > 0
    assert list(golden["systems"]["nucl_4_2"]["proteinaln2nucl"]) == \
        list(mgs.DB_SUFFIXES)
