"""The port's bench (metaeuk_tpu_torch/tools/bench.py, `metaeuk-tpu-torch
bench`) against the JAX package's root bench.py, on the CPU.

- Its main run at 0.01 Mbp / 300 targets / one timed run prints one JSON
  line with the JAX bench's keys, the generator's contig count and the JAX
  bench's aligned cells, and its four outputs are byte-equal to those of
  the JAX bench's EasyPredict on the same inputs.
- Its light selftest (the plain versions on the CPU) draws the JAX bench's
  pairs and gives its (fails, checks). The JAX side runs with its Pallas
  entry points patched in this test only: the pair kernels to interpret
  mode, the query-major ones (too slow there) to a recorder that aligns the
  staged pairs with sw_jax.sw_align_batch.
- `--device cuda` with no card raises before any work; a selftest mismatch,
  injected through a patched wrapper, ends the run non-zero.

The tolerance is exact equality.
"""

import functools
import importlib
import json
import pathlib
import sys
import tempfile

import numpy as np
import pytest
import torch

from metaeuk_tpu.ops import sw_jax, sw_pallas
from metaeuk_tpu_torch import cli
from metaeuk_tpu_torch.ops import sw_cuda
from metaeuk_tpu_torch.tools import bench

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
SUFFIXES = ("fas", "codon.fas", "headersMap.tsv", "gff")
SMALL = dict(METAEUK_BENCH_MBP="0.01", METAEUK_BENCH_TARGETS="300",
             METAEUK_BENCH_RUNS="1")


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _keys(rec):
    """The line's keys: the top level's, extra's and config's."""
    return (sorted(rec), sorted(rec["extra"]), sorted(rec["extra"]["config"]))


@pytest.fixture
def small_bench(monkeypatch, tmp_path):
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def _outputs(root):
    (run,) = root.glob("meukbench*")
    return {s: (run / f"ours.{s}").read_bytes() for s in SUFFIXES}


def test_main_line_and_outputs_equal_the_jax_benchs(small_bench, monkeypatch,
                                                    capsys):
    from tools.make_metagenome import make_metagenome
    mine, theirs = small_bench / "port", small_bench / "jax"
    mine.mkdir()
    theirs.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(mine))
    assert bench.main(["--device", "cpu", "--no-ref", "--no-selftest"]) == 0
    (rec,) = _json_lines(capsys.readouterr().out)

    # the JAX bench reads its knobs at import, and its kernel rates fail
    # on the CPU (no interpret mode there), which it reports and passes
    jax_bench = importlib.reload(importlib.import_module("bench"))
    monkeypatch.setattr(tempfile, "tempdir", str(theirs))
    monkeypatch.setattr(sys, "argv", ["bench.py", "--no-ref",
                                      "--no-selftest"])
    jax_bench.main()
    (want,) = _json_lines(capsys.readouterr().out)

    assert _keys(rec) == _keys(want)
    assert rec["metric"] == "easy_predict_contigs_per_s" and rec["value"] > 0
    n = len(make_metagenome(0.01, 300)[0])
    assert rec["extra"]["config"] == want["extra"]["config"] == {
        "mbp": 0.01, "targets": 300, "contigs": n}
    assert rec["extra"]["aligned_cells"] == want["extra"]["aligned_cells"]
    assert rec["extra"]["aligned_cells"]["fwd"] > 0
    assert len(rec["extra"]["ours_walls_s"]) == 1
    assert rec["extra"]["selftest"] == {"fails": None, "checks": None}
    # no device time on the CPU
    assert rec["extra"]["sw_kernel_cells_per_s"] is None
    assert rec["extra"]["sw_kernel_qm_cells_per_s"] == {"fwd": None,
                                                        "full": None}
    got, ref = _outputs(mine), _outputs(theirs)
    assert ref["gff"]
    for s in SUFFIXES:
        assert got[s] == ref[s], s


def _recorded(module, name, log, monkeypatch, call=None):
    """Patches module.name to record its arguments in log[name], then call
    them (by default, the original)."""
    orig = getattr(module, name)

    def rec(*args, **kw):
        log.setdefault(name, []).append(
            [np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
             for a in args])
        return (call or orig)(*args, **kw)
    monkeypatch.setattr(module, name, rec)


def _sw_jax_qm(log):
    """_align_ends_qm / _align_starts_qm on the pairs of the last staged
    tiles (build_prof_tiles' and build_tcodes_T's recorded inputs),
    aligned by sw_jax.sw_align_batch on the live lanes."""
    def full():
        q_mat, qb_mat, q_lens, qidx, _ = log["build_prof_tiles"][-1]
        t_mat, t_lens, lj, _ = log["build_tcodes_T"][-1]
        tiles, lanes = np.nonzero(lj >= 0)
        qi, tj = qidx[tiles], lj[tiles, lanes]
        outs = sw_jax.sw_align_batch(q_mat[qi], qb_mat[qi], q_lens[qi],
                                     t_mat[tj], t_lens[tj])
        per_lane = [np.zeros(lj.size, np.int32) for _ in outs]
        for o, a in zip(per_lane, outs):
            o[tiles * lj.shape[1] + lanes] = a
        return per_lane

    def ends(prof, tc, Lq, Lt, interpret):
        sc, _, qe, _, te = full()
        return sc, qe, te

    def starts(prof, tc, qe, te, Lq, Lt, interpret):
        sc, qs, _, ts, _ = full()
        return sc, qs, ts
    return ends, starts


def test_light_selftest_draws_the_jax_benchs_pairs(monkeypatch, capsys):
    jax_bench = importlib.import_module("bench")
    jlog, plog = {}, {}
    for name in ("build_prof_tiles", "build_tcodes_T"):
        _recorded(sw_pallas, name, jlog, monkeypatch)
    ends, starts = _sw_jax_qm(jlog)
    _recorded(sw_pallas, "_align_ends_qm", jlog, monkeypatch, ends)
    _recorded(sw_pallas, "_align_starts_qm", jlog, monkeypatch, starts)
    _recorded(sw_pallas, "sw_pallas_align_batch", jlog, monkeypatch,
              functools.partial(sw_pallas.sw_pallas_align_batch,
                                interpret=True))
    want = jax_bench.selftest(light=True)
    for name in ("qm_ends", "qm_starts", "align_full"):
        _recorded(sw_cuda, name, plog, monkeypatch)
    sw_cuda.reset_counts()
    got = bench.selftest(torch.device("cpu"), light=True)
    assert got == want and want[1] == 140 and want[0] == 0
    lines = _json_lines(capsys.readouterr().out)
    assert [sorted(r) for r in lines] == [["checks", "fails", "selftest"]] * 2
    assert lines[1]["selftest"] == "sw_cuda_plain_versions_vs_oracle"

    # the same staged queries, targets and lanes, tile for tile
    assert len(plog["qm_ends"]) == len(jlog["build_prof_tiles"]) == 2
    for (q, qb, ql, t, tl, qi, lj), (jq, jqb, jql, jqi, _), \
            (jt, jtl, jlj, _) in zip(plog["qm_ends"], jlog["build_prof_tiles"],
                                     jlog["build_tcodes_T"]):
        for a, b in ((q, jq), (qb, jqb), (ql, jql), (t, jt), (tl, jtl),
                     (qi, jqi), (lj, jlj.reshape(-1))):
            assert np.array_equal(a, b)
    # the same pair batches
    assert len(plog["align_full"]) == len(jlog["sw_pallas_align_batch"]) == 2
    for mine, theirs in zip(plog["align_full"],
                            jlog["sw_pallas_align_batch"]):
        assert all(np.array_equal(a, b) for a, b in zip(mine, theirs))
    assert sw_cuda.PLAIN_CALLS["sw_pair_ends"] == 2
    assert sw_cuda.PLAIN_CALLS["sw_qm_ends"] == 2
    assert not any(sw_cuda.LAUNCHES.values())


@pytest.mark.parametrize("entry", ["bench", "cli"])
def test_cuda_device_without_a_card_raises(entry, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")

    def no_work(*args, **kw):
        raise AssertionError("the bench ran without its device")
    for name in ("make_inputs", "selftest", "run_ours"):
        monkeypatch.setattr(bench, name, no_work)
    for argv in ([], ["--selftest"], ["--device", "cuda:0", "--no-ref"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            if entry == "bench":
                bench.main(argv)
            else:
                cli.main(["bench", *argv])


# small selftest sets: a 4,100-row query row takes K5/K6's wrappers
SMALL_QM = ((64, 96, 1), (4100, 64, 1))
SMALL_PAIRS = ((64, 96, 4),)


@pytest.fixture
def small_selftest(monkeypatch):
    for name, sets in (("QM_CONFIGS", SMALL_QM), ("QM_LIGHT", SMALL_QM[:1]),
                       ("PAIR_CONFIGS", SMALL_PAIRS),
                       ("PAIR_LIGHT", SMALL_PAIRS)):
        monkeypatch.setattr(bench, name, sets)


def test_selftest_through_the_cli_routes_long_queries_to_k5_k6(
        small_selftest, capsys):
    sw_cuda.reset_counts()
    assert cli.main(["bench", "--selftest", "--device", "cpu"]) == 0
    (rec,) = _json_lines(capsys.readouterr().out)
    assert rec["fails"] == 0 and rec["checks"] > 4
    calls = sw_cuda.PLAIN_CALLS
    assert calls["sw_qm_rt_ends"] == calls["sw_qm_rt_starts"] == 1
    assert calls["sw_qm_ends"] == calls["sw_qm_starts"] == 1
    assert calls["sw_pair_ends"] == calls["sw_pair_starts"] == 1


@pytest.mark.parametrize("argv", [["--selftest"], ["--no-ref"]])
def test_selftest_mismatch_exits_nonzero(argv, small_selftest, small_bench,
                                         monkeypatch, capsys):
    orig = sw_cuda.qm_ends

    def off_by_one(*args, **kw):
        sc, qe, te = orig(*args, **kw)
        return sc + (sc > 0).to(sc.dtype), qe, te
    monkeypatch.setattr(sw_cuda, "qm_ends", off_by_one)
    assert bench.main([*argv, "--device", "cpu"]) == 1
    out, err = capsys.readouterr()
    assert "QM MISMATCH" in err
    lines = _json_lines(out)
    assert [r["selftest"] for r in lines] == [
        "sw_cuda_plain_versions_vs_oracle"]
    assert lines[0]["fails"] > 0


@pytest.mark.gpu
def test_light_selftest_on_the_card():
    """The light selftest through K1-K4 on the card: no mismatch, every
    kernel launched and no plain version called."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    sw_cuda.reset_counts()
    fails, checks = bench.selftest(torch.device("cuda"), light=True)
    assert fails == 0 and checks == 140
    assert min(sw_cuda.LAUNCHES[k] for k in (
        "sw_pair_ends", "sw_pair_starts", "sw_qm_ends", "sw_qm_starts")) > 0
    assert not any(sw_cuda.PLAIN_CALLS.values())


def _zeros(n_arg):
    """A wrapper that gives zeros, as many as its argument n_arg has rows:
    the selftest's draws without an alignment."""
    def call(*args, **kw):
        n = args[n_arg].shape[0]
        return tuple(torch.zeros(n, dtype=torch.int32)
                     for _ in range(5 if n_arg == 0 else 3))
    return call


def test_chip_smoke_pins_the_benchs_configuration_and_draws(monkeypatch):
    """chip_smoke.py phase 5o's constants: the bench's default knobs, the
    contigs of make_metagenome(4, 8000) and the checks its selftest's
    seeds draw, light and full."""
    import chip_smoke
    from tools.make_metagenome import make_metagenome
    for k in SMALL:
        monkeypatch.delenv(k, raising=False)
    assert bench.knobs() == (4.0, 8000, 3)
    for k, v in chip_smoke.BENCH_ENV.items():
        monkeypatch.setenv(k, v)
    assert bench.knobs() == (4.0, 8000, 1)
    assert len(make_metagenome(4.0, 8000)[0]) == chip_smoke.BENCH_CONTIGS
    for name in ("qm_ends", "qm_starts", "qm_ends_rt", "qm_starts_rt"):
        monkeypatch.setattr(sw_cuda, name, _zeros(6))
    monkeypatch.setattr(sw_cuda, "align_full", _zeros(0))
    cpu = torch.device("cpu")
    assert bench.selftest(cpu, light=True)[1] == \
        chip_smoke.BENCH_CHECKS["light"]
    assert bench.selftest(cpu)[1] == chip_smoke.BENCH_CHECKS["full"]


def _phase_5o_runs(golden):
    """Two runs of chip_smoke.py phase 5o that pass its checks."""
    import chip_smoke
    light = {"selftest": "sw_cuda_kernels_vs_oracle", "fails": 0,
             "checks": chip_smoke.BENCH_CHECKS["light"]}
    line = {"metric": "easy_predict_contigs_per_s", "value": 40.0,
            "extra": {"config": {"mbp": 4.0, "targets": 8000,
                                 "contigs": chip_smoke.BENCH_CONTIGS},
                      "ours_walls_s": [14.3],
                      "selftest": {"fails": 0, "checks": light["checks"]},
                      "sw_kernel_cells_per_s": 3e11,
                      "sw_kernel_qm_cells_per_s": {"fwd": 5e10,
                                                   "full": 3e10}}}
    off = dict.fromkeys(sw_cuda.KERNELS, 0)
    return {
        "bench": {"lines": [light, line], "plain": dict(off),
                  "launches": dict(off, sw_pair_ends=9, sw_pair_starts=9,
                                   sw_qm_ends=3, sw_qm_starts=3),
                  "digests": dict(golden["sha256"])},
        "selftest": {"lines": [dict(light,
                                    checks=chip_smoke.BENCH_CHECKS["full"])],
                     "plain": dict(off), "digests": None,
                     "launches": dict(off, sw_pair_ends=4, sw_pair_starts=4,
                                      sw_qm_ends=3, sw_qm_starts=3,
                                      sw_qm_rt_ends=1, sw_qm_rt_starts=1)}}


def _unlaunch(runs, k):
    for r in runs.values():
        r["launches"][k] = 0


FAULTS = {
    "light_fails": lambda r: r["bench"]["lines"][0].update(fails=1),
    "main_line_selftest": lambda r: r["bench"]["lines"][1]["extra"].update(
        selftest={"fails": None, "checks": None}),
    "full_fails": lambda r: r["selftest"]["lines"][0].update(fails=2),
    "full_checks": lambda r: r["selftest"]["lines"][0].update(checks=140),
    "contigs": lambda r: r["bench"]["lines"][1]["extra"]["config"].update(
        contigs=2),
    "rate": lambda r: r["bench"]["lines"][1]["extra"][
        "sw_kernel_qm_cells_per_s"].update(full=None),
    "k6_not_launched": lambda r: _unlaunch(r, "sw_qm_rt_starts"),
    "plain_call": lambda r: r["selftest"]["plain"].update(sw_qm_ends=1),
    "digest": lambda r: r["bench"]["digests"].update(gff="0" * 64),
}


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_chip_smoke_phase_5o_checks(fault, capsys):
    """check_bench passes two good runs and fails each fault: a selftest
    mismatch or a missing check, another configuration, a missing rate,
    a kernel of K1-K6 not launched, a plain call, other digests."""
    import chip_smoke
    golden = json.loads((ROOT / "tests" / "golden" /
                         "dist_bench_slice.json").read_text())
    runs = _phase_5o_runs(golden)
    if fault is None:
        chip_smoke.check_bench(runs, golden)
        assert "equal dist_bench_slice.json" in capsys.readouterr().out
        return
    FAULTS[fault](runs)
    with pytest.raises(AssertionError):
        chip_smoke.check_bench(runs, golden)
