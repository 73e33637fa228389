"""The generator repeats per seed, and seeds change the sequences but not
the sizes of a job."""

import json
import pathlib

import numpy as np
import pytest

from benchmark import gen

HERE = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(json.loads((HERE / "configs" / "search_gpu.json").read_text()),
           n_targets=2000)
SEED = 3_000_000_123


def wl(cell):
    return json.loads((HERE / "workloads" / f"{cell}.json").read_text())


def test_targets_repeat_and_follow_the_model():
    a, b = gen.targets(SEED, CFG), gen.targets(SEED, CFG)
    assert np.array_equal(a.codes, b.codes)
    assert np.array_equal(a.offsets, b.offsets)
    assert a.n_implant == 600
    assert abs(a.lengths.mean() / 360 - 1) < 0.05
    freq = np.bincount(a.codes, minlength=20) / len(a.codes)
    comp = np.array(CFG["target_db"]["composition"])
    assert np.abs(freq - comp / comp.sum()).max() < 0.003
    other = gen.targets(SEED + 1, CFG)
    assert not np.array_equal(other.codes[:1000], a.codes[:1000])
    # the same lengths in another order, but for the family members,
    # which take their sources' lengths
    assert abs(int(a.lengths.sum()) / int(other.lengths.sum()) - 1) < 0.03


def test_lognormal_lengths_keep_the_stated_shape():
    lens = gen.lognormal_lengths(100_000, 360, 0.7)
    assert np.all(np.diff(lens) >= 0)
    assert abs(lens.mean() / 360 - 1) < 0.005
    assert 0.05 < np.mean(lens < 100) < 0.09
    assert 0.025 < np.mean(lens > 1000) < 0.045
    assert lens[0] >= 10 and 5000 < lens[-1] < 7000


def test_by_length_draws_each_stratum_once():
    rng = np.random.default_rng(1)
    lens = gen.lognormal_lengths(1000, 360, 0.7)
    pick = gen.by_length(rng, lens, 10, 800)
    assert len(set(pick.tolist())) == 10
    assert lens[pick].max() <= 800
    ok = np.sort(lens[lens <= 800])
    got = np.sort(lens[pick])
    for k in range(10):
        lo, hi = (k * len(ok)) // 10, ((k + 1) * len(ok)) // 10
        assert ok[lo] <= got[k] <= ok[hi - 1]


@pytest.mark.parametrize("cell", ["search_gpu.db100k",
                                  "search_gpu.long_queries"])
def test_queries_repeat(cell):
    tdb = gen.targets(SEED, CFG)
    w = dict(wl(cell), queries=40)
    a = gen.queries(SEED, 3, tdb, w)
    assert a == gen.queries(SEED, 3, tdb, w)
    assert a != gen.queries(SEED, 4, tdb, w)
    assert len(a) == 40
    assert sum(n.startswith("j3decoy") for n, _ in a) == 10
    lens = sorted(len(s) for _, s in a)
    other = sorted(len(s) for _, s in gen.queries(SEED + 9, 3, tdb, w))
    if w["kind"] == "chained":
        assert lens == other
        assert lens[0] >= 1100 and lens[-1] < 4000
    else:
        assert lens[-1] <= w["max_len"]
        assert abs(sum(lens) / sum(other) - 1) < 0.1


def test_contigs_repeat_with_the_same_sizes():
    tdb = gen.targets(SEED, CFG)
    w = dict(wl("predict_gpu.db100k"), contigs=6)
    a = gen.contigs(SEED, 0, tdb, w)
    assert a == gen.contigs(SEED, 0, tdb, w)
    b = gen.contigs(SEED + 1, 0, tdb, w)
    assert sorted(len(s) for _, s in a) == sorted(len(s) for _, s in b)
    assert a != b
    assert set(b"".join(s for _, s in a)) <= set(b"ACGT")
