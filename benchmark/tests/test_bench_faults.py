"""The comparison fails what it has to fail: a run on the CPU at a tiny
size, past the harness's look for a card, with the timed path broken
underneath, and the control (the reference at int8 in the program's
place). A sound run of the same size comes out correct."""

import numpy as np
import pytest

from benchmark import control, run as harness

SMALL = {"cfg": {"n_targets": 400},
         "wl": dict(queries=24, pool=1, warm=4, check=6)}
CELL = "search_gpu.db100k"
SEED = 2_718_281_828_459


def _run(faults=()):
    return harness.run_cell(CELL, SEED, 0.1, 0, device="cpu",
                            overrides=SMALL, faults=faults)


def _patch(run, owner, attr, change):
    """Replace owner.attr, a function the timed path calls under the
    harness's spans, by its result passed through change."""
    inner = getattr(owner, attr)

    def broken(*args, **kwargs):
        return change(inner(*args, **kwargs))
    setattr(owner, attr, broken)
    run.rec._undo.insert(0, (owner, attr, inner))


def drop_half_the_queries(run):
    from metaeuk_tpu_torch.search import driver

    def change(hits):
        return hits[hits["orf_idx"] % 2 == 0]
    _patch(run, driver.SearchDriver, "_filter_and_sort", change)


def alter_a_score(run):
    from metaeuk_tpu_torch.search import driver

    def change(hits):
        # every query's first hit, where the aligner makes it
        hits = hits.copy()
        first = np.flatnonzero(np.diff(hits["orf_idx"], prepend=-1))
        hits["bit_score"][first] += 1
        return hits
    _patch(run, driver.SearchDriver, "_filter_and_sort", change)


def alter_a_candidate(run):
    from metaeuk_tpu_torch.ops import ungapped_cuda

    def change(scores):
        # one target's gapless score, where K7 makes it
        scores = scores.clone()
        scores[:, 0] += 40
        return scores
    _patch(run, ungapped_cuda, "gapless_scores_cross", change)


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["metrics"]["queries_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", [drop_half_the_queries, alter_a_score,
                                   alter_a_candidate])
def test_fault_is_caught(fault):
    res = _run(faults=[fault])
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_control_fails():
    nums = control.control(CELL, SEED, device="cpu",
                           overrides={"cfg": {"n_targets": 400},
                                      "wl": dict(queries=24, check=12)},
                           n_jobs=2)
    assert any(v > lim for v, lim in nums.values()), nums


def test_no_jax_in_the_run():
    _run()
    assert harness.forbidden_modules() == []


PREDICT = "predict_gpu.db100k"
PREDICT_SMALL = {"cfg": {"n_targets": 150},
                 "wl": dict(contigs=1, contig_len=[3000, 3001], pool=1,
                            warm=1)}


@pytest.mark.parametrize("fault", [None, drop_half_the_queries,
                                   alter_a_score, alter_a_candidate])
def test_predict_cell_faults(fault):
    res = harness.run_cell(PREDICT, SEED, 0.1, 0, device="cpu",
                           overrides=PREDICT_SMALL,
                           faults=[fault] if fault else [])
    assert res["correct"] == (fault is None), res["checks"]
