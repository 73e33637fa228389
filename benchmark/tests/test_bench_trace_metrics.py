"""The readers of the program's spans, target_prep_s.* and align_idle_s.*,
on a fake run: jobs on time.perf_counter, a profile of the window on the
profiler's clock, and the program's spans monkeypatched in."""

import sys
import types

import pytest
import torch

from benchmark import run as harness
from benchmark import yardstick
from metaeuk_tpu_torch import utils
from metaeuk_tpu_torch.utils import trace

US = 1e6
# the profiler's clock runs this far behind time.perf_counter
OFFSET = 1000.0


class _Ev:
    def __init__(self, name, t0, t1, dev):
        self.name = name
        self.time_range = types.SimpleNamespace(start=t0 * US, end=t1 * US)
        self.device_type = (torch.autograd.DeviceType.CUDA if dev
                            else torch.autograd.DeviceType.CPU)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


class _Run:
    per_job = harness.Run.per_job

    def __init__(self, jobs, prof):
        self.jobs = {j: dict(t0=a, t1=b) for j, (a, b) in enumerate(jobs)}
        self.done = sorted(self.jobs)
        self.rec = types.SimpleNamespace(
            spans=[(j, "job", a, b) for j, (a, b) in enumerate(jobs)])
        self.prof = prof


def _span(name, t0, t1, span_id=0, parent_id=0):
    return types.SimpleNamespace(name=name, t0=t0, t1=t1, span_id=span_id,
                                 parent_id=parent_id)


def _search(t0, t1, span_id):
    """SearchDriver.search's align span, with its align.query_stage."""
    return [_span("align", t0, t1, span_id),
            _span("align.query_stage", t0, t0 + 0.01, span_id + 1, span_id)]


def _run(jitter=(0.0, 0.0, 0.0)):
    """Three jobs of 10 s from perf_counter 1000; on the profiler's clock
    each starts `jitter` late. Job 0 runs the device over [1, 2] and
    [4, 5], jobs 1 and 2 over their first and last second."""
    jobs = [(OFFSET + 10 * j, OFFSET + 10 * j + 9) for j in range(3)]
    ev = [_Ev("bench.job", a - OFFSET + d, b - OFFSET + d, False)
          for (a, b), d in zip(jobs, jitter)]
    ev += [_Ev("gapless_rows", 1, 2, True), _Ev("sw_pair_ends", 4, 5, True)]
    for j in (1, 2):
        ev += [_Ev("k", 10 * j, 10 * j + 1, True),
               _Ev("k", 10 * j + 8, 10 * j + 9, True)]
    return _Run(jobs, yardstick.Trace(_Prof(ev)))


@pytest.fixture
def spans(monkeypatch):
    """Sets the program's spans the readers find."""
    def put(items):
        monkeypatch.setattr(trace, "spans", lambda: list(items))
    return put


def test_clock_offset_from_the_job_ranges():
    reader = harness.load_metric("align_idle_s.predict")
    assert reader.clock_offset(_run()) == pytest.approx(-OFFSET)
    # one job's range late by 2 ms on the profiler's clock: the median holds
    run = _run(jitter=(0.0, 0.002, 0.0))
    assert reader.clock_offset(run) == pytest.approx(-OFFSET)


@pytest.mark.parametrize("cell", ["predict", "search"])
def test_an_idle_gap_split_across_two_align_spans(spans, cell):
    # job 0's gap [2, 4] lies 0.5 s in one align span, 0.5 s in the next,
    # 1 s between them; jobs 1 and 2 have no aligner span
    spans([*_search(OFFSET + 1.0, OFFSET + 2.5, 10),
           _span("prep", OFFSET + 1.1, OFFSET + 1.2, 12, 10),
           *_search(OFFSET + 3.5, OFFSET + 4.5, 20),
           _span("prefilter", OFFSET + 2.5, OFFSET + 3.5),
           *_search(OFFSET - 5.0, OFFSET - 1.0, 30)])
    got = harness.load_metric(f"align_idle_s.{cell}").read(_run())
    assert got == pytest.approx(1.0 / 3)


def test_an_align_stage_counts_only_its_search(spans):
    # easy-predict's align stage over all of job 0, its one search over
    # [3.5, 4.5]: the gap [2, 4] counts 0.5 s, not 2 s
    spans([_span("align", OFFSET + 0.5, OFFSET + 8.0, 1),
           *_search(OFFSET + 3.5, OFFSET + 4.5, 2)])
    got = harness.load_metric("align_idle_s.predict").read(_run())
    assert got == pytest.approx(0.5 / 3)


def test_idle_inside_backtraces_and_realign(spans):
    # job 1 is idle over [11, 18]: backtraces [12, 13], realign [14, 16]
    # with its two halves nested, counted once
    spans([_span("backtraces", OFFSET + 12, OFFSET + 13),
           _span("realign_sw", OFFSET + 14, OFFSET + 15),
           _span("realign_traceback", OFFSET + 15, OFFSET + 16),
           *_search(OFFSET + 14, OFFSET + 16, 5)])
    got = harness.load_metric("align_idle_s.search").read(_run())
    assert got == pytest.approx(3.0 / 3)


@pytest.mark.parametrize("cell", ["predict", "search"])
def test_nested_prep_spans_count_once(spans, cell):
    t = OFFSET
    spans([_span("load_targets", t + 0.1, t + 0.5),
           _span("driver_lookup", t + 0.6, t + 1.2),
           _span("driver_init", t + 0.7, t + 1.1),
           _span("align.target_stage", t + 2.0, t + 2.2),
           _span("prefilter_init", t + 10.0, t + 10.3),
           _span("align", t + 1.9, t + 3.0),
           # before the window: the warm job's
           _span("driver_init", t - 3.0, t - 1.0)])
    got = harness.load_metric(f"target_prep_s.{cell}").read(_run())
    assert got == pytest.approx((0.4 + 0.6 + 0.2 + 0.3) / 3)


def test_without_a_trace_or_spans(spans, monkeypatch):
    spans([_span("align", OFFSET + 1.0, OFFSET + 5.0),
           _span("load_targets", OFFSET, OFFSET + 0.3)])
    run = _run()
    run.prof = None
    assert harness.load_metric("align_idle_s.predict").read(run) is None
    assert harness.load_metric("target_prep_s.predict").read(run) == \
        pytest.approx(0.1)
    # a program without the span recorder, as before it had one
    monkeypatch.setitem(sys.modules, "metaeuk_tpu_torch.utils.trace", None)
    monkeypatch.delattr(utils, "trace")
    for name in ("align_idle_s.search", "target_prep_s.search"):
        assert harness.load_metric(name).read(_run()) is None
