"""Seconds a completed job has the device idle inside the program's aligner
spans (align, realign_sw, realign_traceback, backtraces of
metaeuk_tpu_torch/utils/trace.py). Of the spans named align, only
SearchDriver.search's count, the parents of an align.query_stage span:
easy-predict's stage of the same name is left out. The trace's idle gaps
are on the profiler's clock and the spans on time.perf_counter: each
window job is a span of the benchmark on both (run.rec.spans,
run.prof.host), and the median of their start differences moves the gaps
onto the spans' clock. None without a trace, or where the program records
no spans."""

import statistics

from benchmark.run import load_metric

ALIGN = ("align", "realign_sw", "realign_traceback", "backtraces")

_prep = load_metric("target_prep_s.predict")


def clock_offset(run):
    """Profiler seconds minus perf_counter seconds, from the job spans."""
    rec = sorted(t0 for _, name, t0, _ in run.rec.spans if name == "job")
    prof = sorted(t0 for name, t0, _ in run.prof.host if name == "job")
    return statistics.median(p - r for p, r in zip(prof, rec))


def aligner_spans(spans):
    """The spans of ALIGN, SearchDriver.search's align among those named
    align."""
    searches = {s.parent_id for s in spans if s.name == "align.query_stage"}
    return [s for s in spans if s.name in ALIGN
            and (s.name != "align" or s.span_id in searches)]


def idle_in(gaps, intervals):
    """Seconds where the disjoint `gaps` meet the disjoint `intervals`."""
    return sum(max(0.0, min(b, d) - max(a, c))
               for a, b in gaps for c, d in intervals
               if b > c and a < d)


def read(run):
    if run.prof is None:
        return None
    spans = _prep.program_spans()
    if spans is None:
        return None
    spans = aligner_spans(spans)
    off = clock_offset(run)
    gaps = [(a - off, b - off) for a, b in run.prof.busy()[1]]

    def job_idle(j):
        lo, hi = run.jobs[j]["t0"], run.jobs[j]["t1"]
        return idle_in([g for g in gaps if g[1] > lo and g[0] < hi],
                       _prep.merged(spans, ALIGN, lo, hi))

    return run.per_job(job_idle)
