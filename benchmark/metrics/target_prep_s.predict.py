"""Seconds a completed job spends in the program's spans that rebuild
target-side state (metaeuk_tpu_torch/utils/trace.py): the target DB parsed
(load_targets), encoded for the prefilter (prefilter_init) and for the
aligner (driver_init), the aligner's session lookup (driver_lookup) and its
lazy target staging on the device (align.target_stage). The union of their
intervals inside the job, so a span nested in another counts once; None
where the program records no spans."""

PREP = ("load_targets", "prefilter_init", "driver_lookup", "driver_init",
        "align.target_stage")


def program_spans():
    """The program's closed spans (on time.perf_counter), or None where the
    program has no span recorder."""
    try:
        from metaeuk_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.spans()


def merged(spans, names, lo, hi):
    """The union of the intervals of the spans named in `names`, clipped to
    [lo, hi]: sorted, disjoint (start, end) pairs."""
    out = []
    for a, b in sorted((max(s.t0, lo), min(s.t1, hi)) for s in spans
                       if s.name in names and s.t1 > lo and s.t0 < hi):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(run):
    spans = program_spans()
    if spans is None:
        return None
    return run.per_job(lambda j: sum(
        b - a for a, b in merged(spans, PREP, run.jobs[j]["t0"],
                                 run.jobs[j]["t1"])))
