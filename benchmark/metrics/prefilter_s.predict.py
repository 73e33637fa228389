"""Seconds a job spends in UngappedPrefilter.candidate_pairs (host clock,
a span of the benchmark around the call)."""


def read(run):
    return run.per_job(lambda j: run.rec.seconds(j, "prefilter"))
