"""Seconds a job spends outside the prefilter and the aligner: for
easy-predict its StageTimer's load, fragment extraction, collectoptimalset,
reduce and write stages; for search the spans around loading the inputs
and writing the alignment DB."""


def read(run):
    return run.per_job(lambda j: run.entry.host_stage_s(run, j))
