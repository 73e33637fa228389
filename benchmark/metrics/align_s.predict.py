"""Seconds a job spends in SearchDriver.search's phases: the per-job
difference of the program's PHASE_SECONDS."""


def read(run):
    return run.per_job(lambda j: run.jobs[j]["phase_s"])
