"""Contig megabases predicted a second: every completed job's bp over the
time from the first job's start to the last job's end (host clock)."""


def read(run):
    return run.rate()
