"""Queries searched a second: every completed job's queries over the time
from the first job's start to the last job's end (host clock)."""


def read(run):
    return run.rate()
