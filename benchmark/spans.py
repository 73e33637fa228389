"""Spans around the calls into the program's layers, recorded from the
benchmark's own files: each wraps a function or method of the port in
place, times it by the host clock, marks it for the profiler, and keeps
what the call returned for the comparison after the window.

A span is (job, name, start, end) in time.perf_counter seconds. They are
kept in memory and read when the run ends.
"""

import contextlib
import functools
import time

import torch


class Recorder:
    """Spans and captured values of the current job."""

    def __init__(self):
        self.job = None
        self.spans = []
        self.captured = {}
        self._undo = []

    def begin_job(self, job):
        self.job = job
        self.captured.setdefault(job, {})

    @contextlib.contextmanager
    def span(self, name):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(f"bench.{name}"):
                yield
        finally:
            self.spans.append((self.job, name, t0, time.perf_counter()))

    def wrap(self, owner, attr, name, keep=None):
        """Replace owner.attr by a wrapper recording span `name`; keep(args,
        result) returns what to capture under `name` for the job."""
        orig = getattr(owner, attr)

        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            with self.span(name):
                out = orig(*args, **kwargs)
            if keep is not None and self.job is not None:
                self.captured[self.job].setdefault(name, []).append(
                    keep(args, out))
            return out

        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, orig))

    def unwrap(self):
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()

    def seconds(self, job, name):
        """Seconds of the job's spans of `name`."""
        return sum(t1 - t0 for j, n, t0, t1 in self.spans
                   if j == job and n == name)
