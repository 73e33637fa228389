"""Spans: named, nested intervals of the program's work on the host clock
(time.perf_counter), each with the span that opened it.

    with trace.span("search"):                # cli.main's root span
        with trace.span("load_targets"):
            db = load_target_input(path)

A span's parent is the innermost span open on its thread; code that hands
work to a pool thread passes the submitting span as `parent`. Closed spans
are kept in memory, the last MAX_SPANS of them (spans(), clear()).

While a torch profiler records on the thread, each span is also a range of
the profiler named metaeuk.<name>, on the host thread's row over the
launches made inside it. It is a host range only: torch's record_function
would add a copy of the range to the device rows, which readers of the
trace would count as device time.
"""

import collections
import itertools
import sys
import threading
import time

MAX_SPANS = 65536
PREFIX = "metaeuk."

_spans = collections.deque(maxlen=MAX_SPANS)
_span_ids = itertools.count(1)
_local = threading.local()


def _stack():
    """The spans open on this thread, innermost last."""
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _profiler_range(name):
    """An entered host range of the torch profiler recording on this
    thread, or None when none records (or torch is not loaded)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    rng = torch._C._profiler._RecordFunctionFast(PREFIX + name)
    rng.__enter__()
    return rng


class Span:
    """One span, a context manager."""

    __slots__ = ("span_id", "parent_id", "name", "t0", "t1", "_parent",
                 "_range")

    def __init__(self, name, parent=None):
        self.name = name
        self._parent = parent
        self.t0 = self.t1 = None

    def __enter__(self):
        st = _stack()
        parent = self._parent if self._parent is not None else \
            (st[-1] if st else None)
        self.parent_id = parent.span_id if parent is not None else 0
        self.span_id = next(_span_ids)
        self._range = _profiler_range(self.name)
        st.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        st = _stack()
        # this span, and any an exception left open above it
        for i in range(len(st) - 1, -1, -1):
            if st[i] is self:
                del st[i:]
                break
        _spans.append(self)
        return False


def span(name, parent=None):
    """A span of `name` under `parent` (default: the innermost span open on
    this thread)."""
    return Span(name, parent)


def current():
    """The innermost span open on this thread, or None."""
    st = _stack()
    return st[-1] if st else None


def spans():
    """The closed spans kept, oldest first."""
    return list(_spans)


def clear():
    _spans.clear()
