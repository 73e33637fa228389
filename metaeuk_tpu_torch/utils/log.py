# Copy of metaeuk_tpu/utils/log.py; a stage is a span of utils/trace.py, and
# the unused Stats is gone.
"""Logging, timers and per-stage statistics.

Equivalent of the reference's Debug levels + Timer + prefilter statistics
(lib/mmseqs/src/commons/Debug.h:42-208, Timer.h:8,
prefiltering/Prefiltering.cpp:953-975): leveled stderr logging, wall-clock
stage timing, and a counters registry every stage reports into.
"""

import sys
import time

from . import trace

LEVEL_NOTHING = 0
LEVEL_ERROR = 1
LEVEL_WARNING = 2
LEVEL_INFO = 3
LEVEL_DEBUG = 4

_level = LEVEL_INFO


def set_level(level):
    global _level
    _level = level


def _emit(tag, msg):
    print(f"[{tag}] {msg}", file=sys.stderr, flush=True)


def error(msg):
    if _level >= LEVEL_ERROR:
        _emit("ERROR", msg)


def warning(msg):
    if _level >= LEVEL_WARNING:
        _emit("WARN", msg)


def info(msg):
    if _level >= LEVEL_INFO:
        _emit("INFO", msg)


def debug(msg):
    if _level >= LEVEL_DEBUG:
        _emit("DEBUG", msg)


class StageTimer:
    """Wall-clock per-stage timing with a summary table."""

    def __init__(self):
        self.stages = []

    def stage(self, name):
        return _StageCtx(self, name)

    def report(self):
        total = sum(dt for _, dt in self.stages)
        for name, dt in self.stages:
            info(f"{name:<28s} {dt:8.3f}s {100*dt/max(total,1e-9):5.1f}%")
        info(f"{'total':<28s} {total:8.3f}s")
        return dict(self.stages)


class _StageCtx:
    def __init__(self, timer, name):
        self.timer = timer
        self.name = name

    def __enter__(self):
        debug(f"stage {self.name} start")
        self.span = trace.span(self.name).__enter__()
        return self

    def __exit__(self, *exc):
        self.span.__exit__(*exc)
        dt = self.span.t1 - self.span.t0
        self.timer.stages.append((self.name, dt))
        info(f"stage {self.name}: {dt:.3f}s")
        return False


class Progress:
    """Long-loop progress ticks (the reference's Debug::Progress,
    lib/mmseqs/src/commons/Debug.h:116-208, printed in every OMP loop).
    Rate-limited to one line per `interval` seconds so a 10-minute stage
    is visibly alive without flooding logs; prints processed/total, rate
    and ETA. Cheap when quiet: update() is one counter add + one clock
    read per `step` calls."""

    def __init__(self, total=None, label="", interval=2.0, step=1):
        self.total = total
        self.label = label
        self.interval = interval
        self.step = max(1, step)
        self.done = 0
        self._since_check = 0
        self._t0 = time.perf_counter()
        self._last = self._t0
        self._emitted = False

    def update(self, n=1):
        self.done += n
        self._since_check += n
        if self._since_check < self.step:
            return
        self._since_check = 0
        now = time.perf_counter()
        if now - self._last < self.interval:
            return
        self._last = now
        self._emit(now)

    def _emit(self, now):
        if _level < LEVEL_INFO:
            return
        dt = now - self._t0
        rate = self.done / dt if dt > 0 else 0.0
        if self.total:
            pct = 100.0 * self.done / self.total
            eta = (self.total - self.done) / rate if rate > 0 else 0.0
            _emit("PROG", f"{self.label} {self.done}/{self.total} "
                          f"({pct:.1f}%) {rate:.0f}/s ETA {eta:.0f}s")
        else:
            _emit("PROG", f"{self.label} {self.done} {rate:.0f}/s")
        self._emitted = True

    def finish(self):
        """Final line (only if any tick was ever emitted — short loops
        stay silent)."""
        if self._emitted:
            now = time.perf_counter()
            self._last = now
            self._emit(now)


def progress(total=None, label="", interval=2.0, step=1):
    return Progress(total, label, interval, step)


def peak_rss_bytes():
    """Kernel-maintained peak resident set (VmHWM) of this process."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def current_rss_bytes():
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


class MemoryTracker:
    """Large-allocation accounting (the reference's MemoryTracker,
    lib/mmseqs/src/commons/MemoryTracker.h:8): stages register their big
    buffers by name; report() logs them with current and peak RSS so a
    blown memory budget names its owner."""

    _tracked = {}

    @classmethod
    def track(cls, name, n_bytes):
        cls._tracked[name] = max(cls._tracked.get(name, 0), int(n_bytes))

    @classmethod
    def reset(cls):
        cls._tracked = {}

    @classmethod
    def report(cls):
        gib = 1024.0 ** 3
        for name, b in sorted(cls._tracked.items(), key=lambda kv: -kv[1]):
            if b >= 1 << 20:
                info(f"mem {name}: {b / gib:.2f} GiB")
        peak = peak_rss_bytes()
        info(f"mem peak RSS: {peak / gib:.2f} GiB")
        return peak
