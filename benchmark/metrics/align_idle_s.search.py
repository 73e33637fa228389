"""Seconds a completed search job has the device idle inside the program's
align and backtraces spans, as align_idle_s.predict reads them."""

from benchmark.run import load_metric

read = load_metric("align_idle_s.predict").read
