"""The share of the window in which no operation ran on the device
(torch.profiler's device events)."""

from benchmark.metrics import _common


def read(run):
    return _common.idle_pct(run)
