"""Shared by the metric readers: the yardstick's least device time of the
window's work in a stage, over the device time the trace shows there."""

import numpy as np

from benchmark import yardstick


def roofline_pct(run, stage, cells_of, ops_per_cell):
    """100 x (least time of the cells) / (device time inside `stage`);
    None without a trace or device time."""
    if run.prof is None or run.peak is None:
        return None
    device_s = run.prof.stage_device_s(stage)
    if device_s <= 0:
        return None
    cells = sum(cells_of(run, j) for j in run.done)
    return 100.0 * cells * ops_per_cell / run.peak[0] / device_s


def gapless_cells(run, j):
    seqs, _ = run.rec.captured[j]["prefilter"][0]
    return yardstick.gapless_cells([len(s) for s in seqs], run.db_res)


def sw_cells(run, j):
    seqs, pairs = run.rec.captured[j]["prefilter"][0]
    hits = run.rec.captured[j]["align"][0]
    q_lens = np.array([len(s) for s in seqs], np.int64)
    return yardstick.sw_cells(pairs, q_lens, run.tlens, hits)


def idle_pct(run):
    if run.prof is None:
        return None
    t0, t1 = run.window()
    busy, _ = run.prof.busy()
    return 100.0 * (1.0 - busy / (t1 - t0))
