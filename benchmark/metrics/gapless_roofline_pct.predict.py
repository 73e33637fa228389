"""K7's share of its roofline: the least time the card needs for the
window's gapless cells (yardstick.GAPLESS_OPS a cell at the peak issue
rate) over the device time of every operation inside candidate_pairs."""

from benchmark import yardstick
from benchmark.metrics import _common


def read(run):
    return _common.roofline_pct(run, "prefilter", _common.gapless_cells,
                                yardstick.GAPLESS_OPS)
