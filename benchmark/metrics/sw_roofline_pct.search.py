"""The aligner kernels' share of their roofline: the least time the card
needs for the window's forward and reverse SW cells (yardstick.SW_OPS a
cell at the peak issue rate) over the device time of every operation
inside SearchDriver.search."""

from benchmark import yardstick
from benchmark.metrics import _common


def read(run):
    return _common.roofline_pct(run, "align", _common.sw_cells,
                                yardstick.SW_OPS)
