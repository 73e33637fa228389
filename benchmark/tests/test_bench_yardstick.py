"""The yardstick's counts on small shapes and its reduction of a trace."""

import numpy as np
import torch

from benchmark import yardstick


def test_cells():
    assert yardstick.gapless_cells([10, 20, 30], 1000) == 60_000
    pairs = np.array([[0, 1], [1, 0], [1, 1]])
    hits = np.zeros(2, dtype=[("q_end", np.int32), ("t_end", np.int32)])
    hits["q_end"], hits["t_end"] = [4, 9], [2, 0]
    got = yardstick.sw_cells(pairs, np.array([10, 20]), np.array([5, 7]),
                             hits)
    assert got == 10 * 7 + 20 * 5 + 20 * 7 + 5 * 3 + 10 * 1


def test_union_and_gaps():
    busy, gaps = yardstick._union([(0, 1), (0.5, 2), (3, 4)])
    assert busy == 3 and gaps == [(2, 3)]


class _Ev:
    def __init__(self, name, t0, t1, dev):
        self.name = name
        self.time_range = type("R", (), {"start": t0, "end": t1})
        self.device_type = (torch.autograd.DeviceType.CUDA if dev
                            else torch.autograd.DeviceType.CPU)


class _Prof:
    def events(self):
        us = 1e6
        return [_Ev("bench.job", 0, 5 * us, False),
                _Ev("bench.prefilter", 0, 2 * us, False),
                _Ev("bench.align", 2 * us, 5 * us, False),
                _Ev("gapless_rows", 0.1 * us, 1.1 * us, True),
                _Ev("topk", 1.2 * us, 1.4 * us, True),
                _Ev("sw_qm_ends", 3 * us, 4 * us, True)]


def test_trace_stages_and_breakdown():
    tr = yardstick.Trace(_Prof())
    assert abs(tr.stage_device_s("prefilter") - 1.2) < 1e-9
    assert abs(tr.stage_device_s("align") - 1.0) < 1e-9
    assert abs(tr.busy()[0] - 2.2) < 1e-9
    b = tr.breakdown()
    assert b["device_ops"][0][0] in ("gapless_rows", "sw_qm_ends")
    idle = dict(b["idle_gaps"])
    assert abs(idle["align"] - 2.0) < 1e-9
    # the gap from 1.4 to 3 lies 0.6 in prefilter, 1.0 in align
    assert abs(idle["prefilter"] - 0.8) < 1e-9
    assert abs(sum(idle.values()) - (5.0 - 2.2)) < 1e-9


def test_peak_is_128_lanes_a_clock():
    # 132 SMs at 1,980 MHz: no instruction stream issues more
    assert yardstick.LANES_PER_SM_CLOCK * 132 * 1980e6 == 3.345408e13
    assert yardstick.GAPLESS_OPS == 0.75 and yardstick.SW_OPS == 2.75
