"""The port's microbenchmark kernels T1-T3 (metaeuk_tpu_torch.ops.kbench_*)
against tools/kbench.py's Pallas kernels in interpret mode.

The plain versions (what the wrappers run on a CPU tensor) take the same
seeded inputs as the Pallas kernels, with REPS shrunk to 16, and must give
the same values to the bit: the tolerance is zero in every dtype. bf16
inputs span past 256, where b + 1 stops growing. The CUDA kernels are held
to the plain versions on the card (marker gpu); here, the numpy models of
kb_shift's and kb_scan's index arithmetic (ops/kbench_cuda.py: the rows'
lanes and registers, the unrolled reps and their remainder, the scan's
wavefront) are held to the plain versions at edge reps, and T2's and T3's
one-call yardsticks (tools/kbench.py) to them at REPS.
"""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from metaeuk_tpu_torch.ops import kbench_cuda, kbench_torch
from metaeuk_tpu_torch.tools import kbench as port_kb

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).parent.parent
sys.path.insert(0, str(ROOT))
from tools import kbench as tpu_kb  # noqa: E402

REPS = 16
JNP = {torch.int32: jnp.int32, torch.int16: jnp.int16,
       torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture
def interpret(monkeypatch):
    """tools/kbench.py's kernels through Pallas interpret mode, REPS 16."""
    call = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: call(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(tpu_kb, "REPS", REPS)


def _jax(x):
    return jnp.asarray(x.float().numpy(), JNP[x.dtype]) \
        if x.dtype == torch.bfloat16 else jnp.asarray(x.numpy())


def _assert_bits_equal(ref, got):
    ref = np.asarray(ref.astype(jnp.float32)) if ref.dtype == jnp.bfloat16 \
        else np.asarray(ref)
    got = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    assert ref.dtype == got.dtype and ref.shape == got.shape
    if ref.dtype.kind == "f":
        ref, got = ref.view(np.int32), got.view(np.int32)
    np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize("n_ops", [2, 8])
@pytest.mark.parametrize("case", ["alu_i32", "alu_i16", "alu_f32",
                                  "alu_bf16"])
def test_plain_alu_matches_pallas_interpret(interpret, case, n_ops):
    x = port_kb.case_input(case, "cpu", seed=n_ops)
    run, _, n_total = tpu_kb.make_alu_case(JNP[x.dtype], n_ops)
    got = kbench_cuda.alu(x, REPS, n_ops)
    _assert_bits_equal(run(_jax(x)), got)
    if case == "alu_bf16":   # b + 1 rounds back to b from 256 on
        climb = (x.float() >= 256 - REPS * (n_ops // 2)) & (x.float() < 256)
        assert climb.any() and bool((got.float()[climb] == 256).all())
    assert n_total == REPS * n_ops * x.numel()


@pytest.mark.parametrize("case", ["shift_i32", "shift_i16", "roll_i32",
                                  "shift8", "shift64", "shift3"])
def test_plain_shift_matches_pallas_interpret(interpret, case):
    _, dtype, kw = port_kb.CASES[case]
    x = port_kb.case_input(case, "cpu", seed=11)
    run, _, _ = tpu_kb.make_shift_case(JNP[dtype], use_roll=kw.get(
        "roll", False), amount=kw.get("amount", 1))
    got = port_kb.run_case(case, x, REPS)
    _assert_bits_equal(run(_jax(x)), got)
    assert not torch.equal(got, x)


def test_plain_scan_matches_pallas_interpret(interpret):
    """Seeded values, and columns below NEG, where the Pallas scan's fill
    reaches every row but the last."""
    x = port_kb.case_input("scan256", "cpu", seed=5)
    x[:, :3] = -2_000_000 - torch.arange(256, dtype=torch.int32)[:, None]
    run, _, _ = tpu_kb.make_scan_case(False)
    got = kbench_cuda.scan(x, REPS)
    _assert_bits_equal(run(_jax(x)), got)
    assert REPS // 8 == 2
    assert int(got[254, 0]) == kbench_torch.NEG - 1
    assert int(got[255, 0]) == kbench_torch.NEG - 2


def test_roll_direction_is_torch_roll():
    """pltpu.roll(a, k, 0) moves rows down with wrap-around, as torch.roll."""
    x = torch.arange(256 * 4, dtype=torch.int32).reshape(256, 4)
    got = kbench_torch.shift(x, reps=1, amount=3, roll=True)
    assert torch.equal(got, torch.maximum(x, torch.roll(x, 3, 0)))
    assert int(got[0, 0]) == int(x[253, 0])


def test_op_counts_are_the_tpu_tools():
    for case in port_kb.CASES:
        kind, dtype, kw = port_kb.CASES[case]
        if kind == "alu":
            _, _, n = tpu_kb.make_alu_case(JNP[dtype])
        elif kind == "shift":
            _, _, n = tpu_kb.make_shift_case(JNP[dtype], kw.get("roll", False),
                                             kw.get("amount", 1))
        else:
            _, _, n = tpu_kb.make_scan_case(False)
        assert port_kb.n_total_ops(case) == n, case


def test_cpu_tensors_take_the_plain_versions():
    kbench_cuda.reset_counts()
    x = port_kb.case_input("shift_i32", "cpu", seed=1)
    assert torch.equal(kbench_cuda.shift(x, 4, amount=8),
                       kbench_torch.shift(x, 4, amount=8))
    kbench_cuda.alu(x, 2)
    kbench_cuda.scan(x, 8)
    assert kbench_cuda.PLAIN_CALLS == {"kb_alu": 1, "kb_shift": 1,
                                       "kb_scan": 1}
    assert kbench_cuda.LAUNCHES == {"kb_alu": 0, "kb_shift": 0, "kb_scan": 0}


def test_other_devices_raise():
    x = torch.zeros(256, 8, dtype=torch.int32, device="meta")
    for fn in (kbench_cuda.alu, kbench_cuda.shift, kbench_cuda.scan):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, 2)


def test_entry_point_on_cpu(capsys):
    res = port_kb.main(["--device", "cpu", "alu_i32", "roll_i32"])
    assert list(res) == ["alu_i32", "roll_i32"]
    assert res["alu_i32"][0] is None
    assert torch.equal(res["alu_i32"][2], torch.full(
        port_kb.SHAPE, kbench_torch.REPS * 4, dtype=torch.int32))
    out = capsys.readouterr().out
    assert "device: cpu" in out and "roll_i32" in out
    with pytest.raises(SystemExit):
        port_kb.main(["--device", "cpu", "nosuchcase"])


def _edge_input(dtype, cols=5, seed=17):
    """(256, cols) numpy values: seeded, a column below NEG, and for int32
    columns of INT_MIN (whole and first rows) and near INT_MAX."""
    rng = np.random.default_rng(seed)
    hi = 20000 if dtype == np.int16 else 100000
    x = rng.integers(-hi, hi, (256, cols)).astype(dtype)
    if dtype == np.int32:
        rows = np.arange(256)
        x[:, 0] = -2_000_000 - rows
        x[:, 1] = np.iinfo(np.int32).min
        x[:5, 2] = np.iinfo(np.int32).min
        x[:, 3] = np.iinfo(np.int32).max - rows
    return x


@pytest.mark.parametrize("dtype", [np.int32, np.int16])
@pytest.mark.parametrize("reps", [0, 1, 7, 8, 61])
@pytest.mark.parametrize("roll", [False, True])
@pytest.mark.parametrize("amount", kbench_cuda.SHIFT_AMOUNTS)
def test_shift_model_matches_plain(amount, roll, reps, dtype):
    """kb_shift's moves and rep order, in numpy, against the plain version:
    none, one, the remainder loop alone, one unrolled block, both."""
    x = _edge_input(dtype)
    ref = kbench_torch.shift(torch.from_numpy(x), reps, amount, roll)
    np.testing.assert_array_equal(
        kbench_cuda.shift_model(x, reps, amount, roll), ref.numpy())


@pytest.mark.parametrize("amount", kbench_cuda.SHIFT_AMOUNTS)
def test_shift_sources_are_the_row_amount_above(amount):
    """Row 8t + i sits in register i of lane t, and takes the row `amount`
    above it: from shift_source's lane and register, in range for zero fill
    and wrapped round for roll."""
    assert kbench_cuda.ROWS_PER_LANE * kbench_cuda.LANES == 256
    for row in range(256):
        lane, reg = kbench_cuda.row_slot(row)
        assert row == lane * kbench_cuda.ROWS_PER_LANE + reg
        lanes, src = kbench_cuda.shift_source(amount, reg)
        src_row = (lane - lanes) * kbench_cuda.ROWS_PER_LANE + src
        assert src_row == row - amount
    want = {1: 1, 3: 3, 8: 8, 64: 8}[amount]
    assert kbench_cuda.shuffles_per_rep(amount) == want


@pytest.mark.parametrize("reps", [0, 1, 7, 8, 61, 512])
def test_rep_blocks_are_unrolled_blocks_then_the_remainder(reps):
    blocks = kbench_cuda.rep_blocks(reps)
    assert sum(blocks) == reps
    n = reps // kbench_cuda.ROWS_PER_LANE
    assert blocks[:n] == [kbench_cuda.ROWS_PER_LANE] * n
    assert blocks[n:] == [1] * (reps % kbench_cuda.ROWS_PER_LANE)


def test_shift_chain_counts():
    """Shuffles and other operations a rep on the longest dependent path:
    k = 1 one shuffle in 8 reps, k = 3 three, k = 8 and 64 one a rep; zero
    fill adds the fill's multiply to each crossing of k = 1 and 3, and is
    the max's floor for k = 8 and 64 (each register its own source)."""
    got = {(a, r): kbench_cuda.shift_chain(a, r)
           for a in kbench_cuda.SHIFT_AMOUNTS for r in (False, True)}
    assert got == {(1, False): (0.125, 1.125), (1, True): (0.125, 1),
                   (3, False): (0.375, 1.375), (3, True): (0.375, 1),
                   (8, False): (1, 1), (8, True): (1, 1),
                   (64, False): (1, 1), (64, True): (1, 1)}
    assert [kbench_cuda.fill_by_floor(a, 0) for a in
            kbench_cuda.SHIFT_AMOUNTS] == [False, False, True, True]


@pytest.mark.parametrize("reps", [0, 7, 8, 40, 61, 248, 264, 512])
def test_scan_model_matches_plain(reps):
    """kb_scan's wavefront, in numpy, against the plain version: 0, 1, 5, 7,
    31, 33 and 64 passes (the ramp is 32 steps), a reps not a multiple of
    8, columns below NEG and at int32's ends."""
    x = _edge_input(np.int32)
    ref = kbench_torch.scan(torch.from_numpy(x), reps)
    got = kbench_cuda.scan_model(x, reps)
    np.testing.assert_array_equal(got, ref.numpy())
    if reps == 512:
        assert int(got[254, 0]) == kbench_torch.NEG - 1
        assert int(got[255, 1]) == np.iinfo(np.int32).max - 63


@pytest.mark.parametrize("passes", [0, 1, 5, 31, 32, 33, 64])
def test_scan_phases_hold_each_lanes_first_and_last_pass(passes):
    """Lane t runs pass s - t at step s: the loops cover the steps once, in
    order; every first pass falls in a loop that takes the input back,
    every last pass in one that leaves the output."""
    steps, where = [], {}
    for first, stop, first_passes, last_passes in \
            kbench_cuda.scan_phases(passes):
        for s in range(first, stop):
            steps.append(s)
            where[s] = (first_passes, last_passes)
    assert steps == list(range(kbench_cuda.scan_steps(passes)))
    for t in range(kbench_cuda.LANES * (passes > 0)):
        assert where[t][0]
        assert where[t + passes - 1][1]


@pytest.mark.parametrize("dtype", [torch.int32, torch.int16])
@pytest.mark.parametrize("roll", [False, True])
@pytest.mark.parametrize("amount", kbench_cuda.SHIFT_AMOUNTS)
def test_shift_yardstick_equals_plain_at_reps(amount, roll, dtype):
    x = torch.from_numpy(_edge_input(np.int16 if dtype == torch.int16
                                     else np.int32, seed=amount))
    ref = kbench_torch.shift(x, kbench_torch.REPS, amount, roll)
    assert torch.equal(port_kb.shift_yardstick(x, amount, roll), ref)


def test_scan_yardstick_equals_plain_above_neg():
    x = port_kb.case_input("scan256", "cpu", seed=5, shape=(256, 3))
    assert torch.equal(port_kb.scan_yardstick(x), kbench_torch.scan(x))


@pytest.mark.parametrize("case", ["shift_i32", "shift_i16", "roll_i32",
                                  "shift3", "shift8", "shift64", "scan256"])
def test_each_cases_yardstick_equals_its_plain_run(case):
    """tools/kbench.py yardstick, as chip_smoke's phase 6b times it."""
    x = port_kb.case_input(case, "cpu", seed=5, shape=(256, 4))
    assert torch.equal(port_kb.yardstick(case, x), port_kb.run_case(case, x))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(port_kb.CASES))
def test_kernels_match_plain_on_card(cuda_device, case):
    x = port_kb.case_input(case, cuda_device, seed=3)
    kind, _, kw = port_kb.CASES[case]
    kbench_cuda.reset_counts()
    got = port_kb.run_case(case, x)
    torch.cuda.synchronize()
    assert sum(kbench_cuda.LAUNCHES.values()) == 1
    ref = getattr(kbench_torch, kind)(x, kbench_torch.REPS, **kw)
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}.get(
        x.dtype)
    if view is not None:
        got, ref = got.view(view), ref.view(view)
    assert torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("reps", [0, 1, 7, 8, 61])
@pytest.mark.parametrize("roll", [False, True])
@pytest.mark.parametrize("amount", kbench_cuda.SHIFT_AMOUNTS)
def test_shift_kernel_matches_plain_at_edge_reps(cuda_device, amount, roll,
                                                 reps):
    x = torch.from_numpy(_edge_input(np.int32, cols=37)).to(cuda_device)
    got = kbench_cuda.shift(x, reps, amount, roll)
    assert torch.equal(got, kbench_torch.shift(x, reps, amount, roll))


@pytest.mark.gpu
@pytest.mark.parametrize("reps", [0, 7, 8, 40, 61, 248, 264, 512])
def test_scan_kernel_matches_plain_at_edge_reps(cuda_device, reps):
    x = torch.from_numpy(_edge_input(np.int32, cols=37)).to(cuda_device)
    assert torch.equal(kbench_cuda.scan(x, reps), kbench_torch.scan(x, reps))
