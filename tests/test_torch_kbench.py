"""The port's microbenchmark kernels T1-T3 (metaeuk_tpu_torch.ops.kbench_*)
against tools/kbench.py's Pallas kernels in interpret mode.

The plain versions (what the wrappers run on a CPU tensor) take the same
seeded inputs as the Pallas kernels, with REPS shrunk to 16, and must give
the same values to the bit: the tolerance is zero in every dtype. bf16
inputs span past 256, where b + 1 stops growing. The CUDA kernels are held
to the plain versions on the card (marker gpu).
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
