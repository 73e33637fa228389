"""The port's query-major recurrence variants T4
(metaeuk_tpu_torch.ops.qm_variants_*) against tools/kernel_variants.py's
Pallas kernel in interpret mode.

The plain version (what the wrapper runs on CPU tensors) takes the Pallas
kernel's inputs, built with run_variant's BlockSpecs, and must return the
same (best, q_end, t_end) in every variant, the inexact ones included: the
tolerance is zero. The inputs hold equal maxima across columns and rows
(a narrow score range), lanes that never score, codes outside the profile,
several column chunks with columns the grid skips, and H past 32767, where
base and fold cap and nocap and fold_nocap do not. The CUDA kernel is held
to the plain version on the card (marker gpu).
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from metaeuk_tpu_torch.ops import qm_variants_cuda, qm_variants_torch
from metaeuk_tpu_torch.tools import kernel_variants as port_kv

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).parent.parent
sys.path.insert(0, str(ROOT))
from tools import kernel_variants as tpu_kv  # noqa: E402

VARIANTS = qm_variants_torch.VARIANTS
TB, PCOLS = 128, 32


class _Interpret:
    """pallas with every pallas_call in interpret mode."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*a, **k):
        return pl.pallas_call(*a, **{**k, "interpret": True})


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(tpu_kv, "pl", _Interpret())


def _pallas(prof, tc, variant, TJ, unroll):
    """run_variant's pallas_call (tools/kernel_variants.py :142-151)."""
    n_tiles, Lq, _ = prof.shape
    Lt, B = tc.shape
    TJ = min(TJ, Lt)
    kern = tpu_kv.make_kernel(Lq, TJ, unroll, variant)
    f = tpu_kv.pl.pallas_call(
        kern, grid=(n_tiles, Lt // TJ),
        in_specs=[pl.BlockSpec((1, Lq, PCOLS), lambda b, j: (b, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((TJ, TB), lambda b, j: (j, b),
                               memory_space=pltpu.VMEM)],
        out_specs=[pl.BlockSpec((1, TB), lambda b, j: (0, b),
                                memory_space=pltpu.VMEM)] * 3,
        out_shape=[jax.ShapeDtypeStruct((1, B), jnp.int32)] * 3,
        scratch_shapes=[pltpu.VMEM((Lq, TB), jnp.int32)] * 3)
    out = f(jnp.asarray(prof, jnp.bfloat16), jnp.asarray(tc))
    return [np.asarray(o)[0] for o in out]


def _inputs(kind, Lq, Lt, n_tiles, variant):
    """(prof float32, tc int32) in numpy; the profile shifted by +GE for the
    folded variants, as run_variant does."""
    rng = np.random.default_rng(Lq * 1000 + Lt)
    if kind == "cap":       # one long diagonal of 250s
        prof = np.full((n_tiles, Lq, PCOLS), 250, np.float32)
        tc = np.zeros((Lt, n_tiles * TB), np.int32)
    else:
        hi = 3 if kind == "ties" else 12
        prof = rng.integers(-4 if hi == 12 else 0, hi,
                            (n_tiles, Lq, PCOLS)).astype(np.float32)
        tc = rng.integers(0, 20, (Lt, n_tiles * TB)).astype(np.int32)
        tc[:, 10:20] = tc[:, 5:6]        # repeated lanes
    prof[:, :, 21:] = -128
    tc[:, 1] = 25                        # every cell at -128: no hit
    tc[:, 2] = 40                        # outside the profile: scores 0
    tc[:, 3] = -1
    if variant in qm_variants_torch.FOLDED:
        prof[:, :, :21] += qm_variants_torch.GE
    return prof, tc


# (input, Lq, Lt, tiles, tj, unroll)
SHAPES = [("ties", 32, 64, 1, 32, 8),
          ("random", 64, 128, 2, 40, 16),
          ("cap", 160, 160, 1, 160, 8)]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kind,Lq,Lt,n_tiles,tj,unroll", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_plain_matches_pallas_interpret(interpret, variant, kind, Lq, Lt,
                                        n_tiles, tj, unroll):
    prof, tc = _inputs(kind, Lq, Lt, n_tiles, variant)
    ref = _pallas(prof, tc, variant, tj, unroll)
    got = qm_variants_cuda.qm_variant_ends(
        torch.from_numpy(prof).bfloat16(), torch.from_numpy(tc), variant, tj,
        unroll)
    for r, g in zip(ref, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(r, g.numpy())
    for lane in (1, 2, 3):               # no positive cell
        assert [int(o[lane]) for o in got] == [0, Lq - 1, -1]
    if kind == "cap":
        capped = variant in ("base", "fold", "nof")
        assert (int(got[0][0]) == 32767) == capped
        assert int(got[0][0]) > 32767 or capped
    if kind == "ties":
        assert len(np.unique(ref[0])) < TB // 2


def test_fold_equals_base_and_nof_differs(interpret):
    """fold is score-exact: its outputs equal base's on the same scores."""
    outs = {}
    for v in VARIANTS:
        prof, tc = _inputs("random", 32, 64, 1, v)
        outs[v] = qm_variants_torch.qm_variant_ends(
            torch.from_numpy(prof).bfloat16(), torch.from_numpy(tc), v, 32, 8)
    for v in ("fold", "nocap", "fold_nocap"):
        assert all(torch.equal(a, b) for a, b in zip(outs["base"], outs[v]))
    assert not torch.equal(outs["base"][0], outs["nof"][0])


def test_visited_columns_follow_the_pallas_grid():
    assert qm_variants_torch.visited_columns(128, 40, 16) == \
        [c * 40 + j for c in range(3) for j in range(32)]
    assert qm_variants_torch.visited_columns(64, 256, 8) == list(range(64))


def test_entry_point_inputs_are_run_variants():
    """variant_inputs draws run_variant's (tools/kernel_variants.py
    :133-141) profile and codes from seed 0."""
    for v in ("base", "fold"):
        prof, tc = port_kv.variant_inputs(v, 16, 32, 2, "cpu")
        rng = np.random.default_rng(0)
        want = rng.integers(-4, 12, (2, 16, PCOLS)).astype(np.float32)
        want[:, :, 21:] = -128
        if v == "fold":
            want[:, :, :21] += tpu_kv.GE
        np.testing.assert_array_equal(prof.float().numpy(), want)
        np.testing.assert_array_equal(
            tc.numpy(), rng.integers(0, 20, (32, 2 * TB)).astype(np.int32))


def test_entry_point_on_cpu(capsys):
    res = port_kv.main(["--device", "cpu", "--lq", "32", "--lt", "64",
                        "--tiles", "1", "base", "u4", "tj32", "nof"])
    assert list(res) == ["base", "u4", "tj32", "nof"]
    prof, tc = port_kv.variant_inputs("base", 32, 64, 1, "cpu")
    ref = qm_variants_torch.qm_variant_ends(prof, tc, "base", 32, 8)
    for word in ("base", "u4", "tj32"):
        assert res[word][0] is None
        for r, g in zip(ref, res[word][1:]):
            np.testing.assert_array_equal(r.numpy(), g)
    out = capsys.readouterr().out
    assert "device: cpu" in out
    assert f"score={ref[0].numpy()[:6]}" in out
    with pytest.raises(SystemExit):
        port_kv.main(["--device", "cpu", "u"])


def test_cpu_tensors_take_the_plain_version():
    prof, tc = port_kv.variant_inputs("base", 16, 32, 1, "cpu")
    qm_variants_cuda.reset_counts()
    qm_variants_cuda.qm_variant_ends(prof, tc)
    assert qm_variants_cuda.PLAIN_CALLS == {"qm_variant_ends": 1}
    assert qm_variants_cuda.LAUNCHES == {"qm_variant_ends": 0}


def test_other_devices_raise():
    prof = torch.zeros(1, 16, PCOLS, dtype=torch.bfloat16, device="meta")
    tc = torch.zeros(32, TB, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        qm_variants_cuda.qm_variant_ends(prof, tc)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kind,Lq,Lt,n_tiles,tj,unroll", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_kernel_matches_plain_on_card(cuda_device, variant, kind, Lq, Lt,
                                      n_tiles, tj, unroll):
    prof, tc = (torch.from_numpy(a).to(cuda_device) for a in
                _inputs(kind, Lq, Lt, n_tiles, variant))
    prof = prof.bfloat16()
    qm_variants_cuda.reset_counts()
    got = qm_variants_cuda.qm_variant_ends(prof, tc, variant, tj, unroll)
    torch.cuda.synchronize()
    assert qm_variants_cuda.LAUNCHES == {"qm_variant_ends": 1}
    ref = qm_variants_torch.qm_variant_ends(prof, tc, variant, tj, unroll)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.gpu
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    prof, tc = port_kv.variant_inputs("base", 16, 32, 1, cuda_device)
    for kw, match in (({"unroll": 3}, "unroll"),
                      ({"variant": "nope"}, "variant")):
        with pytest.raises(ValueError, match=match):
            qm_variants_cuda.qm_variant_ends(prof, tc, **kw)
    with pytest.raises(ValueError, match="bfloat16"):
        qm_variants_cuda.qm_variant_ends(prof.float(), tc)
