"""The port's query-major recurrence variants T4
(metaeuk_tpu_torch.ops.qm_variants_*) against tools/kernel_variants.py's
Pallas kernel in interpret mode.

The plain version (what the wrapper runs on CPU tensors) takes the Pallas
kernel's inputs, built with run_variant's BlockSpecs, and must return the
same (best, q_end, t_end) in every variant, the inexact ones included: the
tolerance is zero. The inputs hold equal maxima across columns and rows
(a narrow score range), lanes that never score, codes outside the profile,
several column chunks with columns the grid skips, and H past 32767, where
base and fold cap and nocap and fold_nocap do not, and past 65,536, where
the uncapped variants' packed words wrap (fold_nocap's on H' = H + i ge,
from a row where H is still below 65,536). The CUDA kernel is held to the
plain version on the card (marker gpu).
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


# every cell 250 (the cap input) on Lq = Lt = 272: H(i, j) = 250 (min(i, j)
# + 1) reaches 68,000. Row 261 holds H 65,500, below 65,536, and H' = H +
# 261 ge = 65,761, past it; rows from 262 hold H past it too. nocap's word
# H * 32768 + (32767 - j) wraps from H 65,536: its best is row 261's 65,500
# at column 261. fold_nocap's H' * 32768 + (32767 - j) wraps from H' 65,536:
# each row from 261 keeps its best word at column 260 (H 65,250), equal to
# row 260's once i ge 32768 is taken off, and the smaller row wins.
WRAP_SHAPE = ("cap", 272, 272, 1, 272, 8)
WRAP_LANE0 = {"nocap": [65500, 261, 261], "fold_nocap": [65250, 260, 260]}


@pytest.mark.parametrize("variant", sorted(WRAP_LANE0))
def test_plain_matches_pallas_interpret_past_the_word_wrap(interpret,
                                                           variant):
    kind, Lq, Lt, n_tiles, tj, unroll = WRAP_SHAPE
    assert 250 * 262 < 65536 <= 250 * 262 + 261 * qm_variants_torch.GE
    assert 250 * Lq > 65536
    prof, tc = _inputs(kind, Lq, Lt, n_tiles, variant)
    ref = _pallas(prof, tc, variant, tj, unroll)
    got = qm_variants_torch.qm_variant_ends(
        torch.from_numpy(prof).bfloat16(), torch.from_numpy(tc), variant, tj,
        unroll)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g.numpy())
    assert [int(o[0]) for o in got] == WRAP_LANE0[variant]


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_matches_pallas_interpret_across_row_stripes(interpret,
                                                           variant):
    """chip_smoke's stripe case (Lq 1,100, the CUDA kernel's three row
    stripes): lane 0's equal runs in the first and the third stripe go to
    the earlier column, in the third."""
    import chip_smoke
    prof, tc = chip_smoke.stripe_variant_inputs(np, variant)
    tj, unroll = chip_smoke.STRIPE_SHAPE[3:]
    ref = _pallas(prof, tc, variant, tj, unroll)
    got = qm_variants_torch.qm_variant_ends(
        torch.from_numpy(prof).bfloat16(), torch.from_numpy(tc), variant, tj,
        unroll)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g.numpy())
    assert [int(o[0]) for o in got] == [11 * chip_smoke.STRIPE_RUN, 1039,
                                        54 + chip_smoke.STRIPE_RUN]


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


@pytest.mark.parametrize("Lt", (64, 300, 2048))
@pytest.mark.parametrize("tj", (1, 32, 40, 100, 256, 1024))
@pytest.mark.parametrize("unroll", qm_variants_cuda.UNROLLS)
def test_launch_plan_steps_are_the_visited_columns(Lt, tj, unroll):
    """The kernel walks plan.nvis steps; step s is column step_column(s):
    the Pallas grid's visited columns in order (none where per is 0)."""
    plan = qm_variants_cuda.launch_plan(256, Lt, tj, unroll)
    cols = [qm_variants_cuda.step_column(s, plan) for s in range(plan.nvis)]
    assert cols == qm_variants_torch.visited_columns(Lt, tj, unroll)
    assert plan.TJ == min(tj, Lt) and plan.per == (plan.TJ // unroll) * unroll
    # a ring load: whole chunks of per steps, at least MIN_CHUNK; the ring
    # a power of two holding two loads
    assert plan.chunk >= qm_variants_cuda.MIN_CHUNK
    assert plan.per == 0 or plan.chunk % plan.per == 0
    assert plan.ring >= 2 * plan.chunk and plan.ring & (plan.ring - 1) == 0
    assert plan.ring < 4 * plan.chunk


# Lq: (G, R, stripes) of the launch
PLAN_CLASSES = {32: (4, 8, 1), 96: (16, 8, 1), 160: (16, 16, 1),
                256: (16, 16, 1), 512: (32, 16, 1), 1100: (32, 16, 3)}


@pytest.mark.parametrize("Lq", sorted(PLAN_CLASSES))
def test_launch_plan_class_follows_pair_classes(Lq):
    """The first of PAIR_CLASSES whose G * R rows cover Lq, else the warp
    class in stripes of PAIR_STRIPE rows (K3's rule)."""
    from metaeuk_tpu_torch.ops.sw_cuda import PAIR_CLASSES, PAIR_STRIPE
    plan = qm_variants_cuda.launch_plan(Lq, 2048, 256, 8)
    assert (plan.G, plan.R, plan.stripes) == PLAN_CLASSES[Lq]
    assert PAIR_CLASSES[plan.cls] == (plan.G, plan.R)
    covers = [g * r >= Lq for g, r in PAIR_CLASSES[:-1]]
    assert plan.cls == (covers.index(True) if any(covers)
                        else len(PAIR_CLASSES) - 1)
    assert plan.stripes == (1 if plan.cls < len(PAIR_CLASSES) - 1
                            else -(-Lq // PAIR_STRIPE))


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


@pytest.mark.gpu
@pytest.mark.parametrize("variant", VARIANTS)
def test_kernel_matches_plain_across_row_stripes(cuda_device, variant):
    """Lq 1,100 (three stripes of the warp class), Lt 300, tj 100, unroll
    4: chip_smoke's stripe case, whose lane 0 ties across stripes."""
    import chip_smoke
    prof, tc = chip_smoke.stripe_variant_inputs(np, variant)
    Lq, Lt, _, tj, unroll = chip_smoke.STRIPE_SHAPE
    assert prof.shape[1] == Lq and tc.shape[0] == Lt
    prof = torch.from_numpy(prof).to(cuda_device).bfloat16()
    tc = torch.from_numpy(tc).to(cuda_device)
    got = qm_variants_cuda.qm_variant_ends(prof, tc, variant, tj, unroll)
    torch.cuda.synchronize()
    ref = qm_variants_torch.qm_variant_ends(prof, tc, variant, tj, unroll)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert [int(o[0]) for o in ref] == [11 * chip_smoke.STRIPE_RUN, 1039,
                                        54 + chip_smoke.STRIPE_RUN]


@pytest.mark.gpu
@pytest.mark.parametrize("variant", sorted(WRAP_LANE0))
def test_kernel_matches_plain_past_the_word_wrap(cuda_device, variant):
    kind, Lq, Lt, n_tiles, tj, unroll = WRAP_SHAPE
    prof, tc = (torch.from_numpy(a).to(cuda_device) for a in
                _inputs(kind, Lq, Lt, n_tiles, variant))
    prof = prof.bfloat16()
    got = qm_variants_cuda.qm_variant_ends(prof, tc, variant, tj, unroll)
    torch.cuda.synchronize()
    ref = qm_variants_torch.qm_variant_ends(prof, tc, variant, tj, unroll)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert [int(o[0]) for o in got] == WRAP_LANE0[variant]
