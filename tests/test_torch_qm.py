"""The port's query-major SW (metaeuk_tpu_torch) against the JAX package.

The plain query-major versions (what the wrappers run on a CPU tensor) are
held to the Pallas kernels _dp_kernel_qm / _dp_kernel_qm_rev in interpret
mode (metaeuk_tpu/ops/sw_pallas.py, as tests/test_sw_pallas.py runs them),
and the port's driver with the query-major routing forced to the JAX
driver's hit arrays. Every output is an integer: the tolerance is exact
equality. The CUDA kernels are held to the plain versions on the card
(marker gpu).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metaeuk_tpu.search.driver as jax_driver
import metaeuk_tpu_torch.search.driver as torch_driver
from metaeuk_tpu.ops.sw_pallas import (TB, _align_ends_qm, _align_starts_qm,
                                       build_prof_tiles, build_tcodes_T)
from metaeuk_tpu.params import Params
from metaeuk_tpu_torch.ops import sw_cuda, sw_torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _staged(seed, nq, Lq, nt, Lt, t_lo=1):
    """Staged query and target matrices with ragged and zero lengths,
    repeated targets and targets that share a segment with a query."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 20, (nq, Lq)).astype(np.int32)
    qb = rng.integers(-3, 4, (nq, Lq)).astype(np.int32)
    ql = rng.integers(1, Lq + 1, nq).astype(np.int32)
    t = rng.integers(0, 20, (nt, Lt)).astype(np.int32)
    tl = rng.integers(t_lo, Lt + 1, nt).astype(np.int32)
    ql[-1], tl[-1] = 0, 0
    for k in range(0, nt - 1, 2):
        qi = k % nq
        n = int(min(ql[qi], tl[k], 30))
        t[k, 4:4 + n] = q[qi, :n]
    t[1], tl[1] = t[0], tl[0]
    return q, qb, ql, t, tl


def _tiles(seed, nq, nt, nT):
    """qidx (nT,) with a padding tile, lj (nT, TB) with padding lanes, a
    tile of every target and a tile with one target many times (ties)."""
    rng = np.random.default_rng(seed)
    qidx = rng.integers(0, nq, nT).astype(np.int32)
    qidx[-1] = -1
    lj = np.full((nT, TB), -1, np.int32)
    for k in range(nT):
        n = int(rng.integers(1, TB))
        lj[k, :n] = rng.integers(0, nt, n)
    lj[0, :nt] = np.arange(nt)
    lj[1, 3:20] = 0
    return qidx, lj


def _jax_qm(q, qb, ql, t, tl, qidx, lj, Lt_pad):
    Lq = q.shape[1]
    prof = build_prof_tiles(jnp.asarray(q), jnp.asarray(qb), jnp.asarray(ql),
                            jnp.asarray(qidx), Lq)
    tc = build_tcodes_T(jnp.asarray(t), jnp.asarray(tl), jnp.asarray(lj),
                        Lt_pad)
    ends = [np.asarray(a) for a in _align_ends_qm(prof, tc, Lq, Lt_pad,
                                                  True)]
    starts = [np.asarray(a) for a in _align_starts_qm(
        prof, tc, np.maximum(ends[1], 0), np.maximum(ends[2], 0), Lq, Lt_pad,
        True)]
    return ends, starts


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# (nq, Lq, nt, Lt, n_tiles, shortest target): a short tier with ragged
# lanes, and Lt = 1024 with targets past 512 columns, so the Pallas kernels
# run two column chunks (TJ = 512) and the reverse one walks them backwards
@pytest.mark.parametrize("nq,Lq,nt,Lt,nT,t_lo",
                         [(3, 40, 9, 56, 4, 1), (2, 24, 5, 1024, 3, 600)])
def test_plain_qm_matches_pallas_interpret(nq, Lq, nt, Lt, nT, t_lo):
    q, qb, ql, t, tl = _staged(Lt, nq, Lq, nt, Lt, t_lo)
    qidx, lj = _tiles(Lq, nq, nt, nT)
    (ref_e, ref_s) = _jax_qm(q, qb, ql, t, tl, qidx, lj, Lt)
    args = _torch(q, qb, ql, t, tl, qidx, lj.reshape(-1))
    ends = sw_cuda.qm_ends(*args)
    for name, a, b in zip(("score", "q_end", "t_end"), ref_e, ends):
        np.testing.assert_array_equal(a, b.numpy(), name)
    starts = sw_cuda.qm_starts(*args, torch.clamp_min(ends[1], 0),
                               torch.clamp_min(ends[2], 0))
    for name, a, b in zip(("score", "q_start", "t_start"), ref_s, starts):
        np.testing.assert_array_equal(a, b.numpy(), name)
    assert (ref_e[0] > 0).sum() > 10


def test_no_hit_values_follow_the_pallas_contract():
    """Padding lanes, a padding tile and zero-length rows: forward (0, Lq-1,
    -1) with Lq the tier width, reverse (0, 0, -1)."""
    nq, Lq, nt, Lt = 3, 32, 6, 40
    q, qb, ql, t, tl = _staged(9, nq, Lq, nt, Lt)
    qidx = np.array([nq - 1, 0, -1], np.int32)   # zero-length query row
    lj = np.full((3, TB), -1, np.int32)
    lj[0, :4] = [0, 1, 2, 3]
    lj[1, :2] = [nt - 1, nt - 1]                # zero-length target row
    args = _torch(q, qb, ql, t, tl, qidx, lj.reshape(-1))
    score, q_end, t_end = (a.numpy() for a in sw_cuda.qm_ends(*args))
    assert (score == 0).all() and (q_end == Lq - 1).all() \
        and (t_end == -1).all()
    zeros = torch.zeros(3 * TB, dtype=torch.int32)
    score, q_start, t_start = (a.numpy() for a in sw_cuda.qm_starts(
        *args, zeros, zeros + Lt))
    assert (score == 0).all() and (q_start == 0).all() \
        and (t_start == -1).all()


def test_profile_and_target_codes_match_jax():
    q, qb, ql, t, tl = _staged(2, 3, 40, 9, 56)
    qidx, lj = _tiles(4, 3, 9, 4)
    prof = build_prof_tiles(jnp.asarray(q), jnp.asarray(qb), jnp.asarray(ql),
                            jnp.asarray(qidx), 40)
    tc = build_tcodes_T(jnp.asarray(t), jnp.asarray(tl), jnp.asarray(lj), 64)
    qt, qbt, qlt, tt, tlt, qit, ljt = _torch(q, qb, ql, t, tl, qidx, lj)
    np.testing.assert_array_equal(
        np.asarray(prof, np.float32),
        sw_torch.build_prof_tiles(qt, qbt, qlt, qit).numpy())
    np.testing.assert_array_equal(
        np.asarray(tc), sw_torch.build_tcodes_T(tt, tlt, ljt, 64).numpy())


def test_cpu_tensors_take_the_plain_versions():
    q, qb, ql, t, tl = _staged(3, 2, 24, 4, 24)
    qidx, lj = _tiles(3, 2, 4, 2)
    args = _torch(q, qb, ql, t, tl, qidx, lj.reshape(-1))
    sw_cuda.reset_counts()
    ends = sw_cuda.qm_ends(*args)
    sw_cuda.qm_starts(*args, torch.clamp_min(ends[1], 0),
                      torch.clamp_min(ends[2], 0))
    assert sw_cuda.PLAIN_CALLS["sw_qm_ends"] == 1
    assert sw_cuda.PLAIN_CALLS["sw_qm_starts"] == 1
    assert not any(sw_cuda.LAUNCHES.values())


def test_other_devices_raise():
    q, qb, ql, t, tl = _staged(3, 2, 24, 4, 24)
    qidx, lj = _tiles(3, 2, 4, 2)
    args = [a.to("meta") for a in _torch(q, qb, ql, t, tl, qidx,
                                         lj.reshape(-1))]
    with pytest.raises(ValueError, match="CUDA"):
        sw_cuda.qm_ends(*args)


class _TargetDB:
    def __init__(self, seqs):
        self.seqs = seqs

    def __len__(self):
        return len(self.seqs)

    def seq_bytes(self, i):
        return self.seqs[i]

    def total_residues(self):
        return sum(len(s) for s in self.seqs)


def _synthetic(long_query=False):
    """test_sw_pallas.py:201's fragments and targets; long_query adds a
    fragment past the 4096-row bound of K3/K4."""
    aas = b"ACDEFGHIKLMNPQRSTVWY"
    r = np.random.default_rng(5)
    targets = [bytes(aas[c] for c in r.integers(0, 20, int(n)))
               for n in r.integers(20, 90, 37)]
    orfs = [bytes(aas[c] for c in r.integers(0, 20, int(n)))
            for n in r.integers(20, 120, 9)]
    orfs[0] = targets[3][:40] + orfs[0][:20]
    orfs[4] = targets[10][5:60]
    if long_query:
        orfs.append(bytes(aas[c] for c in r.integers(0, 20, 4100))
                    + targets[7])
    return orfs, targets


@pytest.fixture
def qm_env(monkeypatch):
    """Sets METAEUK_QM (and QM_MIN_CANDS) for one test."""
    def set_mode(mode, min_cands=None):
        monkeypatch.setenv("METAEUK_QM", mode)
        if min_cands is not None:
            monkeypatch.setattr(torch_driver, "QM_MIN_CANDS", min_cands)
    return set_mode


def _assert_same_hits(ref, got):
    assert len(ref) > 0 and len(ref) == len(got)
    for name in ref.dtype.names:
        np.testing.assert_array_equal(ref[name], got[name], name)


def _jax_hits(orfs, targets, p, pairs=None):
    old = os.environ.get("METAEUK_QM")
    os.environ["METAEUK_QM"] = "off"
    try:
        return jax_driver.SearchDriver(p, _TargetDB(targets)).search(orfs,
                                                                    pairs)
    finally:
        if old is None:
            del os.environ["METAEUK_QM"]
        else:
            os.environ["METAEUK_QM"] = old


def test_driver_forced_qm_matches_jax(qm_env):
    """METAEUK_QM=force with QM_MIN_CANDS=1: every pair goes query-major, and
    the hit array is the JAX driver's field for field
    (tests/test_sw_pallas.py:182)."""
    orfs, targets = _synthetic()
    p = Params()
    p.search_evalue_thr = 1e5
    ref = _jax_hits(orfs, targets, p)
    qm_env("force", 1)
    sw_cuda.reset_counts()
    got = torch_driver.SearchDriver(p, _TargetDB(targets), "cpu").search(
        orfs)
    assert sw_cuda.PLAIN_CALLS["sw_qm_ends"] > 0
    assert sw_cuda.PLAIN_CALLS["sw_qm_starts"] > 0
    assert sw_cuda.PLAIN_CALLS["sw_pair_ends"] == 0
    _assert_same_hits(ref, got)


@pytest.mark.parametrize("mode", ["auto", "off"])
def test_driver_gate_keeps_small_runs_on_the_pair_kernels(qm_env, mode):
    """Under auto the dense queries must carry max(100 000, pairs / 20)
    pairs; off never routes query-major."""
    orfs, targets = _synthetic()
    p = Params()
    p.search_evalue_thr = 1e5
    qm_env(mode, 1)
    sw_cuda.reset_counts()
    got = torch_driver.SearchDriver(p, _TargetDB(targets), "cpu").search(
        orfs)
    assert sw_cuda.PLAIN_CALLS["sw_qm_ends"] == 0
    assert sw_cuda.PLAIN_CALLS["sw_pair_ends"] > 0
    _assert_same_hits(_jax_hits(orfs, targets, p), got)


def test_driver_keeps_long_queries_on_the_pair_kernels(qm_env):
    """A fragment past 4096 aa stays on the pair kernels under METAEUK_QM=off
    and, under force, against a target past 4096 aa (both axes exceed the
    row-tiled kernels' bounds, driver.py:959-966); against shorter targets
    under force it takes the row-tiled kernels (tests/test_torch_qm_rt.py).
    The hits are the JAX driver's; the JAX reference leaves out the pair of
    two long sequences, whose (16384, 16384) score tensor is gigabytes on
    the CPU, and the port's two routings agree on it."""
    orfs, targets = _synthetic(long_query=True)
    r = np.random.default_rng(6)
    aas = b"ACDEFGHIKLMNPQRSTVWY"
    targets.append(bytes(aas[c] for c in r.integers(0, 20, 4000))
                   + orfs[-1][2000:2300])
    p = Params()
    p.search_evalue_thr = 1e5
    long_q, long_t = len(orfs) - 1, len(targets) - 1
    pairs = np.stack(np.meshgrid(np.arange(len(orfs)),
                                 np.arange(len(targets)),
                                 indexing="ij"), -1).reshape(-1, 2)
    pairs = pairs[(pairs[:, 0] == long_q) | (pairs[:, 1] < 12)]
    both_long = (pairs[:, 0] == long_q) & (pairs[:, 1] == long_t)
    ref = _jax_hits(orfs, targets, p, pairs[~both_long])
    hits = {}
    for mode in ("off", "force"):
        qm_env(mode, 1)
        sw_cuda.reset_counts()
        hits[mode] = torch_driver.SearchDriver(
            p, _TargetDB(targets), "cpu").search(orfs, pairs)
        assert sw_cuda.PLAIN_CALLS["sw_pair_ends"] > 0
        assert (sw_cuda.PLAIN_CALLS["sw_qm_rt_ends"] > 0) == (mode == "force")
    _assert_same_hits(hits["off"], hits["force"])
    got = hits["force"]
    long_hit = (got["orf_idx"] == long_q) & (got["target_idx"] == long_t)
    assert long_hit.sum() == 1
    _assert_same_hits(ref, got[~long_hit])


def test_make_qm_tiles_matches_jax():
    rng = np.random.default_rng(0)
    li = rng.integers(0, 7, 700).astype(np.int32)
    lj = rng.integers(0, 50, 700).astype(np.int32)
    rows = rng.permutation(700).astype(np.int64)
    for a, b in zip(jax_driver._make_qm_tiles(li, lj, rows),
                    torch_driver._make_qm_tiles(li, lj, rows)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("nq,Lq,nt,Lt,nT", [(3, 40, 9, 56, 4),
                                            (4, 4096, 20, 1024, 3)])
def test_kernels_match_plain_on_card(cuda_device, nq, Lq, nt, Lt, nT):
    q, qb, ql, t, tl = _staged(Lt, nq, Lq, nt, Lt)
    qidx, lj = _tiles(Lq, nq, nt, nT)
    args = [a.to(cuda_device) for a in _torch(q, qb, ql, t, tl, qidx,
                                              lj.reshape(-1))]
    ref = sw_torch.qm_ends(*args)
    sw_cuda.reset_counts()
    got = sw_cuda.qm_ends(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    ends = (torch.clamp_min(ref[1], 0), torch.clamp_min(ref[2], 0))
    got = sw_cuda.qm_starts(*args, *ends)
    torch.cuda.synchronize()
    for a, b in zip(got, sw_torch.qm_starts(*args, *ends)):
        assert torch.equal(a, b)
    assert sw_cuda.LAUNCHES["sw_qm_ends"] == 1
    assert sw_cuda.LAUNCHES["sw_qm_starts"] == 1
