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
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metaeuk_tpu.search.driver as jax_driver
import metaeuk_tpu_torch.search.driver as torch_driver
from metaeuk_tpu.ops.sw import sw_align
from metaeuk_tpu.ops.sw_pallas import (TB, _align_ends_qm, _align_starts_qm,
                                       build_prof_tiles, build_tcodes_T)
from metaeuk_tpu.params import Params
from metaeuk_tpu_torch.ops import sw_cuda, sw_torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent


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


def _smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def test_lane_lengths_read_as_the_kernels_do():
    """chip_smoke.lane_lengths: each lane's query and target length, cut to
    the tier widths; 0 and 0 for a padding tile or lane and for an index
    past the staged rows."""
    q_lens = torch.tensor([5, 300, 0], dtype=torch.int32)
    t_lens = torch.tensor([7, 2000], dtype=torch.int32)
    qidx = torch.tensor([1, -1, 3, 0], dtype=torch.int32)
    lj = torch.full((4 * TB,), -1, dtype=torch.int32)
    lj[[0, 1, 2, TB, 2 * TB, 3 * TB + 5]] = torch.tensor(
        [0, 1, 2, 0, 1, 1], dtype=torch.int32)
    n, m = _smoke().lane_lengths(torch, q_lens, t_lens, qidx, lj, 256,
                                 1024)
    want_n = torch.zeros(4 * TB, dtype=torch.int32)
    want_n[[0, 1, 3 * TB + 5]] = torch.tensor([256, 256, 5],
                                              dtype=torch.int32)
    want_m = torch.zeros(4 * TB, dtype=torch.int32)
    want_m[[0, 1, 3 * TB + 5]] = torch.tensor([7, 1024, 1024],
                                              dtype=torch.int32)
    assert torch.equal(n, want_n) and torch.equal(m, want_m)


def _edge_tiles(Lq, Lt, keep=None):
    """chip_smoke.qm_edge_tiles at (Lq, Lt): K1/K2's planted ties and runs
    (pair_edge_batch) as tiles of their own queries, with other targets in
    random lanes, a tile of padding lanes and a padding tile; keep(q_len,
    t_len, expectation) picks the planted pairs to keep, each then alone
    in its tile."""
    arrays, expect = _smoke().qm_edge_tiles(np, np.random.default_rng(Lq),
                                            Lq, Lt)
    q, qb, ql, t, tl, qidx, lj = (np.asarray(a).astype(np.int32)
                                  for a in arrays)
    if keep is not None:
        lanes = [b for b, e in enumerate(expect) if b % TB == 37 * (
            b // TB) % TB and b // TB < len(ql)
            and keep(ql[b // TB], tl[b // TB], e)]
        qidx = np.array([b // TB for b in lanes], np.int32)
        lj = np.full((len(lanes), TB), -1, np.int32)
        lj[:, 0] = qidx
        expect = [e for b in lanes for e in [expect[b]] + [None] * (TB - 1)]
        lj = lj.reshape(-1)
    return (q, qb, ql, t, tl, qidx, lj), expect


def _lane_ends(ql, tl, qidx, lj):
    """Each lane's whole matrix: (q_len - 1, t_len - 1), clamped at 0."""
    lane_q = np.repeat(qidx, TB)
    qe = np.where(lane_q >= 0, ql[np.maximum(lane_q, 0)] - 1, 0)
    te = np.where(lj >= 0, tl[np.maximum(lj, 0)] - 1, 0)
    return np.maximum(qe, 0).astype(np.int32), np.maximum(te, 0).astype(
        np.int32)


def _check_planted(expect, fwd, rev):
    for b, ex in enumerate(expect):
        if ex is not None:
            got = (tuple(int(a[b]) for a in fwd),
                   tuple(int(a[b]) for a in rev))
            assert got == ex, (b, got, ex)


def test_planted_edges_match_pallas_interpret():
    """The query-major edge tiles up to 64 rows (the classes of lanes of 8
    rows, groups of 4 and 8 lanes): forward ends against _align_ends_qm,
    starts from the forward ends and over each lane's whole matrix against
    _align_starts_qm (interpret mode), and the planted cells."""
    Lq, Lt = 72, 80
    (q, qb, ql, t, tl, qidx, lj), expect = _edge_tiles(Lq, Lt)
    assert sum(e is not None for e in expect) == 2 * 18
    prof = build_prof_tiles(jnp.asarray(q), jnp.asarray(qb), jnp.asarray(ql),
                            jnp.asarray(qidx), Lq)
    tc = build_tcodes_T(jnp.asarray(t), jnp.asarray(tl),
                        jnp.asarray(lj.reshape(-1, TB)), Lt)
    ref = [np.asarray(a) for a in _align_ends_qm(prof, tc, Lq, Lt, True)]
    args = _torch(q, qb, ql, t, tl, qidx, lj)
    got = [a.numpy() for a in sw_cuda.qm_ends(*args)]
    for name, a, b in zip(("score", "q_end", "t_end"), ref, got):
        np.testing.assert_array_equal(a, b, name)
    revs = []
    for qe, te in ((np.maximum(got[1], 0), np.maximum(got[2], 0)),
                   _lane_ends(ql, tl, qidx, lj)):
        ref_rev = [np.asarray(a) for a in _align_starts_qm(
            prof, tc, jnp.asarray(qe), jnp.asarray(te), Lq, Lt, True)]
        revs.append([a.numpy() for a in sw_cuda.qm_starts(
            *args, *_torch(qe, te))])
        for name, a, b in zip(("score", "q_start", "t_start"), ref_rev,
                              revs[-1]):
            np.testing.assert_array_equal(a, b, name)
    np.testing.assert_array_equal(revs[0][0], got[0])
    _check_planted(expect, got, revs[1])


@pytest.mark.parametrize("what", ["ties", "run"])
def test_planted_edges_over_512_rows_match_numpy_oracle(what):
    """The planted ties of queries over 512 rows (the 511/512 row-stripe
    edge and the last stripe's lane and group edges), each alone in a tile
    at Lq = Lt = 1152, or the run of 1,100 rows ending at q_len - 1 and
    t_len - 1, against ops/sw.py."""
    keep = (lambda n, m, e: n > 512 and e is not None) if what == "ties" \
        else (lambda n, m, e: n == m == 1100)
    (q, qb, ql, t, tl, qidx, lj), expect = _edge_tiles(1152, 1152, keep)
    assert len(qidx) == (14 + 18 if what == "ties" else 1)
    args = _torch(q, qb, ql, t, tl, qidx, lj)
    fwd = [a.numpy() for a in sw_cuda.qm_ends(*args)]
    rev = [a.numpy() for a in sw_cuda.qm_starts(
        *args, *_torch(*_lane_ends(ql, tl, qidx, lj)))]
    _check_planted(expect, fwd, rev)
    for k, b in enumerate(range(0, len(lj), TB)):
        i, j = qidx[k], lj[b]
        ref = sw_align(q[i, :ql[i]], t[j, :tl[j]], qb[i, :ql[i]])
        assert (fwd[0][b], fwd[1][b], fwd[2][b]) == (
            ref["score"], ref["q_end"], ref["t_end"]), k
        if what == "run":   # over the whole matrix: the run's start
            assert (rev[0][b], rev[1][b], rev[2][b]) == (ref["score"], 0,
                                                         0)


def _capped_end(profile, target, cap=32767):
    """ops/sw.py's sw_end with H capped at `cap`, the Pallas kernels'
    contract (the oracle has no cap): (score, q_end, t_end)."""
    n = profile.shape[0]
    H = np.zeros(n, np.int64)
    E = np.zeros(n, np.int64)
    best, q_end, t_end = 0, n - 1, -1
    go, ge = 11, 1
    for j in range(len(target)):
        Hd = np.concatenate(([0], H[:-1]))
        G = np.maximum(0, np.maximum(Hd + profile[:, target[j]], E))
        M = np.maximum.accumulate(G + np.arange(n) * ge)
        F = np.concatenate(([-10 ** 9], M[:-1])) - go \
            - (np.arange(n) - 1) * ge
        Hn = np.minimum(np.maximum(G, F), cap)
        if Hn.max() > best:
            best, q_end, t_end = int(Hn.max()), int(np.argmax(Hn)), j
        E = np.maximum(np.maximum(E - ge, Hn - go), 0)
        H = Hn
    return best, q_end, t_end


@pytest.mark.parametrize("Lq,qn", [(1024, 1000), (4096, 3500)])
def test_long_queries_match_numpy_oracle_and_the_cap(Lq, qn):
    """A query of qn aa in the Lq tier against 24 targets of 150-300 aa.
    The query holds a 290-aa run of W and C at bias +120, which two targets
    hold too: H passes 32767 against those and against every target long
    enough (the oracle's uncapped score above the cap, the capped ends
    against _capped_end); the other lanes against ops/sw.py, forward and
    from the forward ends."""
    from metaeuk_tpu_torch.data.submat import encode_aa
    rng = np.random.default_rng(Lq)
    W, C = (int(encode_aa(r)[0]) for r in (b"W", b"C"))
    Lt, nt = 320, 24
    q = rng.integers(0, 20, (1, Lq)).astype(np.int32)
    qb = rng.integers(-3, 4, (1, Lq)).astype(np.int32)
    t = rng.integers(0, 20, (nt, Lt)).astype(np.int32)
    tl = rng.integers(150, 301, nt).astype(np.int32)
    run = rng.choice([W, C], 290)
    r0 = qn - 400
    q[0, r0:r0 + 290], qb[0, r0:r0 + 290] = run, 120
    t[0, 5:295], t[1, :290], tl[:2] = run, run, (300, 290)
    for k in range(2, nt, 3):   # shared segments at bias 0
        a = int(rng.integers(0, qn - 60))
        t[k, 10:60] = q[0, a:a + 50]
    ql = np.array([qn], np.int32)
    qidx = np.zeros(1, np.int32)
    lj = np.full(TB, -1, np.int32)
    lj[:nt] = rng.permutation(nt)
    args = _torch(q, qb, ql, t, tl, qidx, lj)
    fwd = [a.numpy() for a in sw_cuda.qm_ends(*args)]
    rev = [a.numpy() for a in sw_cuda.qm_starts(
        *args, *_torch(np.maximum(fwd[1], 0), np.maximum(fwd[2], 0)))]
    np.testing.assert_array_equal(rev[0], fwd[0])
    from metaeuk_tpu.data.submat import BLOSUM62_SCORES
    prof = BLOSUM62_SCORES[q[0, :qn]].astype(np.int64) \
        + qb[0, :qn].astype(np.int64)[:, None]
    capped = 0
    for b in range(nt):
        j = lj[b]
        got = (fwd[0][b], fwd[1][b], fwd[2][b])
        ref = sw_align(q[0, :qn], t[j, :tl[j]], qb[0, :qn])
        if ref["score"] > 32767:
            capped += 1
            assert got == _capped_end(prof, t[j, :tl[j]]), b
        else:
            assert got == (ref["score"], ref["q_end"], ref["t_end"]), b
            if ref["score"] > 0:
                assert (rev[1][b], rev[2][b]) == (ref["q_start"],
                                                  ref["t_start"]), b
    assert capped == (fwd[0] == 32767).sum() >= 2
    planted = np.flatnonzero((lj >= 0) & (lj < 2))
    assert fwd[0][planted].tolist() == [32767, 32767]


@pytest.mark.gpu
def test_kernels_match_plain_on_planted_edges_on_card(cuda_device):
    """chip_smoke's K3/K4 edge and cap checks on the card: qm_edge_tiles at
    QM_EDGE_WIDTH (ties on either side of every lane, group and row-stripe
    edge of the classes, forward and reverse) and qm_cap_tiles at
    QM_CAP_SHAPE (a 3,500-aa self-match whose H passes 32767)."""
    smoke = _smoke()
    errs = dict.fromkeys(smoke.KERNELS, 0)
    sw_cuda.reset_counts()
    smoke.check_qm_edges(torch, sw_cuda, sw_torch, errs)
    assert errs["sw_qm_ends"] == errs["sw_qm_starts"] == 0
    assert sw_cuda.LAUNCHES["sw_qm_ends"] == 2
