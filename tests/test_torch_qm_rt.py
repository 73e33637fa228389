"""The port's row-tiled query-major SW (metaeuk_tpu_torch, K5/K6) against the
JAX package.

The plain row-tiled versions (what the wrappers run on a CPU tensor) are
held to the Pallas kernels _dp_kernel_qm_rt / _dp_kernel_qm_rev_rt in
interpret mode (metaeuk_tpu/ops/sw_pallas.py _qm_call_rt, with QM_TQ shrunk
to 64 as tests/test_sw_pallas.py does), and to the untiled plain versions;
the port's driver, which sends fragments longer than 4096 aa to them, is
held to the JAX driver's hit arrays. Every output is an integer: the
tolerance is exact equality. The CUDA kernels (csrc/sw_qm_rt.cu: a warp per
lane, 16 target columns a thread, stripes of 512 columns, no row tile) are
held to the plain versions on the card (marker gpu); ties are planted on
either side of their column boundaries, and the driver's launch cap for
them is checked on the host.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metaeuk_tpu.ops.sw_pallas as sp
import metaeuk_tpu_torch.search.driver as torch_driver
from metaeuk_tpu.params import Params
from metaeuk_tpu_torch.data.submat import encode_aa
from metaeuk_tpu_torch.ops import sw_cuda, sw_torch

from test_torch_qm import (_TargetDB, _assert_same_hits, _jax_hits, _staged,
                           _synthetic, _tiles, _torch, cuda_device,  # noqa: F401
                           qm_env)  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TQ = 64   # the shrunk row tile of the Pallas comparison


def _tie_case(Lq, Lt, rA, rB, cA, cB, n=24, seed=31):
    """One query with a segment A at rows rA and a permutation B of it (the
    same self-score) at rows rB, and one target holding B at columns cB and
    A at columns cA; the query's other rows carry a bias of -4, so neither
    copy extends. With rA, rB in different row tiles, the forward and the
    reverse best are each a tie between tiles."""
    rng = np.random.default_rng(seed)
    A = rng.integers(0, 20, n)
    B = rng.permutation(A)
    q = rng.integers(0, 20, (1, Lq)).astype(np.int32)
    qb = np.full((1, Lq), -4, np.int32)
    q[0, rA:rA + n], q[0, rB:rB + n] = A, B
    qb[0, rA:rA + n] = qb[0, rB:rB + n] = 0
    t = rng.integers(0, 20, (1, Lt)).astype(np.int32)
    t[0, cA:cA + n], t[0, cB:cB + n] = A, B
    return (q, qb, np.array([Lq], np.int32), t, np.array([Lt], np.int32))


def _jax_rt(q, qb, ql, t, tl, qidx, lj, monkeypatch, rev_ends=None):
    """Pallas K5 then K6 from its clamped ends (or from rev_ends, (qe, te)
    per lane), interpret mode, QM_TQ 64."""
    monkeypatch.setattr(sp, "QM_TQ", TQ)
    Lq, Lt = q.shape[1], t.shape[1]
    prof = sp.build_prof_tiles(jnp.asarray(q), jnp.asarray(qb),
                               jnp.asarray(ql), jnp.asarray(qidx), Lq)
    tc = sp.build_tcodes_T(jnp.asarray(t), jnp.asarray(tl), jnp.asarray(lj),
                           Lt)
    ends = [np.asarray(a) for a in sp._qm_call_rt(
        sp._dp_kernel_qm_rt, 0, Lq, Lt, len(qidx), prof, tc, (), 3, True)]
    qe, te = rev_ends or (np.maximum(ends[1], 0), np.maximum(ends[2], 0))
    qe, te = (jnp.asarray(np.asarray(e, np.int32).reshape(1, -1))
              for e in (qe, te))
    starts = [np.asarray(a) for a in sp._qm_call_rt(
        sp._dp_kernel_qm_rev_rt, 2, Lq, Lt, len(qidx), prof, tc, (qe, te), 3,
        True)]
    return ends, starts


def _port_rt(q, qb, ql, t, tl, qidx, lj, tq=TQ):
    args = _torch(q, qb, ql, t, tl, qidx, lj.reshape(-1))
    ends = sw_cuda.qm_ends_rt(*args, tq=tq)
    starts = sw_cuda.qm_starts_rt(*args, torch.clamp_min(ends[1], 0),
                                  torch.clamp_min(ends[2], 0), tq=tq)
    return [e.numpy() for e in ends], [s.numpy() for s in starts]


def _assert_equal(ref, got, names):
    for name, a, b in zip(names, ref, got):
        np.testing.assert_array_equal(a, b, name)


# (nq, Lq, nt, Lt, n_tiles): four and five row tiles of 64 with ragged
# query lengths (a tile past every query's end included), padding lanes and
# a padding tile, repeated targets
@pytest.mark.parametrize("nq,Lq,nt,Lt,nT", [(3, 256, 9, 72, 3),
                                            (2, 320, 6, 48, 2)])
def test_plain_rt_matches_pallas_interpret(monkeypatch, nq, Lq, nt, Lt, nT):
    q, qb, ql, t, tl = _staged(Lq + Lt, nq, Lq, nt, Lt)
    ql[0] = Lq - 70
    qidx, lj = _tiles(Lq, nq, nt, nT)
    qidx[0] = 0
    ref_e, ref_s = _jax_rt(q, qb, ql, t, tl, qidx, lj, monkeypatch)
    got_e, got_s = _port_rt(q, qb, ql, t, tl, qidx, lj)
    _assert_equal(ref_e, got_e, ("score", "q_end", "t_end"))
    _assert_equal(ref_s, got_s, ("score", "q_start", "t_start"))
    assert (ref_e[0] > 0).sum() > 10
    assert (ref_e[1][ref_e[0] > 0] >= TQ).any()   # ends past the first tile


@pytest.mark.parametrize("rA,rB,cA,cB", [(10, 150, 70, 5),
                                         (10, 150, 5, 70)])
def test_ties_across_row_tiles_follow_the_pallas_order(monkeypatch, rA, rB,
                                                       cA, cB):
    """An equal score in two row tiles: forward, the first column wins, so
    the later tile's when its column comes first; reverse (from the end
    that spans the whole matrix), the last column wins. Both against the
    Pallas kernels and against the expected cells."""
    n, Lq, Lt = 24, 256, 120
    q, qb, ql, t, tl = _tie_case(Lq, Lt, rA, rB, cA, cB, n)
    qidx = np.zeros(1, np.int32)
    lj = np.full((1, sw_torch.TB), -1, np.int32)
    lj[0, :3] = 0
    ref_e, ref_s = _jax_rt(q, qb, ql, t, tl, qidx, lj, monkeypatch)
    got_e, got_s = _port_rt(q, qb, ql, t, tl, qidx, lj)
    _assert_equal(ref_e, got_e, ("score", "q_end", "t_end"))
    _assert_equal(ref_s, got_s, ("score", "q_start", "t_start"))
    # forward: the copy at the first columns, whichever tile holds it
    first = (rB, cB) if cB < cA else (rA, cA)
    assert (got_e[1][0], got_e[2][0]) == (first[0] + n - 1, first[1] + n - 1)
    # reverse over the whole matrix: the copy at the last columns
    args = _torch(q, qb, ql, t, tl, qidx, lj.reshape(-1))
    full = torch.full((sw_torch.TB,), Lq - 1, dtype=torch.int32)
    score, q_start, t_start = (a.numpy() for a in sw_cuda.qm_starts_rt(
        *args, full, full * 0 + Lt - 1, tq=TQ))
    assert score[0] == got_e[0][0]
    assert (q_start[0], t_start[0]) == ((rA, cA) if cA > cB else (rB, cB))
    un = sw_torch.qm_starts(*args, full, full * 0 + Lt - 1)
    _assert_equal([u.numpy() for u in un], (score, q_start, t_start),
                  ("score", "q_start", "t_start"))


# (W column, C column) of each lane's target: a tie one column apart on
# either side of the CUDA kernels' thread edge (15/16, at 16 columns a
# thread) and stripe edge (511/512)
COLUMN_TIES = ((16, 15), (15, 16), (512, 511), (511, 512))


@pytest.mark.parametrize("w_row", ["first", "last"])
def test_ties_across_kernel_column_boundaries_follow_the_pallas_order(
        monkeypatch, w_row):
    """W (bias -2) and C (bias 0) each score 9 against their own residue,
    one in the first and one in the last row of a query of three row tiles;
    every other cell scores below 0. Each lane's target (600 of 1024
    columns, so the kernels run 16 columns a thread and two stripes) holds
    W and C one column apart across a boundary. Forward the first column
    wins, reverse over the whole matrix the last one: the plain versions
    against the Pallas kernels in interpret mode and against those cells."""
    Lq, Lt, n_t = 3 * TQ, 1024, 600
    W, C = (int(encode_aa(r)[0]) for r in (b"W", b"C"))
    rng = np.random.default_rng(51)
    other = [a for a in range(20) if a not in (W, C)]
    q = rng.choice(other, (1, Lq)).astype(np.int32)
    qb = np.full((1, Lq), -9, np.int32)
    rW, rC = (0, Lq - 1) if w_row == "first" else (Lq - 1, 0)
    q[0, rW], qb[0, rW], q[0, rC], qb[0, rC] = W, -2, C, 0
    t = rng.choice(other, (len(COLUMN_TIES), Lt)).astype(np.int32)
    for k, (w, c) in enumerate(COLUMN_TIES):
        t[k, w], t[k, c] = W, C
    ql = np.array([Lq], np.int32)
    tl = np.full(len(COLUMN_TIES), n_t, np.int32)
    qidx = np.zeros(1, np.int32)
    lj = np.full((1, sw_torch.TB), -1, np.int32)
    lj[0, :len(COLUMN_TIES)] = np.arange(len(COLUMN_TIES))
    whole = (np.full(sw_torch.TB, Lq - 1), np.full(sw_torch.TB, n_t - 1))
    ref_e, ref_s = _jax_rt(q, qb, ql, t, tl, qidx, lj, monkeypatch, whole)
    args = _torch(q, qb, ql, t, tl, qidx, lj.reshape(-1))
    got_e = [e.numpy() for e in sw_cuda.qm_ends_rt(*args, tq=TQ)]
    got_s = [s.numpy() for s in sw_cuda.qm_starts_rt(
        *args, *(torch.from_numpy(e).int() for e in whole), tq=TQ)]
    _assert_equal(ref_e, got_e, ("score", "q_end", "t_end"))
    _assert_equal(ref_s, got_s, ("score", "q_start", "t_start"))
    for k, (w, c) in enumerate(COLUMN_TIES):
        first, last = sorted([(w, rW), (c, rC)])
        assert got_e[0][k] == got_s[0][k] == 9
        assert (got_e[1][k], got_e[2][k]) == (first[1], first[0])
        assert (got_s[1][k], got_s[2][k]) == (last[1], last[0])


@pytest.mark.parametrize("tq", [1, 7, 64, 1000])
def test_any_row_tile_gives_the_untiled_result(tq):
    """K5/K6's function does not depend on the row-tile size: tq 1, a size
    that divides nothing, and one tile for the whole query (tq >= Lq) all
    equal qm_ends / qm_starts, with random ends past the lengths too."""
    nq, Lq, nt, Lt, nT = 3, 90, 7, 40, 3
    q, qb, ql, t, tl = _staged(5, nq, Lq, nt, Lt)
    qidx, lj = _tiles(6, nq, nt, nT)
    args = _torch(q, qb, ql, t, tl, qidx, lj.reshape(-1))
    ends = sw_torch.qm_ends(*args)
    _assert_equal([e.numpy() for e in ends],
                  [e.numpy() for e in sw_torch.qm_ends_rt(*args, tq=tq)],
                  ("score", "q_end", "t_end"))
    rng = np.random.default_rng(tq)
    B = nT * sw_torch.TB
    for qe, te in ((torch.clamp_min(ends[1], 0), torch.clamp_min(ends[2], 0)),
                   (torch.from_numpy(rng.integers(-1, Lq + 2, B)).int(),
                    torch.from_numpy(rng.integers(-1, Lt + 2, B)).int())):
        _assert_equal(
            [s.numpy() for s in sw_torch.qm_starts(*args, qe, te)],
            [s.numpy() for s in sw_torch.qm_starts_rt(*args, qe, te, tq=tq)],
            ("score", "q_start", "t_start"))


def test_no_hit_values_follow_the_pallas_contract():
    """Padding lanes, a padding tile and zero-length rows: forward (0, Lq-1,
    -1) with Lq the tier width, reverse (0, 0, -1)."""
    nq, Lq, nt, Lt = 3, 200, 6, 40
    q, qb, ql, t, tl = _staged(9, nq, Lq, nt, Lt)
    qidx = np.array([nq - 1, 0, -1], np.int32)   # zero-length query row
    lj = np.full((3, sw_torch.TB), -1, np.int32)
    lj[0, :4] = [0, 1, 2, 3]
    lj[1, :2] = [nt - 1, nt - 1]                # zero-length target row
    args = _torch(q, qb, ql, t, tl, qidx, lj.reshape(-1))
    score, q_end, t_end = (a.numpy() for a in sw_cuda.qm_ends_rt(*args,
                                                                  tq=TQ))
    assert (score == 0).all() and (q_end == Lq - 1).all() \
        and (t_end == -1).all()
    zeros = torch.zeros(3 * sw_torch.TB, dtype=torch.int32)
    score, q_start, t_start = (a.numpy() for a in sw_cuda.qm_starts_rt(
        *args, zeros + Lq, zeros + Lt, tq=TQ))
    assert (score == 0).all() and (q_start == 0).all() \
        and (t_start == -1).all()


def test_cpu_tensors_take_the_plain_versions():
    q, qb, ql, t, tl = _staged(3, 2, 130, 4, 24)
    qidx, lj = _tiles(3, 2, 4, 2)
    args = _torch(q, qb, ql, t, tl, qidx, lj.reshape(-1))
    sw_cuda.reset_counts()
    ends = sw_cuda.qm_ends_rt(*args)
    sw_cuda.qm_starts_rt(*args, torch.clamp_min(ends[1], 0),
                         torch.clamp_min(ends[2], 0))
    assert sw_cuda.PLAIN_CALLS["sw_qm_rt_ends"] == 1
    assert sw_cuda.PLAIN_CALLS["sw_qm_rt_starts"] == 1
    assert not any(sw_cuda.LAUNCHES.values())


def test_other_devices_raise():
    q, qb, ql, t, tl = _staged(3, 2, 24, 4, 24)
    qidx, lj = _tiles(3, 2, 4, 2)
    args = [a.to("meta") for a in _torch(q, qb, ql, t, tl, qidx,
                                         lj.reshape(-1))]
    with pytest.raises(ValueError, match="CUDA"):
        sw_cuda.qm_ends_rt(*args)


@pytest.mark.parametrize("Lq", [16384, 65536])
@pytest.mark.parametrize("Lt", [512, 4096])
def test_long_query_launch_cap_follows_the_kernels_memory(Lq, Lt):
    """On the card a K5/K6 launch holds no H/E scratch: against a target
    tier of one stripe (Lt 512) it takes every tile of its bucket; against
    a wider one (Lt 4096) it is cut only by its stripe hand-off, TB * Lq
    words a tile, to RT_STRIPE_BYTES. The plain CPU version and K3/K4 keep
    the query-major cell budget."""
    TB, n_tiles = sw_torch.TB, 5000
    cap = torch_driver.qm_tiles_per_launch("cuda", Lq, Lt, Lt, n_tiles)
    if Lt <= sw_cuda.RT_STRIPE:
        assert cap == n_tiles
    else:
        assert cap == torch_driver.RT_STRIPE_BYTES // (4 * TB * Lq)
        assert cap * TB * Lq * 4 <= torch_driver.RT_STRIPE_BYTES
        assert cap >= 64      # the old H/E scratch cut Lt 4096 to 10
    assert torch_driver.qm_tiles_per_launch("cpu", Lq, Lt, Lt, n_tiles) == 8
    assert torch_driver.qm_tiles_per_launch("cuda", 4096, Lt, Lt, n_tiles) \
        == max(8, torch_driver.QM_CELL_BUDGET["cuda"] // (4096 * Lt * TB))


@pytest.fixture(scope="module")
def long_case():
    """test_sw_pallas.py:182's fragments plus one past 4096 aa; the long
    fragment against every target, the others against 12; the JAX driver's
    hits on those pairs."""
    orfs, targets = _synthetic(long_query=True)
    p = Params()
    p.search_evalue_thr = 1e5
    pairs = np.stack(np.meshgrid(np.arange(len(orfs)),
                                 np.arange(len(targets)),
                                 indexing="ij"), -1).reshape(-1, 2)
    pairs = pairs[(pairs[:, 0] == len(orfs) - 1) | (pairs[:, 1] < 12)]
    return orfs, targets, p, pairs, _jax_hits(orfs, targets, p, pairs)


def test_driver_routes_long_queries_to_the_row_tiled_kernels(qm_env,
                                                            long_case):
    """Under force a fragment past 4096 aa goes to the row-tiled kernels
    whatever its candidate count (driver.py:959-961), the short ones with
    enough candidates query-major; the hits are the JAX driver's."""
    orfs, targets, p, pairs, ref = long_case
    qm_env("force", 12)
    sw_cuda.reset_counts()
    got = torch_driver.SearchDriver(p, _TargetDB(targets), "cpu").search(
        orfs, pairs)
    assert sw_cuda.PLAIN_CALLS["sw_qm_rt_ends"] > 0
    assert sw_cuda.PLAIN_CALLS["sw_qm_rt_starts"] > 0
    assert sw_cuda.PLAIN_CALLS["sw_qm_ends"] > 0
    assert (got["orf_idx"] == len(orfs) - 1).any()
    _assert_same_hits(ref, got)


def test_auto_gate_stays_open_with_a_long_query(qm_env, long_case):
    """Under auto the gate shuts query-major off for a run this small, but a
    query longer than 4096 keeps it open (driver.py:718-719): the long
    fragment takes the row-tiled kernels, fragments with fewer than
    QM_MIN_CANDS candidates the pair kernels; the hits are the JAX
    driver's."""
    orfs, targets, p, pairs, ref = long_case
    qm_env("auto")
    sw_cuda.reset_counts()
    got = torch_driver.SearchDriver(p, _TargetDB(targets), "cpu").search(
        orfs, pairs)
    assert sw_cuda.PLAIN_CALLS["sw_qm_rt_ends"] > 0
    assert sw_cuda.PLAIN_CALLS["sw_qm_ends"] == 0
    assert sw_cuda.PLAIN_CALLS["sw_pair_ends"] > 0
    _assert_same_hits(ref, got)


@pytest.mark.gpu
@pytest.mark.parametrize("nq,Lq,nt,Lt,nT,tq",
                         [(3, 256, 9, 72, 3, 64),
                          (2, 16384, 20, 512, 3, sw_torch.TQ_RT),
                          (2, 16384, 20, 1024, 3, sw_torch.TQ_RT),
                          (2, 16384, 12, 4096, 3, sw_torch.TQ_RT)])
def test_kernels_match_plain_on_card(cuda_device, nq, Lq, nt, Lt, nT, tq):
    q, qb, ql, t, tl = _staged(Lt, nq, Lq, nt, Lt)
    ql[0] = Lq - 5
    qidx, lj = _tiles(Lq, nq, nt, nT)
    args = [a.to(cuda_device) for a in _torch(q, qb, ql, t, tl, qidx,
                                              lj.reshape(-1))]
    ref = sw_torch.qm_ends_rt(*args, tq=tq)
    sw_cuda.reset_counts()
    got = sw_cuda.qm_ends_rt(*args, tq=tq)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    ends = (torch.clamp_min(ref[1], 0), torch.clamp_min(ref[2], 0))
    got = sw_cuda.qm_starts_rt(*args, *ends, tq=tq)
    torch.cuda.synchronize()
    for a, b in zip(got, sw_torch.qm_starts_rt(*args, *ends, tq=tq)):
        assert torch.equal(a, b)
    assert sw_cuda.LAUNCHES["sw_qm_rt_ends"] == 1
    assert sw_cuda.LAUNCHES["sw_qm_rt_starts"] == 1
