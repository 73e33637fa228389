"""The port's gapless scores and ungapped prefilter (metaeuk_tpu_torch) against
the JAX package.

The plain gapless version (what the wrapper runs on a CPU tensor) is held to
metaeuk_tpu/ops/ungapped.py's XLA scan and to its Pallas kernel in
interpret mode, also at the widths of gapless_long (staged Lq >= LONG_ROWS)
on chip_smoke.py's planted runs, and through the cross entry (the
prefilter's launches, gapless_rows below LONG_ROWS) on chip_smoke.py's
planted cross products; the port's UngappedPrefilter to the JAX package's,
pair array for pair array. gapless_pair's work list and layout
(ungapped_cuda.pair_plan, pair_layout) are torch code that runs here as on
the card, and chip_smoke.py's planted pair lists for it are checked on the
plain version. Every output is an integer: the
tolerance is exact equality. The CUDA kernels are held to the plain version
on the card (marker gpu).
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from metaeuk_tpu.io.seqdb import DBTYPE_AA, DBTYPE_NUCL, SeqDB
from metaeuk_tpu.ops.orf import OrfExtractor
from metaeuk_tpu.ops.ungapped import gapless_scores, gapless_scores_xla
from metaeuk_tpu.params import Params
from metaeuk_tpu.search.prefilter import UngappedPrefilter as JaxPrefilter
from metaeuk_tpu_torch.ops import ungapped_cuda, ungapped_torch
from metaeuk_tpu_torch.search import prefilter

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).parent.parent
DATA = ROOT / "tests" / "data"


def _pairs(seed, B, Lq, Lt):
    """Per-pair batch with ragged and zero lengths, a no-hit pair, repeated
    pairs and implanted shared segments; numpy int32."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 20, (B, Lq)).astype(np.int32)
    t = rng.integers(0, 20, (B, Lt)).astype(np.int32)
    qb = rng.integers(-3, 4, (B, Lq)).astype(np.int32)
    ql = rng.integers(1, Lq + 1, B).astype(np.int32)
    tl = rng.integers(1, Lt + 1, B).astype(np.int32)
    ql[0], tl[1] = 0, 0
    for b in range(3, B, 4):
        n = int(min(ql[b], tl[b], 20))
        t[b, 2:2 + n] = q[b, :n]
    q[5::7], qb[5::7], ql[5::7] = q[4], qb[4], ql[4]
    t[5::7], tl[5::7] = t[4], tl[4]
    return q, qb, ql, t, tl


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _long_pairs(Lq, Lt):
    """chip_smoke.long_gapless_pairs at Lq with true lengths from Lq / 2 + 1
    (to 6000 at most): random pairs, then planted runs on the first and
    last diagonals, at gapless_long's chunk edge, across its column tiles
    and up to q_len - 1 and t_len - 1 with padding that would extend
    them."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke.long_gapless_pairs(np, np.random.default_rng(Lt), Lq,
                                         Lt, Lq // 2 + 1, min(Lq, 6000))


@pytest.mark.parametrize("B,Lq,Lt", [(64, 48, 80), (40, 130, 33)])
def test_plain_gapless_matches_xla(B, Lq, Lt):
    q, qb, ql, t, tl = _pairs(Lq, B, Lq, Lt)
    ref = np.asarray(gapless_scores_xla(q, qb, ql, t, Lq, Lt, t_len=tl))
    got = ungapped_cuda.gapless_scores(*_torch(q, qb, ql, t, tl)).numpy()
    np.testing.assert_array_equal(ref, got)
    assert ref.max() > 15


def test_plain_gapless_matches_pallas_interpret():
    B, Lq, Lt = 128, 32, 40
    q, qb, ql, t, tl = _pairs(3, B, Lq, Lt)
    ref = gapless_scores(q, qb, ql, t, tl, interpret=True)
    got = ungapped_cuda.gapless_scores(*_torch(q, qb, ql, t, tl)).numpy()
    np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize("Lq,Lt", [(8192, 64), (8192, 1100), (1024, 1100)])
def test_plain_gapless_matches_xla_at_long_widths(Lq, Lt):
    q, qb, ql, t, tl = _long_pairs(Lq, Lt)
    ref = np.asarray(gapless_scores_xla(q, qb, ql, t, Lq, Lt, t_len=tl))
    ungapped_cuda.reset_counts()
    got = ungapped_cuda.gapless_scores(*_torch(q, qb, ql, t, tl)).numpy()
    assert ungapped_cuda.PLAIN_CALLS == {"gapless_pair": 0,
                                         "gapless_long": 1,
                                         "gapless_rows": 0}
    np.testing.assert_array_equal(ref, got)
    # the single cells of the first and last diagonals score W-W (11), and
    # the runs cut at q_len - 1 and t_len - 1 pass 128 but stop there
    assert got[3] == got[4] == 11
    assert min(got[-2:]) > 128
    assert got[2] == 0


def test_long_rows_route_to_gapless_long():
    """Fragments over 512 aa (the prefilter's buckets from 1024 up) go to
    gapless_long, shorter ones to gapless_pair; on the CPU both count as
    plain calls under the kernel the route picked."""
    assert ungapped_cuda.LONG_ROWS == 1024
    for n, name in ((512, "gapless_pair"), (513, "gapless_long"),
                    (4097, "gapless_long"), (32734, "gapless_long"),
                    (20, "gapless_pair")):
        assert ungapped_cuda.kernel_for(prefilter._bucket(n)) == name
    ungapped_cuda.reset_counts()
    for Lq in (512, 1024, 8192):
        args = _torch(*_pairs(Lq, 8, Lq, 32))
        ungapped_cuda.gapless_scores(*args)
    assert ungapped_cuda.PLAIN_CALLS == {"gapless_pair": 1,
                                         "gapless_long": 2,
                                         "gapless_rows": 0}
    assert ungapped_cuda.LAUNCHES == dict.fromkeys(ungapped_cuda.KERNELS, 0)


def test_long_kernel_takes_scores_that_fit_its_int16_profile():
    """gapless_long keeps submat + bias (an int8) as int16: the wrapper's
    check passes BLOSUM62 and refuses a score it could not hold."""
    from metaeuk_tpu_torch.ops.sw_cuda import check_scores_fit
    from metaeuk_tpu_torch.state import default_scoring
    check_scores_fit(default_scoring("cpu").submat, -32640, 32639,
                     "gapless_long")
    big = torch.full((21, 21), 32640, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"gapless_long .*\[-32640, 32639\]"):
        check_scores_fit(big, -32640, 32639, "gapless_long")


def test_gathered_pairs_and_out_of_range_indices():
    """The gathered form scores staged rows by index; an index out of range
    scores 0 (the JAX package pads with li = -1)."""
    nq, Lq, nt, Lt = 6, 40, 9, 56
    q, qb, ql, _, _ = _pairs(1, nq, Lq, Lt)
    _, _, _, t, tl = _pairs(2, nt, Lq, Lt)
    rng = np.random.default_rng(4)
    li = rng.integers(-1, nq + 1, 80).astype(np.int32)
    lj = rng.integers(-1, nt + 1, 80).astype(np.int32)
    got = ungapped_cuda.gapless_scores_gathered(
        *_torch(q, qb, ql, t, tl, li, lj)).numpy()
    ok = (li >= 0) & (li < nq) & (lj >= 0) & (lj < nt)
    lic, ljc = np.where(ok, li, 0), np.where(ok, lj, 0)
    ref = np.asarray(gapless_scores_xla(q[lic], qb[lic], ql[lic], t[ljc], Lq,
                                        Lt, t_len=tl[ljc]))
    np.testing.assert_array_equal(np.where(ok, ref, 0), got)


def _plan_case(case):
    """(li, lj, nq, nt, t_lens) of a pair list for gapless_pair's plan: a
    cross product in order, the same shuffled with repeats, indices of -1
    and past nq and nt, a query with one pair beside one with more pairs
    than a block's 128 threads, and zero-length targets."""
    rng = np.random.default_rng(31)
    nq, nt = 9, 300
    tl = rng.integers(0, 513, nt)
    tl[::50] = 0
    flat = np.arange(nq * nt)
    li, lj = flat // nt, flat % nt
    if case == "shuffled":
        at = rng.permutation(np.concatenate([flat, flat[::7]]))
        li, lj = li[at], lj[at]
    elif case == "out_of_range":
        li = rng.integers(-1, nq + 2, 900)
        lj = rng.integers(-1, nt + 2, 900)
    elif case == "one_and_many":
        li = np.r_[np.full(1, 3), np.full(300, 7), np.full(5, 0)]
        lj = rng.integers(0, nt, len(li))
        li, lj = li[::-1].copy(), lj[::-1].copy()
    return li, lj, nq, nt, tl


@pytest.mark.parametrize("case", ["cross", "shuffled", "out_of_range",
                                  "one_and_many"])
@pytest.mark.parametrize("g", [8, 32, 128])
def test_pair_plan_covers_every_pair_once(case, g):
    """gapless_pair's work list (ungapped_cuda.pair_plan, run here as it runs
    on the card): every pair in range lies in exactly one group, of its own
    query, within a query in the order of the target words (longest target
    first, repeats in input order); pairs out of range in none. Scoring the
    groups' pairs and writing each score to perm's place restores the input
    order: the plain version's scores, 0 out of range."""
    li, lj, nq, nt, tl = _plan_case(case)
    t_lens = torch.from_numpy(tl.astype(np.int32))
    _, order = ungapped_cuda.target_words(
        torch.zeros((nt, 8), dtype=torch.uint8), t_lens, 21)
    rank = torch.empty_like(order)
    rank[order.long()] = torch.arange(nt, dtype=torch.int32)
    perm, grp_q, grp_p0, grp_n = ungapped_cuda.pair_plan(
        torch.from_numpy(li), torch.from_numpy(lj), rank, nq, nt, g)
    assert grp_n.max() <= g and len(grp_q) == -(-len(li) // g) + min(nq,
                                                                     len(li))
    lane = torch.arange(g)
    live = lane[None, :] < grp_n[:, None]
    pos = (grp_p0[:, None] + lane[None, :])[live]
    b = perm[pos].numpy()
    ok = (li >= 0) & (li < nq) & (lj >= 0) & (lj < nt)
    assert sorted(b.tolist()) == np.flatnonzero(ok).tolist()
    np.testing.assert_array_equal(
        li[b], grp_q[:, None].expand(-1, g)[live].numpy())
    # query by query, targets in word order, repeats in input order
    key = np.stack([li[b], rank.numpy()[lj[b]], b])
    assert (np.diff(key[0]) >= 0).all()
    assert (np.lexsort(key[::-1]) == np.arange(len(b))).all()
    # the kernel's store: each group's scores to perm's places
    nqL, Lq, Lt = nq, 48, 520
    q, qb, ql, _, _ = _pairs(g, nqL, Lq, Lt)
    t = np.random.default_rng(5).integers(0, 20, (nt, Lt))
    args = _torch(q, qb, ql, t, tl.astype(np.int32))
    out = torch.zeros(len(li), dtype=torch.int32)
    if len(b):
        out[torch.from_numpy(b)] = ungapped_torch.gapless_gathered(
            *args, torch.from_numpy(li[b]), torch.from_numpy(lj[b]))
    ref = ungapped_torch.gapless_gathered(*args, torch.from_numpy(li),
                                          torch.from_numpy(lj))
    assert torch.equal(out, ref) and int(ref.max()) > 0


@pytest.mark.parametrize("Lq,Lt", [(32, 64), (64, 128)])
def test_pair_lists_of_phase_3_score_their_plants(Lq, Lt):
    """chip_smoke.check_gapless_pairs' inputs on the plain version: the
    cross list's planted pairs (cross_gapless_rows' and plant_band_runs'
    runs on each lane of a band of four diagonals) score their plants, each
    list's scores are the cross product's, and one_and_many gives query 3
    more pairs than a block's 128 threads."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    rng = np.random.default_rng(Lq)
    nq, nt = 16, 140
    q, qb, ql, t, tl, plants = chip_smoke.cross_gapless_rows(np, rng, Lq, Lt,
                                                             nq, nt)
    chip_smoke.plant_band_runs(np, rng, q, qb, ql, t, tl, plants)
    assert len(plants) == 8
    args = _torch(q, qb, ql, t, tl)
    lists = chip_smoke.gapless_pair_lists(np, rng, nq, nt)
    li, lj = (torch.from_numpy(a) for a in lists["cross"])
    cross = ungapped_torch.gapless_gathered(*args, li, lj).view(nq, nt)
    assert {k: int(cross[k]) for k in plants} == plants
    for name, (li, lj) in lists.items():
        got = ungapped_torch.gapless_gathered(*args, *_torch(li, lj))
        ok = (li >= 0) & (li < nq) & (lj >= 0) & (lj < nt)
        want = np.where(ok, cross.numpy()[np.where(ok, li, 0),
                                          np.where(ok, lj, 0)], 0)
        np.testing.assert_array_equal(got.numpy(), want)
    one_li = lists["one_and_many"][0]
    assert (one_li == 0).sum() == 1 and (one_li == 3).sum() > 128


def test_pair_layout_fits_the_profiles():
    """c follows the pairs a query has on average, up to a block, and grows
    until the profiles of a block's groups fit its budget; a launch of few
    pairs deals each pair's bands over up to 32 threads; a width whose one
    profile passes the shared memory goes to gapless_long instead."""
    layout = ungapped_cuda.pair_layout
    assert layout(262144, 88, 128, 21) == (128, 1)
    assert layout(4194300, 349525, 32, 21) == (16, 1)
    assert layout(300, 250, 512, 21) == (2, 32)
    assert layout(2000, 1500, 128, 21) == (2, 32)
    assert layout(20000, 15000, 32, 21) == (2, 8)
    for B, nq, Lq in ((300, 250, 512), (2000, 1500, 128), (20000, 15000, 32),
                      (4194300, 349525, 32), (64, 64, 1024)):
        c, split = layout(B, nq, Lq, 21)
        g = c * split
        assert ungapped_cuda.PAIR_THREADS % g == 0 and split <= 32
        assert (128 // g) * (Lq + 4) * 22 * 2 <= max(
            ungapped_cuda.PAIR_PROF_BYTES, (Lq + 4) * 44)
    with pytest.raises(ValueError, match="gapless_long"):
        layout(64, 4, 8192, 21)


def test_cpu_tensors_take_the_plain_version():
    args = _torch(*_pairs(5, 16, 24, 24))
    ungapped_cuda.reset_counts()
    got = ungapped_cuda.gapless_scores(*args)
    assert ungapped_cuda.PLAIN_CALLS == {"gapless_pair": 1,
                                         "gapless_long": 0,
                                         "gapless_rows": 0}
    assert ungapped_cuda.LAUNCHES == dict.fromkeys(ungapped_cuda.KERNELS, 0)
    pairs = torch.arange(16)
    assert torch.equal(got, ungapped_torch.gapless_gathered(*args, pairs,
                                                            pairs))


def test_other_devices_raise():
    args = [a.to("meta") for a in _torch(*_pairs(5, 8, 24, 24))]
    pairs = torch.arange(8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ungapped_cuda.gapless_scores_gathered(*args, pairs, pairs)


def _cross(Lq, Lt, nq, nt):
    """chip_smoke.cross_gapless_rows: staged matrices of a cross product
    with planted runs, and {(row, target): score} of the plants."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke.cross_gapless_rows(np, np.random.default_rng(nt), Lq,
                                         Lt, nq, nt)


def _xla_cross(q, qb, ql, t, tl, r0, r1):
    li = np.repeat(np.arange(r0, r1), len(t))
    lj = np.tile(np.arange(len(t)), r1 - r0)
    return np.asarray(gapless_scores_xla(
        q[li], qb[li], ql[li], t[lj], q.shape[1], t.shape[1],
        t_len=tl[lj])).reshape(r1 - r0, len(t))


@pytest.mark.parametrize("Lq,Lt,nq,nt", [(32, 48, 9, 20), (32, 48, 6, 150),
                                         (512, 96, 6, 20), (512, 96, 6, 140)])
def test_plain_cross_matches_xla(Lq, Lt, nq, nt):
    """The cross entry on the CPU (the prefilter's launch, gapless_rows's
    plain version) with target blocks narrower and wider than a block's
    32-128 targets: the first and last diagonals' single cells, runs cut at
    q_len - 1 and t_len - 1 with padding that would extend them, rows and
    targets of length 0, repeated targets."""
    q, qb, ql, t, tl, plants = _cross(Lq, Lt, nq, nt)
    assert ql[1] == 0 and tl[2] == 0 and np.array_equal(t[4], t[0])
    ungapped_cuda.reset_counts()
    got = ungapped_cuda.gapless_scores_cross(*_torch(q, qb, ql, t, tl), 0,
                                             nq).numpy()
    assert ungapped_cuda.PLAIN_CALLS == {"gapless_pair": 0,
                                         "gapless_long": 0,
                                         "gapless_rows": 1}
    assert got.shape == (nq, nt) and got.dtype == np.int32
    np.testing.assert_array_equal(_xla_cross(q, qb, ql, t, tl, 0, nq), got)
    assert {k: int(got[k]) for k in plants} == plants
    assert min(plants.values()) == 11 and max(plants.values()) > 40
    assert not got[1].any() and not got[:, 2].any()
    np.testing.assert_array_equal(got[:, 4], got[:, 0])


def test_plain_cross_matches_pallas_interpret():
    nq, Lq, nt, Lt = 6, 32, 40, 40
    q, qb, ql, t, tl, plants = _cross(Lq, Lt, nq, nt)
    li = np.repeat(np.arange(1, nq), nt)
    lj = np.tile(np.arange(nt), nq - 1)
    ref = gapless_scores(q[li], qb[li], ql[li], t[lj], tl[lj],
                         interpret=True).reshape(nq - 1, nt)
    got = ungapped_cuda.gapless_scores_cross(*_torch(q, qb, ql, t, tl), 1,
                                             nq).numpy()
    np.testing.assert_array_equal(ref, got)
    assert {k: int(got[k[0] - 1, k[1]]) for k in plants} == plants


def test_cross_entry_routes_and_counts():
    """Cross products go to gapless_rows below LONG_ROWS and gapless_long
    from it; on the CPU each call counts one plain call under that kernel
    and launches nothing. The output equals the gathered form on the same
    pairs; rows out of range raise."""
    for n, name in ((20, "gapless_rows"), (512, "gapless_rows"),
                    (513, "gapless_long"), (32734, "gapless_long")):
        assert ungapped_cuda.kernel_for(prefilter._bucket(n),
                                        cross=True) == name
    ungapped_cuda.reset_counts()
    for Lq in (32, 512, 1024):
        q, qb, ql, t, tl = _torch(*_pairs(Lq, 7, Lq, 40))
        got = ungapped_cuda.gapless_scores_cross(q, qb, ql, t, tl, 2, 6)
        li = torch.arange(2, 6).repeat_interleave(7)
        lj = torch.arange(7).repeat(4)
        assert torch.equal(got, ungapped_torch.gapless_gathered(
            q, qb, ql, t, tl, li, lj).view(4, 7))
    assert ungapped_cuda.gapless_scores_cross(q, qb, ql, t, tl, 3,
                                              3).shape == (0, 7)
    assert ungapped_cuda.PLAIN_CALLS == {"gapless_pair": 0,
                                         "gapless_long": 2,
                                         "gapless_rows": 2}
    assert ungapped_cuda.LAUNCHES == dict.fromkeys(ungapped_cuda.KERNELS, 0)
    with pytest.raises(ValueError, match="query rows"):
        ungapped_cuda.gapless_scores_cross(q, qb, ql, t, tl, 5, 8)


def test_rows_kernel_target_words_layout():
    """gapless_rows reads its targets as words of four codes, longest
    target first, column 4c - 8 + k in byte k of word c, and the code alph
    (a profile entry of 0) left of column 0 and from each length on."""
    _, _, _, t, tl = _pairs(9, 6, 8, 13)
    tl[2] = 20   # a length past the staged width
    words, order = ungapped_cuda.target_words(*_torch(t, tl), 21)
    assert words.shape == (8, 6) and words.dtype == torch.int32
    assert order.tolist() == sorted(range(6), key=lambda k: (-tl[k], k))
    codes = words.numpy().view(np.uint8).reshape(8, 6, 4)
    for s, k in enumerate(order.tolist()):
        col = codes[:, s].reshape(-1)   # byte 4c + b is column 4c + b - 8
        n = min(int(tl[k]), 13)
        np.testing.assert_array_equal(col[8:8 + n], t[k, :n])
        assert (col[:8] == 21).all() and (col[8 + n:] == 21).all()


@pytest.mark.parametrize("lens,r0,r1", [
    ([5, 3, 9, 3, 1, 7, 2], 0, 7),
    ([5, 3, 9, 3, 1, 7, 2], 2, 6),
    ([4, 0, 4, 8, 0, 2, 6, 6, 1], 1, 8),
    ([12, 3], 1, 2),
])
def test_row_pairs_pair_neighbours_by_length(lens, r0, r1):
    """gapless_rows's pairing of rows r0..r1: every row once, as an offset
    from r0, in order of length (ties by index), so the two lengths of a
    pair are neighbours; an odd count ends with -1, an absent row, beside
    the longest row."""
    got = ungapped_cuda.row_pairs(torch.tensor(lens, dtype=torch.int32), r0,
                                  r1)
    n = r1 - r0
    assert got.dtype == torch.int32 and got.shape == (2 * -(-n // 2),)
    rows = got.tolist()
    if n % 2:
        assert rows.pop() == -1
    assert rows == sorted(range(n), key=lambda k: (lens[r0 + k], k))


def test_row_pairs_put_each_score_in_its_input_row():
    """A pair's two scores written to its rows' places, as gapless_rows
    writes them, give the cross entry's matrix for odd and even counts and
    r0 > 0: each row scored once, in its input row."""
    q, qb, ql, t, tl, _ = _cross(32, 48, 9, 20)
    args = _torch(q, qb, ql, t, tl)
    nt = len(tl)
    for r0, r1 in ((0, 9), (2, 9), (1, 7)):
        want = ungapped_cuda.gapless_scores_cross(*args, r0, r1)
        got = torch.full_like(want, -1)
        for pair in ungapped_cuda.row_pairs(args[2].to(torch.int32), r0,
                                            r1).view(-1, 2).tolist():
            for r in pair:
                if r >= 0:
                    assert (got[r] == -1).all()
                    got[r] = ungapped_torch.gapless_gathered(
                        *args, torch.full((nt,), r0 + r), torch.arange(nt))
        assert torch.equal(got, want)


def _packed_walk(S):
    """The packed loop's arithmetic for one lane, emulated: S (m, n) the
    entries of a query row against a target, zero from the row's length on;
    each diagonal's run advanced as a 16-bit lane (run + entry wrapped to
    int16, then floored at 0); the lane's best."""
    m, n = S.shape
    run = np.zeros(n + m, np.int64)   # the run of diagonal j - i, at j - i + m
    best = 0
    for i in range(m if n else 0):
        d = np.arange(n) - i + m
        run[d] = np.maximum((run[d] + S[i] + 32768) % 65536 - 32768, 0)
        best = max(best, int(run[d].max()))
    return best


@pytest.mark.parametrize("scale", [1, 300])
def test_packed_lanes_are_exact_within_the_row_bound(scale):
    """gapless_rows's argument for its 16-bit lanes, on the plain version:
    a pair walked over its longer row's rows, with zero entries past each
    row's length, in wrapping 16-bit lanes, scores each row as the int32
    recurrence wherever both rows' bound U (the sum over the row of
    max(0, max_a S(i, a))) is at most 32767. With the matrix scaled by 300
    the planted runs pass 16 bits and their lanes wrap: such pairs must take
    the int32 loop."""
    from metaeuk_tpu_torch.data.submat import BLOSUM62_SCORES
    from metaeuk_tpu_torch.state import scoring_from_numpy
    sub = BLOSUM62_SCORES.astype(np.int64) * scale
    scoring = scoring_from_numpy(sub, 11, 1, "cpu")
    q, qb, ql, t, tl, _ = _cross(64, 96, 12, 10)
    want = ungapped_cuda.gapless_scores_cross(*_torch(q, qb, ql, t, tl), 0,
                                              12, scoring=scoring).numpy()
    U = [int(np.maximum(sub.max(1)[q[r, :ql[r]]] + qb[r, :ql[r]], 0).sum())
         for r in range(12)]
    within = wrapped = 0
    for ra, rb in ungapped_cuda.row_pairs(torch.from_numpy(ql).to(
            torch.int32), 0, 12).view(-1, 2).tolist():
        m = max(ql[ra], ql[rb])
        for k in range(10):
            got = []
            for r in (ra, rb):
                S = sub[q[r, :m, None], t[k, None, :tl[k]]] + qb[r, :m, None]
                S[ql[r]:] = 0
                got.append(_packed_walk(S))
            if max(U[ra], U[rb]) <= 32767:
                within += 1
                assert got == [want[ra, k], want[rb, k]]
            else:
                wrapped += got != [want[ra, k], want[rb, k]]
    if scale == 1:
        assert within == 60 and max(U) < 32767
    else:
        assert wrapped > 0 and want.max() > 32767


def test_row_lanes_fold_and_reset(monkeypatch):
    """ROW_LANES takes the kernel's device counts at fold_row_lanes(), which
    zeroes them; reset_counts() zeroes both sides."""
    counts = torch.tensor([7, 3])
    monkeypatch.setitem(ungapped_cuda._ROW_LANES_DEV, torch.device("cpu"),
                        counts)
    ungapped_cuda.reset_counts()
    assert counts.tolist() == [0, 0]
    counts += torch.tensor([7, 3])
    ungapped_cuda.fold_row_lanes()
    counts += torch.tensor([1, 0])
    ungapped_cuda.fold_row_lanes()
    assert ungapped_cuda.ROW_LANES == {"packed": 8, "int32": 3}
    assert counts.tolist() == [0, 0]
    ungapped_cuda.reset_counts()
    assert ungapped_cuda.ROW_LANES == {"packed": 0, "int32": 0}


def test_prefilter_counts_cells_by_query_width():
    lens = np.array([20, 32, 33, 600, 1, 4097])
    cells = prefilter.cells_by_lq(lens, np.array([10, 90]))
    assert cells == {32: 5300, 64: 3300, 1024: 60000, 8192: 409700}
    assert sum(cells.values()) == int(lens.sum()) * 100


def _fragments(contigs_path):
    contigs = SeqDB.from_fasta(contigs_path, DBTYPE_NUCL)
    ex = OrfExtractor(Params())
    frags = []
    for ci in range(len(contigs)):
        _, f = ex.extract_contig(contigs.seq_bytes(ci), ci)
        frags.extend(ex.translate_fragments(f))
    return frags


def _assert_same_pairs(frags, targets, p):
    ref = JaxPrefilter(p, targets, p.min_diag_score).candidate_pairs(frags)
    prefilter.CELLS["gapless"] = 0
    prefilter.CELLS_BY_LQ.clear()
    ungapped_cuda.reset_counts()
    got = prefilter.UngappedPrefilter(p, targets, p.min_diag_score,
                                      device="cpu").candidate_pairs(frags)
    assert got.dtype == np.int64 and got.shape == ref.shape
    np.testing.assert_array_equal(ref, got)
    lens = sum(len(f) for f in frags) * targets.total_residues()
    assert prefilter.CELLS["gapless"] == lens
    assert sum(prefilter.CELLS_BY_LQ.values()) == lens
    # every launch is a cross product on gapless_rows's plain version
    assert ungapped_cuda.PLAIN_CALLS["gapless_rows"] > 0
    assert ungapped_cuda.PLAIN_CALLS["gapless_pair"] == 0
    return got


def test_prefilter_pairs_match_jax_on_fixture():
    targets = SeqDB.from_fasta(DATA / "proteins.faa", DBTYPE_AA)
    got = _assert_same_pairs(_fragments(DATA / "contigs.fna"), targets,
                             Params(prefilter_mode="ungapped"))
    assert len(got) > 100


def test_prefilter_pairs_match_jax_truncated_and_thresholded():
    """A tight --max-seqs and a high --min-ungapped-score cut every list."""
    targets = SeqDB.from_fasta(DATA / "proteins.faa", DBTYPE_AA)
    p = Params(prefilter_mode="ungapped", max_res_list_len=3,
               min_diag_score=25)
    got = _assert_same_pairs(_fragments(DATA / "contigs.fna"), targets, p)
    assert np.bincount(got[:, 0]).max() == 3


def test_prefilter_pairs_match_jax_on_metagenome(tmp_path):
    sys.path.insert(0, str(ROOT))
    from tools.make_metagenome import make_metagenome, write_fasta
    contigs, proteins = make_metagenome(0.003, 60)
    write_fasta(tmp_path / "c.fna", contigs)
    write_fasta(tmp_path / "p.faa", proteins)
    targets = SeqDB.from_fasta(tmp_path / "p.faa", DBTYPE_AA)
    got = _assert_same_pairs(_fragments(tmp_path / "c.fna"), targets,
                             Params(prefilter_mode="ungapped"))
    assert len(got) > 1000


def test_prefilter_of_nothing_is_empty():
    targets = SeqDB.from_fasta(DATA / "proteins.faa", DBTYPE_AA)
    pf = prefilter.UngappedPrefilter(Params(), targets, device="cpu")
    assert pf.candidate_pairs([]).shape == (0, 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,Lq,Lt", [(64, 48, 80), (300, 4096, 700)])
def test_kernel_matches_plain_on_card(cuda_device, B, Lq, Lt):
    args = [a.to(cuda_device) for a in _torch(*_pairs(Lq, B, Lq, Lt))]
    pairs = torch.arange(B, device=cuda_device)
    ref = ungapped_torch.gapless_gathered(*args, pairs, pairs)
    ungapped_cuda.reset_counts()
    got = ungapped_cuda.gapless_scores(*args)
    torch.cuda.synchronize()
    assert ungapped_cuda.LAUNCHES == {
        k: int(k == ungapped_cuda.kernel_for(Lq)) for k in
        ungapped_cuda.KERNELS}
    assert torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("Lq,Lt", [(8192, 64), (8192, 1100), (1024, 1100)])
def test_long_kernel_matches_plain_on_card(cuda_device, Lq, Lt):
    """gapless_long on the planted long-width pairs, then on their cross
    product with indices out of range."""
    args = [a.to(cuda_device) for a in _torch(*_long_pairs(Lq, Lt))]
    B = args[0].shape[0]
    rng = np.random.default_rng(Lt)
    pairs = [torch.arange(B, device=cuda_device)] * 2
    oor = [torch.from_numpy(rng.integers(-1, B + 1, 4 * B)).to(cuda_device)
           for _ in range(2)]
    for li, lj in (pairs, oor):
        ref = ungapped_torch.gapless_gathered(*args, li, lj)
        ungapped_cuda.reset_counts()
        got = ungapped_cuda.gapless_scores_gathered(*args, li, lj)
        torch.cuda.synchronize()
        assert ungapped_cuda.LAUNCHES == {"gapless_pair": 0,
                                          "gapless_long": 1,
                                          "gapless_rows": 0}
        assert torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("Lq,Lt,nq,nt", [(32, 64, 64, 20), (32, 64, 300, 300),
                                         (512, 1024, 16, 20),
                                         (512, 1024, 16, 100)])
def test_rows_kernel_matches_plain_on_card(cuda_device, Lq, Lt, nq, nt):
    """gapless_rows through the cross entry on the planted cross products,
    all rows and then rows 1..nq - 1."""
    q, qb, ql, t, tl, plants = _cross(Lq, Lt, nq, nt)
    args = [a.to(cuda_device) for a in _torch(q, qb, ql, t, tl)]
    for r0, r1 in ((0, nq), (1, nq - 1)):
        flat = torch.arange((r1 - r0) * nt, device=cuda_device)
        ref = ungapped_torch.gapless_gathered(
            *args, r0 + flat // nt, flat % nt).view(r1 - r0, nt)
        ungapped_cuda.reset_counts()
        got = ungapped_cuda.gapless_scores_cross(*args, r0, r1)
        torch.cuda.synchronize()
        assert ungapped_cuda.LAUNCHES == {"gapless_pair": 0,
                                          "gapless_long": 0,
                                          "gapless_rows": 1}
        assert torch.equal(got, ref)
        if r0 == 0:
            assert {k: int(got[k]) for k in plants} == plants
