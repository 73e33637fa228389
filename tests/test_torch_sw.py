"""The port's pair SW (metaeuk_tpu_torch.ops) against the JAX package.

The plain versions (what the wrappers run on a CPU tensor) are held to the
Pallas kernels in interpret mode (metaeuk_tpu/ops/sw_pallas.py, as
tests/test_sw_pallas.py runs them) and to the numpy oracle (ops/sw.py).
Every output is an integer: the tolerance is exact equality. The CUDA
kernels are held to the plain versions on the card (marker gpu).
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from metaeuk_tpu.data.submat import (ALPHABET, BLOSUM62_SCORES,
                                     composition_bias_rounded_batch,
                                     encode_aa)
from metaeuk_tpu.ops.sw import sw_align, sw_score_naive
from metaeuk_tpu.ops.sw_pallas import (_align_full, _build_S_gapped,
                                       _sw_pallas_starts_from_S, _tj_for,
                                       sw_pallas_ends)
from metaeuk_tpu_torch.ops import sw_cuda, sw_torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = pathlib.Path(__file__).parent / "data"
# (B, Lq, Lt): a short tier, and Lq = 1024 where the Pallas column chunk is
# TJ = 32, so Lt = 100 runs several chunks and Lq > 2 * TJ
SHAPES = [(128, 48, 80), (128, 1024, 100)]


def _batch(seed, B, Lq, Lt):
    """Ragged pairs with zero-length pairs, no-hit pairs, ties (repeated
    segments on either side) and implanted real hits. numpy int32."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 20, (B, Lq)).astype(np.int32)
    t = rng.integers(0, 20, (B, Lt)).astype(np.int32)
    qb = rng.integers(-3, 4, (B, Lq)).astype(np.int32)
    ql = rng.integers(1, Lq + 1, B).astype(np.int32)
    tl = rng.integers(1, Lt + 1, B).astype(np.int32)
    ql[0], tl[1] = 0, 0                        # zero-length pairs
    c, e = ALPHABET.index("C"), ALPHABET.index("E")
    q[2], qb[2], t[2] = c, 0, e                # C vs E scores -4: no hit
    seg = rng.integers(0, 20, 12)
    t[3, :24], tl[3] = np.tile(seg, 2), 24     # target repeats: column tie
    q[3, :12], qb[3, :12], ql[3] = seg, 0, 12
    q[4, :24], qb[4, :24], ql[4] = np.tile(seg, 2), 0, 24  # row tie
    t[4, :12], tl[4] = seg, 12
    for b in range(5, B, 3):                   # implanted hits
        n = int(min(ql[b], tl[b], 30))
        t[b, :n] = q[b, :n]
    q[6::9], qb[6::9], ql[6::9] = q[5], qb[5], ql[5]   # repeated pairs
    t[6::9], tl[6::9] = t[5], tl[5]
    return q, qb, ql, t, tl


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _np(tensors):
    return [t.numpy() for t in tensors]


@pytest.mark.parametrize("B,Lq,Lt", SHAPES)
def test_sw_ends_matches_pallas_interpret(B, Lq, Lt):
    q, qb, ql, t, tl = _batch(Lq, B, Lq, Lt)
    ref = sw_pallas_ends(q, qb, ql, t, Lq, Lt, True, t_len=tl)
    got = _np(sw_cuda.sw_ends(*_torch(q, qb, ql, t, tl)))
    for name, a, b in zip(("score", "q_end", "t_end"), ref, got):
        np.testing.assert_array_equal(np.asarray(a), b, name)


@pytest.mark.parametrize("B,Lq,Lt", SHAPES)
def test_sw_starts_matches_pallas_interpret(B, Lq, Lt):
    q, qb, ql, t, tl = _batch(Lq + 1, B, Lq, Lt)
    rng = np.random.default_rng(Lq)
    # ends anywhere, including past the true lengths; -1 would be masked
    # the same way but the driver only passes clamped ends
    qe = rng.integers(0, Lq + 2, B).astype(np.int32)
    te = rng.integers(0, Lt + 2, B).astype(np.int32)
    TJ = _tj_for(Lq)
    Lt_pad = (Lt + TJ - 1) // TJ * TJ
    S = _build_S_gapped(q, qb, t, Lq, Lt, Lt_pad, q_len=ql, t_len=tl)
    ref = _sw_pallas_starts_from_S(S, qe, te, Lq, Lt_pad, B, True)
    got = _np(sw_cuda.sw_starts(*_torch(q, qb, ql, t, tl, qe, te)))
    for name, a, b in zip(("score", "q_start", "t_start"), ref, got):
        np.testing.assert_array_equal(np.asarray(a), b, name)


def test_align_full_matches_pallas_interpret():
    B, Lq, Lt = SHAPES[0]
    q, qb, ql, t, tl = _batch(7, B, Lq, Lt)
    ref = _align_full(q, qb, ql, t, tl, Lq, Lt, True)
    got = _np(sw_cuda.align_full(*_torch(q, qb, ql, t, tl)))
    for name, a, b in zip(("score", "q_start", "q_end", "t_start", "t_end"),
                          ref, got):
        np.testing.assert_array_equal(np.asarray(a), b, name)


def test_align_full_matches_numpy_oracle():
    B, Lq, Lt = 64, 40, 56
    q, qb, ql, t, tl = _batch(11, B, Lq, Lt)
    score, qs, qe, ts, te = _np(sw_cuda.align_full(*_torch(q, qb, ql, t,
                                                           tl)))
    for b in range(B):
        ref = sw_align(q[b, :ql[b]], t[b, :tl[b]], qb[b, :ql[b]])
        assert score[b] == ref["score"], b
        if b % 4 == 0:
            assert score[b] == sw_score_naive(q[b, :ql[b]], t[b, :tl[b]],
                                              qb[b, :ql[b]]), b
        if ref["score"] > 0:
            assert (qs[b], qe[b], ts[b], te[b]) == (
                ref["q_start"], ref["q_end"], ref["t_start"],
                ref["t_end"]), b
        else:
            assert (qs[b], ts[b], te[b]) == (-1, -1, -1), b


def test_no_hit_values_follow_the_pallas_contract():
    B, Lq, Lt = 8, 32, 40
    q, qb, ql, t, tl = _batch(3, B, Lq, Lt)
    score, q_end, t_end = _np(sw_cuda.sw_ends(*_torch(q, qb, ql, t, tl)))
    for b in (0, 1, 2):            # zero-length and C-vs-E pairs
        assert (score[b], q_end[b], t_end[b]) == (0, Lq - 1, -1), b
    zeros = np.zeros(B, np.int32)
    score, q_start, t_start = _np(sw_cuda.sw_starts(
        *_torch(q, qb, ql, t, tl, zeros, zeros - 1)))
    assert (score == 0).all() and (q_start == 0).all() \
        and (t_start == -1).all()


def _edge_batch(Lq, Lt, B=None):
    """chip_smoke.pair_edge_batch at (Lq, Lt): ties planted on either side
    of the CUDA kernels' lane, group and row-stripe edges, at the first and
    last columns and one row or column past the true lengths, then runs
    ending at q_len - 1 or t_len - 1; padded to B pairs with zero-length
    pairs (no-hit values, expectation None)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    arrays, expect = chip_smoke.pair_edge_batch(
        np, np.random.default_rng(Lq), Lq, Lt)
    pad = (B or len(expect)) - len(expect)
    arrays = [np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1)).astype(
        np.int32) for a in arrays]
    return arrays, expect + [None] * pad


def _check_planted(expect, fwd, rev):
    for b, ex in enumerate(expect):
        if ex is not None:
            got = (tuple(int(a[b]) for a in fwd),
                   tuple(int(a[b]) for a in rev))
            assert got == ex, (b, got, ex)


def test_planted_edges_match_pallas_interpret():
    """Forward ends, and starts over each pair's whole matrix, at the edges
    of the length classes up to 64 rows (lanes of 8 rows, groups of 4 and
    8 lanes)."""
    B, Lq, Lt = 128, 72, 80
    (q, qb, ql, t, tl), expect = _edge_batch(Lq, Lt, B)
    assert sum(e is not None for e in expect) == 2 * 18
    ref = sw_pallas_ends(q, qb, ql, t, Lq, Lt, True, t_len=tl)
    got = _np(sw_cuda.sw_ends(*_torch(q, qb, ql, t, tl)))
    for name, a, b in zip(("score", "q_end", "t_end"), ref, got):
        np.testing.assert_array_equal(np.asarray(a), b, name)
    qe, te = ql - 1, tl - 1
    TJ = _tj_for(Lq)
    Lt_pad = (Lt + TJ - 1) // TJ * TJ
    S = _build_S_gapped(q, qb, t, Lq, Lt, Lt_pad, q_len=ql, t_len=tl)
    ref_rev = _sw_pallas_starts_from_S(S, qe, te, Lq, Lt_pad, B, True)
    got_rev = _np(sw_cuda.sw_starts(*_torch(q, qb, ql, t, tl, qe, te)))
    for name, a, b in zip(("score", "q_start", "t_start"), ref_rev,
                          got_rev):
        np.testing.assert_array_equal(np.asarray(a), b, name)
    _check_planted(expect, got, got_rev)


def test_planted_edges_over_512_rows_match_numpy_oracle():
    """The ties and runs of fragments over 512 rows (the row-stripe edge
    511/512 and the last stripe's edges) against ops/sw.py."""
    (q, qb, ql, t, tl), expect = _edge_batch(1152, 1152)
    keep = np.flatnonzero(ql > 512)
    q, qb, ql, t, tl = (a[keep] for a in (q, qb, ql, t, tl))
    expect = [expect[b] for b in keep]
    assert sum(e is not None for e in expect) == 14 + 18
    args = _torch(q, qb, ql, t, tl)
    fwd = _np(sw_cuda.sw_ends(*args))
    rev = _np(sw_cuda.sw_starts(*args, *_torch(ql - 1, tl - 1)))
    _check_planted(expect, fwd, rev)
    for b in range(len(keep)):
        ref = sw_align(q[b, :ql[b]], t[b, :tl[b]], qb[b, :ql[b]])
        assert (fwd[0][b], fwd[1][b], fwd[2][b]) == (
            ref["score"], ref["q_end"], ref["t_end"]), b
        if expect[b] is None:   # a run: its start is (0, 0)
            assert ref["q_start"] == ref["t_start"] == 0, b


def test_pair_classes_round_trip():
    """sw_cuda.pair_classes: a permutation of the batch, sorted by length
    class (every pair within its class's G * R rows, forward and reverse)
    and then by columns; bounds close each class."""
    rng = np.random.default_rng(9)
    B, Lq, Lt = 500, 1100, 300
    ql = torch.from_numpy(rng.integers(-2, Lq + 40, B)).int()
    tl = torch.from_numpy(rng.integers(-2, Lt + 40, B)).int()
    ends = [(None, None), tuple(torch.from_numpy(rng.integers(-1, n + 2, B))
                                .int() for n in (Lq, Lt))]
    caps = [g * r for g, r in sw_cuda.PAIR_CLASSES[:-1]] + [Lq]
    for qe, te in ends:
        order, bounds = sw_cuda.pair_classes(ql, tl, Lq, Lt, qe, te)
        assert order.dtype == bounds.dtype == torch.int32
        o = order.long()
        assert torch.equal(torch.sort(o).values, torch.arange(B))
        n = ql.clamp(0, Lq).long()
        m = tl.clamp(0, Lt).long()
        if qe is not None:
            n = (torch.minimum(qe.long(), n - 1) + 1).clamp_min(0)
            m = (torch.minimum(te.long(), m - 1) + 1).clamp_min(0)
        assert int(bounds[-1]) == B
        lo = 0
        for c, hi in enumerate(bounds.tolist()):
            part = o[lo:hi]
            assert (n[part] <= caps[c]).all()
            if c:
                assert (n[part] > caps[c - 1]).all()
            assert (torch.diff(m[part]) >= 0).all()
            lo = hi
        # outputs written at each pair's place come back in the caller's
        # order
        out = torch.empty(B, dtype=torch.int64)
        out[o] = n[o] * 1000 + m[o]
        assert torch.equal(out, n * 1000 + m)


def test_fixture_scores_fit_int8():
    """blosum + bias over every fixture fragment and every residue class
    lies in [-128, 127], so the Pallas path's int8 S loses nothing against
    the port's int32 scores."""
    from metaeuk_tpu.io.seqdb import DBTYPE_NUCL, SeqDB
    from metaeuk_tpu.ops.orf import OrfExtractor
    from metaeuk_tpu.params import Params
    contigs = SeqDB.from_fasta(DATA / "contigs.fna", DBTYPE_NUCL)
    ex = OrfExtractor(Params())
    frags = []
    for ci in range(len(contigs)):
        _, f = ex.extract_contig(contigs.seq_bytes(ci), ci)
        frags.extend(encode_aa(a) for a in ex.translate_fragments(f))
    assert frags
    biases = composition_bias_rounded_batch(frags)
    lo = min(int((BLOSUM62_SCORES[f].astype(np.int64)
                  + b.astype(np.int64)[:, None]).min())
             for f, b in zip(frags, biases) if len(f))
    hi = max(int((BLOSUM62_SCORES[f].astype(np.int64)
                  + b.astype(np.int64)[:, None]).max())
             for f, b in zip(frags, biases) if len(f))
    assert -128 <= lo and hi <= 127, (lo, hi)


def test_cpu_tensors_take_the_plain_version():
    B, Lq, Lt = 16, 24, 24
    args = _torch(*_batch(5, B, Lq, Lt))
    sw_cuda.reset_counts()
    ends = sw_cuda.sw_ends(*args)
    sw_cuda.sw_starts(*args, torch.clamp_min(ends[1], 0),
                      torch.clamp_min(ends[2], 0))
    assert sw_cuda.PLAIN_CALLS == {**dict.fromkeys(sw_cuda.KERNELS, 0),
                                   "sw_pair_ends": 1, "sw_pair_starts": 1}
    assert not any(sw_cuda.LAUNCHES.values())
    for a, b in zip(ends, sw_torch.sw_ends(*args)):
        assert torch.equal(a, b)


def test_other_devices_raise():
    args = [a.to("meta") for a in _torch(*_batch(5, 8, 24, 24))]
    with pytest.raises(ValueError, match="CUDA"):
        sw_cuda.sw_ends(*args)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_match_plain_on_planted_edges_on_card(cuda_device):
    (q, qb, ql, t, tl), expect = _edge_batch(1152, 1152)
    args = [a.to(cuda_device) for a in _torch(q, qb, ql, t, tl)]
    whole = [a.to(cuda_device) for a in _torch(ql - 1, tl - 1)]
    fwd, rev = sw_cuda.sw_ends(*args), sw_cuda.sw_starts(*args, *whole)
    torch.cuda.synchronize()
    for a, b in zip(fwd, sw_torch.sw_ends(*args)):
        assert torch.equal(a, b)
    for a, b in zip(rev, sw_torch.sw_starts(*args, *whole)):
        assert torch.equal(a, b)
    _check_planted(expect, [a.cpu() for a in fwd], [a.cpu() for a in rev])


@pytest.mark.gpu
@pytest.mark.parametrize("B,Lq,Lt", SHAPES + [(64, 4608, 300)])
def test_kernels_match_plain_on_card(cuda_device, B, Lq, Lt):
    args = [a.to(cuda_device) for a in _torch(*_batch(Lq, B, Lq, Lt))]
    ref = sw_torch.align_full(*args)
    sw_cuda.reset_counts()
    got = sw_cuda.align_full(*args)
    torch.cuda.synchronize()
    assert sw_cuda.LAUNCHES == {**dict.fromkeys(sw_cuda.KERNELS, 0),
                                "sw_pair_ends": 1, "sw_pair_starts": 1}
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
