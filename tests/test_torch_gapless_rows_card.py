"""gapless_rows (csrc/gapless.cu) on the card against the plain version, on
launches that exercise its pairs of query rows and its two loops: packed
16 x 2 lanes where both rows' scores provably fit 16 bits, int32 elsewhere.

Marker gpu: every test skips without a CUDA device. The file imports
neither JAX nor tests/conftest.py's setup, so on a GPU machine

    python3 -m pytest --noconftest -m gpu tests/test_torch_gapless_rows_card.py

runs it from the root of a checkout. Scores are integers: the tolerance is
exact equality.
"""

import numpy as np
import pytest
import torch

from metaeuk_tpu_torch.data.submat import BLOSUM62_SCORES
from metaeuk_tpu_torch.ops import ungapped_cuda, ungapped_torch
from metaeuk_tpu_torch.state import scoring_from_numpy

NQ = 37   # query rows staged: odd, so the last pair of a launch of all of
#           them has an absent row


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def _rows(Lq, nt, seed, Lt=96):
    """Staged numpy (q, qb, ql, t, tl): NQ query rows at width Lq whose
    lengths lie in no order over 0..Lq, six of them 1..6 aa; nt targets of
    1..Lt aa, each holding a segment of up to 40 residues of a random row
    (a real hit)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 20, (NQ, Lq)).astype(np.uint8)
    qb = rng.integers(-3, 4, (NQ, Lq)).astype(np.int8)
    ql = rng.integers(0, Lq + 1, NQ).astype(np.int32)
    ql[:6] = np.arange(1, 7)
    rng.shuffle(ql)
    t = rng.integers(0, 20, (nt, Lt)).astype(np.uint8)
    tl = rng.integers(1, Lt + 1, nt).astype(np.int32)
    for k in range(nt):
        r = int(rng.integers(NQ))
        n = int(min(ql[r], tl[k], 40))
        if n:
            i0 = int(rng.integers(0, ql[r] - n + 1))
            j0 = int(rng.integers(0, tl[k] - n + 1))
            t[k, j0:j0 + n] = q[r, i0:i0 + n]
    return q, qb, ql, t, tl


def _on(device, arrays):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _rows_kernel(args, r0, r1, scoring):
    """gapless_rows on rows r0..r1 alone, its row counts folded in."""
    ungapped_cuda.reset_counts()
    got = ungapped_cuda.launch_cross("gapless_rows", *args, r0, r1,
                                     scoring=scoring)
    torch.cuda.synchronize()
    ungapped_cuda.fold_row_lanes()
    assert ungapped_cuda.LAUNCHES == {"gapless_pair": 0, "gapless_long": 0,
                                      "gapless_rows": 1}
    return got


def _plain(args, r0, r1, scoring):
    nt = args[3].shape[0]
    flat = torch.arange((r1 - r0) * nt, device=args[0].device)
    return ungapped_torch.gapless_gathered(
        *args, r0 + flat // nt, flat % nt, scoring=scoring).view(r1 - r0, nt)


@pytest.mark.gpu
@pytest.mark.parametrize("nt", [5, 12, 300])
@pytest.mark.parametrize("Lq", [32, 64, 128, 256, 512])
def test_rows_kernel_pairs_rows_of_mixed_lengths(cuda_device, Lq, nt):
    """BLOSUM62 rows of mixed lengths, in odd and even counts and from r0 >
    0, against fewer than 32 targets (tiles of 8 and 16) and against 300:
    the scores equal the plain version's, and every row takes the packed
    loop."""
    scoring = scoring_from_numpy(BLOSUM62_SCORES, 11, 1, cuda_device)
    args = _on(cuda_device, _rows(Lq, nt, Lq + nt))
    for r0, r1 in ((0, NQ), (4, NQ - 1), (5, 30)):
        got = _rows_kernel(args, r0, r1, scoring)
        assert torch.equal(got, _plain(args, r0, r1, scoring))
        assert ungapped_cuda.ROW_LANES == {"packed": r1 - r0, "int32": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("Lq", [32, 64, 128, 256, 512])
def test_rows_kernel_past_16_bits_takes_int32(cuda_device, Lq):
    """BLOSUM62 scaled by 300 (entries up to 3,300, within the profile's
    int16): the rows whose bound U (the sum of max(0, max_a S(i, a)) over
    the row) passes 32767 take the int32 loop with their partners, the
    others the packed loop, as the host computes from row_pairs; the
    scores, some past 16 bits, equal the plain version's."""
    sub = BLOSUM62_SCORES.astype(np.int64) * 300
    scoring = scoring_from_numpy(sub, 11, 1, cuda_device)
    q, qb, ql, t, tl = _rows(Lq, 300, Lq)
    args = _on(cuda_device, (q, qb, ql, t, tl))
    U = [int(np.maximum(sub.max(1)[q[r, :ql[r]]] + qb[r, :ql[r]], 0).sum())
         for r in range(NQ)]
    for r0, r1 in ((0, NQ), (5, 30)):
        want = {"packed": 0, "int32": 0}
        for pair in ungapped_cuda.row_pairs(torch.from_numpy(ql), r0,
                                            r1).view(-1, 2).tolist():
            rows = [r0 + r for r in pair if r >= 0]
            lanes = "packed" if max(U[r] for r in rows) <= 32767 else "int32"
            want[lanes] += len(rows)
        got = _rows_kernel(args, r0, r1, scoring)
        ref = _plain(args, r0, r1, scoring)
        assert torch.equal(got, ref)
        assert ungapped_cuda.ROW_LANES == want
        assert want["packed"] > 0 and want["int32"] > 0
        assert int(ref.max()) > 32767
