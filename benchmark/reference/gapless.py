"""Plain PyTorch gapless prefilter: the reference for the candidate pairs
that MMseqs2's ungapped prefilter (ungappedprefilter.cpp, --prefilter-mode
1) hands to the aligner.

Per (query, target): the best over every diagonal of
D(i, j) = max(0, D(i-1, j-1) + S(i, j)), S(i, j) = BLOSUM62[q_i, t_j] +
bias_i, floored at 0. Per query, the targets scoring above min_score,
ordered by (score desc, target asc), the first max_seqs of them.

The DB is staged once on the device in length bins; queries go through in
batches of like length, one tensor step a query row over every target
cell of the queries still that long. Scores fit int16 while no diagonal
passes 32,767: an identical copy scores about 5.3 a residue (BLOSUM62's
diagonal under its background), so about 6,000 identical residues, and
the traffic's queries are mutated or chained copies, the longest a
mutated gene of the DB's longest target (about 6,200 aa). A score past it
would wrap and show as a difference, never hide one. `sat` narrows D to
saturate at that value (127: int8 lanes, the control).
"""

import numpy as np
import torch

from .scoring import BLOSUM62

PAD = 21            # the code of a padded target column
NEG = -30000        # its score: D falls to 0 there
BINS = 8            # target length bins of equal counts ...
SPREAD = 1.5        # ... each split until its longest is at most this
                    # times its shortest


def length_bins(lens):
    """Target indices in bins of like length: BINS of equal counts in
    length order, each cut where a length passes SPREAD times the bin's
    first, so that padding stays small in a long tail."""
    order = np.argsort(lens, kind="stable")
    out = []
    for idx in np.array_split(order, BINS):
        while len(idx):
            cut = int(np.searchsorted(lens[idx], SPREAD * max(
                int(lens[idx[0]]), 1), side="right"))
            out.append(idx[:cut])
            idx = idx[cut:]
    return out


class GaplessDB:
    """The target DB on `device`, in length bins (length_bins): codes
    (T, L) int32 with PAD past each length, and each row's target index."""

    def __init__(self, codes, offsets, device):
        lens = np.diff(offsets)
        self.device = device
        self.n = len(lens)
        self.bins = []
        for idx in length_bins(lens):
            L = int(lens[idx].max())
            mat = np.full((len(idx), L), PAD, np.int32)
            for r, t in enumerate(idx):
                mat[r, :lens[t]] = codes[offsets[t]:offsets[t + 1]]
            self.bins.append((torch.from_numpy(mat).to(device),
                              torch.from_numpy(idx).to(device)))


def scores(gdb, qcodes, qbias, sat=None, cells_per_step=1 << 29):
    """(len(qcodes), gdb.n) int32 best gapless scores of each query against
    every target."""
    dev = gdb.device
    sub = torch.full((22, 22), NEG, dtype=torch.int16)
    sub[:21, :21] = torch.from_numpy(BLOSUM62.astype(np.int16))
    nq = len(qcodes)
    out = torch.zeros((nq, gdb.n), dtype=torch.int32, device=dev)
    qlens = np.array([len(q) for q in qcodes])
    order = np.argsort(-qlens, kind="stable")
    for tmat, tidx in gdb.bins:
        T, L = tmat.shape
        batch = max(1, cells_per_step // (T * L))
        flat_t = tmat.reshape(-1)
        for b0 in range(0, nq, batch):
            qi = order[b0:b0 + batch]
            lens = qlens[qi]
            if lens[0] == 0:
                continue
            prof = _profile(sub, [qcodes[q] for q in qi],
                            [qbias[q] for q in qi], int(lens[0])).to(dev)
            best = torch.zeros((len(qi), T, L), dtype=torch.int16,
                               device=dev)
            D = best[:0]
            for i in range(int(lens[0])):
                # only the queries longer than i (lens falls) take row i
                k = int(np.count_nonzero(lens > i))
                S = prof[:k, i, :].index_select(1, flat_t).view(k, T, L)
                if i:
                    S[:, :, 1:] += D[:k, :, :-1]
                D = S.clamp_min_(0)
                if sat is not None:
                    D.clamp_max_(sat)
                torch.maximum(best[:k], D, out=best[:k])
            rows = torch.from_numpy(qi).to(dev)
            out[rows[:, None], tidx[None, :]] = best.amax(dim=2).to(torch.int32)
            del best, D, S
    return out


def _profile(sub, qc, qb, Lq):
    """(Q, Lq, 22) int16: each query row's substitution row plus its
    bias, NEG past its length and in the PAD column."""
    prof = torch.full((len(qc), Lq, 22), NEG, dtype=torch.int16)
    for r, (c, b) in enumerate(zip(qc, qb)):
        if len(c):
            prof[r, :len(c), :21] = sub[torch.from_numpy(
                np.asarray(c, np.int64)), :21] + torch.from_numpy(
                np.asarray(b, np.int16))[:, None]
    return prof


def candidates(score_mat, min_score, max_seqs):
    """Per query row, the targets above min_score ordered by (score desc,
    target asc), at most max_seqs: [np.int64 array]."""
    n_t = score_mat.shape[1]
    key = score_mat.long() * n_t + (n_t - 1 - torch.arange(
        n_t, device=score_mat.device))[None, :]
    top = torch.topk(key, min(max_seqs, n_t), dim=1).values
    s = top // n_t
    t = (n_t - 1) - (top - s * n_t)
    keep = (s > min_score).cpu().numpy()
    t = t.cpu().numpy()
    return [t[r][keep[r]] for r in range(len(t))]
