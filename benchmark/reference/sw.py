"""Plain PyTorch Smith-Waterman: the reference for the aligner's hits.

The contract of MMseqs2's striped SW as its alignment module uses it
(StripedSmithWaterman.cpp ssw_align): S(i, j) = BLOSUM62[q_i, t_j] +
bias_i, affine gaps of open 11 / extend 1, H floored at 0; the end is the
first target column that reaches the best score, and in it the first
query row; the start is the end of the same DP over the reversed prefixes
q[:q_end + 1], t[:t_end + 1].

One tensor step a target column over (pairs, query rows); the vertical
gap of a column is a running maximum down the rows. `sat` narrows H and
E to saturate at that value (127: int8 lanes, the control).
"""

import numpy as np
import torch

from .scoring import BLOSUM62

GO, GE = 11, 1
NEG = -(1 << 20)


def _ends(prof, t, t_len, q_len, sat):
    """Forward DP of a batch. prof (B, Lq, 21) int32 with NEG past each
    query; t (B, Lt) int64 codes; returns (score, q_end, t_end) (B,),
    t_end -1 where nothing aligns."""
    B, Lq, _ = prof.shape
    dev = prof.device
    H = torch.zeros((B, Lq), dtype=torch.int32, device=dev)
    E = torch.zeros_like(H)
    ramp = torch.arange(Lq, device=dev, dtype=torch.int32)
    valid_q = ramp[None, :] < q_len[:, None]
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    q_end = torch.full((B,), -1, dtype=torch.int64, device=dev)
    t_end = torch.full((B,), -1, dtype=torch.int64, device=dev)
    zero = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    neg = torch.full((B, 1), NEG, dtype=torch.int32, device=dev)
    for j in range(t.shape[1]):
        s = torch.gather(prof, 2, t[:, j].view(B, 1, 1).expand(B, Lq, 1))[..., 0]
        Hd = torch.cat([zero, H[:, :-1]], dim=1)
        G = torch.maximum(torch.clamp_min(Hd + s, 0), E)
        M = torch.cummax(G + ramp * GE, dim=1).values
        F = torch.cat([neg, M[:, :-1]], dim=1) - GO - (ramp - 1) * GE
        H = torch.maximum(G, F)
        if sat is not None:
            H.clamp_max_(sat)
        col = torch.where(valid_q, H, -1)
        cmax, arg = col.max(dim=1)
        better = (cmax > best) & (j < t_len)
        best = torch.where(better, cmax, best)
        q_end = torch.where(better, arg, q_end)
        t_end = torch.where(better, torch.full_like(t_end, j), t_end)
        E = torch.clamp_min(torch.maximum(E - GE, H - GO), 0)
        if sat is not None:
            E.clamp_max_(sat)
    return best, q_end, t_end


def _pad(rows, width, fill, dtype):
    """Rows of unequal length in one (len(rows), width) array."""
    lens = np.array([len(r) for r in rows])
    out = np.full((len(rows), width), fill, dtype)
    if lens.sum():
        out[np.arange(width)[None, :] < lens[:, None]] = np.concatenate(rows)
    return out


def _profile(qc, qb, Lq, device):
    codes = torch.from_numpy(_pad(qc, Lq, 21, np.int64)).to(device)
    bias = torch.from_numpy(_pad(qb, Lq, 0, np.int32)).to(device)
    sub = torch.full((22, 21), NEG, dtype=torch.int32)
    sub[:21] = torch.from_numpy(BLOSUM62.astype(np.int32))
    # NEG past each query's length (code 21), bias added elsewhere
    prof = sub.to(device)[codes]
    return torch.where(codes[..., None] < 21, prof + bias[..., None], NEG)


def _targets(tc, Lt, device):
    return torch.from_numpy(_pad(tc, Lt, 0, np.int64)).to(device)


def _run(qc, qb, tc, device, sat):
    q_len = np.array([len(c) for c in qc])
    t_len = np.array([len(c) for c in tc])
    Lq, Lt = max(1, int(q_len.max())), max(1, int(t_len.max()))
    out = _ends(_profile(qc, qb, Lq, device), _targets(tc, Lt, device),
                torch.from_numpy(t_len).to(device),
                torch.from_numpy(q_len).to(device), sat)
    return [o.cpu().numpy() for o in out]


def _batches(ql, tl, width):
    """Pair indices in batches of like target length (the DP's steps):
    in target length order, a batch runs while its longest target is at
    most 1.25 times its first and its pairs times its longest query (the
    DP's width) stay within `width`. Steps cost about one launch each, so
    fewer, wider batches beat query lengths grouped apart."""
    order = np.lexsort((ql, tl))
    i, n = 0, len(order)
    while i < n:
        t0 = tl[order[i]]
        j, lq = i + 1, int(ql[order[i]])
        while j < n and tl[order[j]] <= 1.25 * t0:
            nq = max(lq, int(ql[order[j]]))
            if (j - i + 1) * nq > width:
                break
            lq, j = nq, j + 1
        yield order[i:j]
        i = j


def align(qcodes, qbias, tcodes, pairs, device, sat=None, width=1 << 22):
    """Score, ends and starts of each (query, target) pair of `pairs`
    ((n, 2) int64): a dict of (n,) arrays score, q_start, q_end, t_start,
    t_end (starts -1 where the score is 0)."""
    n = len(pairs)
    res = {k: np.full(n, -1, np.int64) for k in
           ("score", "q_start", "q_end", "t_start", "t_end")}
    res["score"][:] = 0
    if not n:
        return res
    ql = np.array([len(qcodes[q]) for q in pairs[:, 0]])
    tl = np.array([len(tcodes[t]) for t in pairs[:, 1]])
    for idx in _batches(ql, tl, width):
        qc = [qcodes[q] for q in pairs[idx, 0]]
        qb = [qbias[q] for q in pairs[idx, 0]]
        tc = [tcodes[t] for t in pairs[idx, 1]]
        sc, qe, te = _run(qc, qb, tc, device, sat)
        res["score"][idx], res["q_end"][idx], res["t_end"][idx] = sc, qe, te
        ok = np.flatnonzero((te >= 0) & (sc > 0))
        if not len(ok):
            continue
        # reverse pass on the reversed prefixes
        rq = [qc[k][:qe[k] + 1][::-1].copy() for k in ok]
        rb = [qb[k][:qe[k] + 1][::-1].copy() for k in ok]
        rt = [tc[k][:te[k] + 1][::-1].copy() for k in ok]
        sc2, qre, tre = _run(rq, rb, rt, device, sat)
        if sat is None and not np.array_equal(sc2, sc[ok]):
            raise AssertionError("reverse pass score differs from forward")
        res["q_start"][idx[ok]] = qe[ok] - qre
        res["t_start"][idx[ok]] = te[ok] - tre
    return res
