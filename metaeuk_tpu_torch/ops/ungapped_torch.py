"""Plain PyTorch gapless diagonal scores: the contract of the Pallas kernel
metaeuk_tpu/ops/ungapped.py::_gapless_kernel (K7), vectorised over pairs,
one loop step per target column.

This is the plain version of the CUDA kernel in csrc/gapless.cu. Per pair,
the best of D(i,j) = max(0, D(i-1,j-1) + S(i,j)) over rows i < q_len and
columns j < t_len, floored at 0, with S(i,j) = submat[q_i, t_j] + bias_i:
rows >= q_len score NEG (D resets to 0 there) and columns >= t_len do not
reach the best, as gapless_scores_xla masks them.

Inputs are staged (nq, Lq) / (nt, Lt) integer matrices, (nq,) / (nt,)
lengths and (B,) row indices li, lj on one device; a pair with an index out
of range scores 0 (the JAX package pads with li = -1). The output is (B,)
int32 on that device.
"""

import torch

from ..state import NEG, default_scoring


def gapless_gathered(q_mat, qb_mat, q_lens, t_mat, t_lens, li, lj,
                     scoring=None):
    """(B,) int32 best gapless diagonal score of each pair (li[b], lj[b])."""
    scoring = scoring or default_scoring(q_mat.device)
    dev = q_mat.device
    alph = scoring.submat.shape[0]
    li, lj = li.long(), lj.long()
    valid = (li >= 0) & (li < q_mat.shape[0]) & (lj >= 0) \
        & (lj < t_mat.shape[0])
    li, lj = torch.where(valid, li, 0), torch.where(valid, lj, 0)
    B = li.shape[0]
    q_len = torch.where(valid, q_lens[li].to(torch.int32), 0)
    t_len = torch.where(valid, t_lens[lj].to(torch.int32), 0)
    # cut the padded axes to the longest sequence in use
    Lq = max(1, min(q_mat.shape[1], int(q_len.max()) if B else 1))
    Lt = max(1, min(t_mat.shape[1], int(t_len.max()) if B else 1))
    q = q_mat[li, :Lq].long()
    qb = qb_mat[li, :Lq].to(torch.int32)
    t = t_mat[lj, :Lt].long()
    rows = torch.arange(Lq, device=dev, dtype=torch.int32)
    q_valid = rows[None, :] < q_len[:, None]
    sub = scoring.submat.reshape(-1)
    D = torch.zeros((B, Lq), dtype=torch.int32, device=dev)
    zero_row = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    for j in range(Lt):
        s = torch.where(q_valid, sub[q * alph + t[:, j:j + 1]] + qb, NEG)
        D = torch.clamp_min(torch.cat([zero_row, D[:, :-1]], dim=1) + s, 0)
        best = torch.where(j < t_len, torch.maximum(best, D.max(dim=1).values),
                           best)
    return best
