"""Ungapped prefilter: candidate (fragment, target) pair selection on a torch
device.

Counterpart of metaeuk_tpu/search/prefilter.py UngappedPrefilter (the
reference's ungapped prefilter, lib/mmseqs/src/prefiltering/
ungappedprefilter.cpp:358-470, MetaEuk's GPU mode): per fragment, targets
whose best gapless diagonal score is > --min-ungapped-score are kept, sorted
by (score desc, target asc) and truncated to --max-seqs. The scores come from
the gapless kernel (ops/ungapped_cuda.py) over the cross product of every
fragment length bucket with every target length bucket; the pair array is
the JAX package's, element for element.

Launches carry whole query rows of a bucket's cross product
(ungapped_cuda.gapless_scores_cross), up to a cell budget per device type:
the kernels keep no scratch, so a CUDA launch carries millions of pairs (the
JAX package's VMEM-sized blocks of 1<<27 cells stay for the plain CPU
version). The scores stay on the device in one (fragments, targets) int32
matrix, and the per-fragment selection is one top-k per block of rows on a
(score, reversed target) key.
"""

import numpy as np
import torch

from .. import state
from ..data.submat import composition_bias_rounded_batch, encode_aa
from ..ops import ungapped_cuda
from ..utils import trace
from .driver import pad_rows

# gapless cells and pairs per launch, by device type
CELL_BUDGET = {"cuda": 1 << 36, "cpu": 1 << 27}
MAX_PAIRS_PER_LAUNCH = {"cuda": 1 << 22, "cpu": 1 << 14}
# fragments per top-k selection block
SELECT_ROWS = 4096
# gapless cells scored (q_len * t_len summed over every pair), summed over
# candidate_pairs calls; set to 0 to start a count
CELLS = {"gapless": 0}
# the same cells by staged query width Lq (the kernel's bucket); clear() to
# start a count
CELLS_BY_LQ = {}


def _bucket(n, lo=32):
    """Length buckets of the JAX prefilter (prefilter.py:17): x2 from 32."""
    b = lo
    while b < n:
        b *= 2
    return b


def cells_by_lq(orf_lens, target_lens):
    """{staged query width Lq: gapless cells} of fragments of orf_lens
    against targets of target_lens, every pair scored once."""
    t_sum = int(np.sum(target_lens, dtype=np.int64))
    out = {}
    for n, count in zip(*np.unique(orf_lens, return_counts=True)):
        Lq = _bucket(max(int(n), 1))
        out[Lq] = out.get(Lq, 0) + int(n) * int(count) * t_sum
    return dict(sorted(out.items()))


class UngappedPrefilter:
    """Produces candidate pairs for SearchDriver.search(pair_generator=...)."""

    def __init__(self, params, target_db, min_diag_score=15, device="cuda"):
        with trace.span("prefilter_init"):
            self.params = params
            self.min_diag_score = min_diag_score
            self.device = torch.device(device)
            self.scoring = state.default_scoring(self.device)
            self.targets_enc = [encode_aa(target_db.seq_bytes(i))
                                for i in range(len(target_db))]
            self.target_lens = np.array([len(t) for t in self.targets_enc],
                                        np.int64)

    def _stage(self, seqs, lens, width, dtype):
        return torch.from_numpy(pad_rows(seqs, width, dtype=dtype)).to(
            self.device), torch.from_numpy(lens.astype(np.int32)).to(
            self.device)

    def candidate_pairs(self, orf_aa_seqs):
        """Returns an (n_pairs, 2) int64 array of (orf_idx, target_idx),
        ordered per fragment by (score desc, target_idx asc), top max-seqs."""
        with trace.span("prefilter"):
            return self._candidate_pairs(orf_aa_seqs)

    def _candidate_pairs(self, orf_aa_seqs):
        p = self.params
        dev = self.device
        with trace.span("prefilter.encode"):
            orfs_enc = [encode_aa(s) for s in orf_aa_seqs]
            if p.comp_bias_correction:
                orf_bias = composition_bias_rounded_batch(
                    orfs_enc, p.comp_bias_correction_scale)
            else:
                orf_bias = [np.zeros(len(e), np.int8) for e in orfs_enc]
        n_orfs = len(orfs_enc)
        n_targets = len(self.targets_enc)
        if n_orfs == 0 or n_targets == 0:
            return np.zeros((0, 2), dtype=np.int64)
        orf_lens = np.array([len(e) for e in orfs_enc], np.int64)
        CELLS["gapless"] += int(orf_lens.sum()) * int(self.target_lens.sum())
        for Lq, n in cells_by_lq(orf_lens, self.target_lens).items():
            CELLS_BY_LQ[Lq] = CELLS_BY_LQ.get(Lq, 0) + n

        # group by padded length buckets; stage each bucket's matrices once
        # and launch whole query rows of the cross product. The target
        # buckets are staged up front, each query bucket before its
        # launches (inside prefilter.score)
        with trace.span("prefilter.stage"):
            scores = torch.zeros((n_orfs, n_targets), dtype=torch.int32,
                                 device=dev)
            q_buckets = np.array([_bucket(max(int(n), 1)) for n in orf_lens])
            t_buckets = np.array([_bucket(max(int(n), 1))
                                  for n in self.target_lens])
            t_stage = {}
            for Lt in np.unique(t_buckets):
                ti_all = np.flatnonzero(t_buckets == Lt)
                t_mat, t_lens = self._stage(
                    [self.targets_enc[i] for i in ti_all],
                    self.target_lens[ti_all], int(Lt), np.uint8)
                t_stage[int(Lt)] = (torch.from_numpy(ti_all).to(dev), t_mat,
                                    t_lens)
        budget = CELL_BUDGET.get(dev.type, CELL_BUDGET["cpu"])
        cap = MAX_PAIRS_PER_LAUNCH.get(dev.type, MAX_PAIRS_PER_LAUNCH["cpu"])
        with trace.span("prefilter.score"):
            for Lq in np.unique(q_buckets):
                qi_all = np.flatnonzero(q_buckets == Lq)
                q_mat, q_lens = self._stage([orfs_enc[i] for i in qi_all],
                                            orf_lens[qi_all], int(Lq),
                                            np.uint8)
                qb_mat, _ = self._stage([orf_bias[i] for i in qi_all],
                                        orf_lens[qi_all], int(Lq), np.int8)
                qi_dev = torch.from_numpy(qi_all).to(dev)
                for Lt, (ti_dev, t_mat, t_lens) in t_stage.items():
                    n_t = len(ti_dev)
                    max_pairs = min(cap, max(8, budget // (int(Lq) * Lt)))
                    rows = max(1, max_pairs // n_t)
                    for r0 in range(0, len(qi_all), rows):
                        r1 = min(r0 + rows, len(qi_all))
                        scores[qi_dev[r0:r1, None], ti_dev[None, :]] = \
                            ungapped_cuda.gapless_scores_cross(
                                q_mat, qb_mat, q_lens, t_mat, t_lens, r0, r1,
                                scoring=self.scoring)

        # per fragment: score > min_diag_score, (score desc, target asc),
        # truncated to max-seqs; the key orders targets of equal score by
        # ascending index
        with trace.span("prefilter.select"):
            k = min(p.max_res_list_len, n_targets)
            rev_t = (n_targets - 1) - torch.arange(n_targets, device=dev)
            parts = []
            for r0 in range(0, n_orfs, SELECT_ROWS):
                sc = scores[r0:r0 + SELECT_ROWS].long()
                key = torch.topk(sc * n_targets + rev_t[None, :], k,
                                 dim=1).values
                s = key // n_targets
                keep = s > self.min_diag_score
                qi = torch.arange(r0, r0 + len(sc), device=dev)[:, None] \
                    .expand_as(key)
                ti = (n_targets - 1) - (key - s * n_targets)
                parts.append(torch.stack([qi[keep], ti[keep]], dim=1))
            pairs = torch.cat(parts).cpu().numpy().astype(np.int64)
            # the copy back has waited for K7: its row counts come back now
            ungapped_cuda.fold_row_lanes()
        return pairs.reshape(-1, 2)
