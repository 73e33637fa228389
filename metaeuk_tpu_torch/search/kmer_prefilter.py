"""K-mer inverted-index prefilter (double-diagonal matching) on a torch
device.

Counterpart of metaeuk_tpu/search/kmer_prefilter.py, the TPU-era redesign of
the reference's k-mer prefilter (lib/mmseqs/src/prefiltering/:
IndexTable.h:65, IndexBuilder.cpp:55, QueryMatcher.cpp:213-340): an inverted
index over target k-mers feeds a double-hit-on-same-diagonal candidate
screen, and survivors are rescored with the gapless kernel
(ops/ungapped_cuda.py gapless_scores_gathered: gapless_pair, or gapless_long
for fragments over 512 aa) standing in for the SIMD ungapped diagonal
rescoring (UngappedAlignment.cpp:25).

Differences from the reference, by design (the JAX module's contract):
- exact k-mer matching (the reference's --exact-kmer-matching 1 mode)
- survivors are rescored over *all* diagonals by the gapless kernel
  (a superset of the reference's matched-diagonal rescoring)
The output contract matches the other prefilter modes: per fragment the
top --max-seqs candidates by ungapped score above --min-ungapped-score.

The index build, the screen and the selection are host numpy, as in the JAX
module. The rescoring stages the candidates' fragments by length bucket
(search/prefilter.py _bucket: powers of two from 32), not at one width over
the longest fragment, and launches each bucket on its own: the scores do not
depend on the padding, so the pair array is the JAX module's, pair for pair.
On a CPU device the wrapper runs the kernels' plain version.
"""

import time

import numpy as np
import torch

from .. import state
from ..data.submat import composition_bias_rounded, encode_aa
from ..ops import ungapped_cuda
from .driver import pad_rows
from .prefilter import CELL_BUDGET, MAX_PAIRS_PER_LAUNCH, _bucket

KMER_K = 6


def seq_kmers(enc, k=KMER_K):
    """Packed base-21 k-mer codes + positions; k-mers containing X (20)
    are skipped (the reference never indexes X, IndexBuilder.cpp)."""
    n = len(enc) - k + 1
    if n <= 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64))
    enc = np.asarray(enc, np.int64)
    codes = np.zeros(n, np.int64)
    has_x = np.zeros(n, bool)
    for i in range(k):
        codes = codes * 21 + enc[i:i + n]
        has_x |= enc[i:i + n] == 20
    pos = np.arange(n, dtype=np.int64)
    keep = ~has_x
    return codes[keep], pos[keep]


class KmerIndex:
    """Inverted index: k-mer code -> (target_id, position) postings."""

    def __init__(self, targets_enc, k=KMER_K):
        self.k = k
        codes_all, tids_all, pos_all = [], [], []
        for ti, enc in enumerate(targets_enc):
            codes, pos = seq_kmers(enc, k)
            codes_all.append(codes)
            pos_all.append(pos)
            tids_all.append(np.full(len(codes), ti, np.int64))
        codes = np.concatenate(codes_all) if codes_all else np.zeros(0, np.int64)
        tids = np.concatenate(tids_all) if tids_all else np.zeros(0, np.int64)
        pos = np.concatenate(pos_all) if pos_all else np.zeros(0, np.int64)
        order = np.argsort(codes, kind="stable")
        self.codes = codes[order]
        self.tids = tids[order]
        self.pos = pos[order]

    def lookup(self, query_codes):
        """(start, end) ranges into the postings for each query code."""
        lo = np.searchsorted(self.codes, query_codes, side="left")
        hi = np.searchsorted(self.codes, query_codes, side="right")
        return lo, hi


class KmerPrefilter:
    """Candidate pairs via double-diagonal k-mer matching + gapless rescore.

    stage_seconds holds the last call's seconds: index (the constructor),
    screen, rescore (staging and the kernels, to the scores on the host)
    and select; last_candidates the last candidate_pairs call's candidates
    and their scores."""

    def __init__(self, params, target_db, min_diag_score=15,
                 min_diag_matches=2, k=KMER_K, mask_mode=1, device="cuda"):
        t0 = time.perf_counter()
        self.params = params
        self.min_diag_score = min_diag_score
        self.min_diag_matches = min_diag_matches
        self.device = torch.device(device)
        self.scoring = state.default_scoring(self.device)
        self.targets_enc = [encode_aa(target_db.seq_bytes(i))
                            for i in range(len(target_db))]
        self.target_lens = np.array([len(t) for t in self.targets_enc], np.int64)
        # low-complexity masking of indexed targets (--mask-mode 1 default,
        # Masker/tantan at index build; scoring still uses unmasked residues)
        if mask_mode:
            from ..ops.masker import mask_sequence
            index_seqs = [mask_sequence(t)[0] for t in self.targets_enc]
        else:
            index_seqs = self.targets_enc
        self.index = KmerIndex(index_seqs, k)
        self.n_targets = len(self.targets_enc)
        self._t_stage = None
        self.last_candidates = None
        self.stage_seconds = {"index": time.perf_counter() - t0}

    def candidate_targets(self, orf_enc):
        """Targets with >= min_diag_matches k-mer hits on one diagonal
        (QueryMatcher double-hit contract, QueryMatcher.cpp:213-340)."""
        codes, qpos = seq_kmers(orf_enc, self.index.k)
        if len(codes) == 0:
            return np.zeros(0, np.int64)
        lo, hi = self.index.lookup(codes)
        counts = hi - lo
        total = int(counts.sum())
        if total == 0:
            return np.zeros(0, np.int64)
        # expand posting ranges
        qk = np.repeat(np.arange(len(codes)), counts)
        flat = np.concatenate([np.arange(l, h) for l, h in zip(lo, hi)
                               if h > l]) if total else np.zeros(0, np.int64)
        tid = self.index.tids[flat]
        diag = self.index.pos[flat] - qpos[qk]
        # count hits per (target, diagonal); diagonal range is bounded
        key = tid * (2 ** 20) + (diag + 2 ** 19)
        uniq, cnt = np.unique(key, return_counts=True)
        hit_targets = np.unique(uniq[cnt >= self.min_diag_matches] // (2 ** 20))
        if self.min_diag_matches <= 1:
            hit_targets = np.unique(tid)
        return hit_targets

    def encode(self, orf_aa_seqs):
        """(orfs_enc, orf_bias): the fragments' codes and composition
        biases, as the gapless kernel scores them."""
        p = self.params
        orfs_enc = [encode_aa(s) for s in orf_aa_seqs]
        orf_bias = [composition_bias_rounded(e, p.comp_bias_correction_scale)
                    if p.comp_bias_correction else np.zeros(len(e), np.int8)
                    for e in orfs_enc]
        return orfs_enc, orf_bias

    def candidates(self, orf_aa_seqs):
        """(orfs_enc, orf_bias, pairs): encode's codes and biases and the
        (n, 2) int64 (fragment, target) candidates of the screen, fragment
        by fragment, targets ascending."""
        t0 = time.perf_counter()
        orfs_enc, orf_bias = self.encode(orf_aa_seqs)
        pairs = [(qi, ti) for qi, enc in enumerate(orfs_enc)
                 for ti in self.candidate_targets(enc)]
        self.stage_seconds["screen"] = time.perf_counter() - t0
        return orfs_enc, orf_bias, np.asarray(pairs, np.int64).reshape(-1, 2)

    def staged_targets(self):
        """The staged targets on the device, at one width (every launch
        names targets of any length): (t_mat, t_lens)."""
        if self._t_stage is None:
            Lt = _bucket(max(1, int(self.target_lens.max(initial=0))))
            self._t_stage = (
                torch.from_numpy(pad_rows(self.targets_enc, Lt, np.uint8))
                .to(self.device),
                torch.from_numpy(self.target_lens.astype(np.int32))
                .to(self.device))
        return self._t_stage

    def score_pairs(self, orfs_enc, orf_bias, pairs):
        """(n,) int32 best gapless diagonal score of each candidate pair, in
        pairs' order. The candidates' fragments are staged by length bucket
        and each bucket's pairs go to the gapless kernel on their own, in
        launches of at most the device type's cell budget; the scores are
        scattered back to the candidates' order."""
        t0 = time.perf_counter()
        scores = np.zeros(len(pairs), np.int32)
        if len(pairs) == 0:
            self.stage_seconds["rescore"] = time.perf_counter() - t0
            return scores
        dev = self.device
        t_mat, t_lens = self.staged_targets()
        orf_lens = np.array([len(e) for e in orfs_enc], np.int64)
        widths = np.array([_bucket(max(1, int(n))) for n in orf_lens])
        pair_w = widths[pairs[:, 0]]
        budget = CELL_BUDGET.get(dev.type, CELL_BUDGET["cpu"])
        cap = MAX_PAIRS_PER_LAUNCH.get(dev.type, MAX_PAIRS_PER_LAUNCH["cpu"])
        outs = []
        for Lq in np.unique(pair_w):
            at = np.flatnonzero(pair_w == Lq)
            frags, local = np.unique(pairs[at, 0], return_inverse=True)
            q_mat = torch.from_numpy(pad_rows([orfs_enc[i] for i in frags],
                                              int(Lq), np.uint8)).to(dev)
            qb_mat = torch.from_numpy(pad_rows([orf_bias[i] for i in frags],
                                               int(Lq), np.int8)).to(dev)
            q_lens = torch.from_numpy(orf_lens[frags].astype(np.int32)).to(dev)
            li = torch.from_numpy(local.astype(np.int32)).to(dev)
            lj = torch.from_numpy(pairs[at, 1].astype(np.int32)).to(dev)
            step = min(cap, max(128, budget // (int(Lq) * t_mat.shape[1])))
            for s in range(0, len(at), step):
                outs.append((at[s:s + step],
                             ungapped_cuda.gapless_scores_gathered(
                                 q_mat, qb_mat, q_lens, t_mat, t_lens,
                                 li[s:s + step], lj[s:s + step],
                                 scoring=self.scoring)))
        for at, got in outs:
            scores[at] = got.cpu().numpy()
        self.stage_seconds["rescore"] = time.perf_counter() - t0
        return scores

    def select(self, pairs, scores):
        """The prefilter contract on scored candidates: score >
        min_diag_score, per fragment (ascending) the top max-seqs by (score
        desc, target asc); (m, 2) int64."""
        t0 = time.perf_counter()
        keep = scores > self.min_diag_score
        pairs, scores = pairs[keep], scores[keep].astype(np.int64)
        order = np.lexsort((pairs[:, 1], -scores, pairs[:, 0]))
        pairs = pairs[order]
        # rank of each pair within its fragment's run
        first = np.flatnonzero(np.r_[True, pairs[1:, 0] != pairs[:-1, 0]])
        run = np.diff(np.r_[first, len(pairs)])
        rank = np.arange(len(pairs)) - np.repeat(first, run)
        out = pairs[rank < self.params.max_res_list_len]
        self.stage_seconds["select"] = time.perf_counter() - t0
        return np.ascontiguousarray(out, np.int64).reshape(-1, 2)

    def candidate_pairs(self, orf_aa_seqs):
        """Same contract as UngappedPrefilter.candidate_pairs."""
        orfs_enc, orf_bias, pairs = self.candidates(orf_aa_seqs)
        scores = self.score_pairs(orfs_enc, orf_bias, pairs)
        self.last_candidates = (pairs, scores)
        if len(pairs) == 0:
            return np.zeros((0, 2), dtype=np.int64)
        return self.select(pairs, scores)
