"""Profile-query gapped alignment (the align module with an HMM-profile
query DB, as run by iterative searches: blastpgp.sh steps >= 1) on one
torch device.

Counterpart of metaeuk_tpu/search/profile_align.py, which mirrors
Alignment::run for querySeqType HMM_PROFILE
(lib/mmseqs/src/alignment/Alignment.cpp:244-312 + Matcher::getSWResult
with the PROFILE_SEQ ssw path, StripedSmithWaterman.cpp:296-299,1474):
the query's position-specific scores come from the stored PSSM (/4), no
composition bias, targets are plain sequences. Output rows follow
Matcher::compareHits order and resultToBuffer formatting; backtraces via
the banded PROFILE_SEQ traceback; seqId counts target residues equal to
the profile's query letters (computerBacktrace,
StripedSmithWaterman.cpp:558). The alignment runs on the wrappers of the
profile search (ops/sw_cuda.py align_full_prof) with cap=None: K1/K2's
uncapped PSSM instances, since the JAX aligner runs sw_jax's
sw_align_batch_prof, which does not cap H at 32767 (the profile search's
ProfileSearchDriver follows the Pallas route and caps). Per (Lq, Lt)
bucket the bucket's profiles and targets are staged once and the pairs
launched by index; a pair that does not align reports q_end Lq - 1 of its
bucket, as the JAX aligner's padded batch does.
"""

import numpy as np
import torch

from ..data.submat import encode_aa
from ..ops import sw_cuda
from .driver import HIT_DTYPE, _bucket, pad_rows
from .evalue import EvalueComputation
from .profile_search import pairs_per_launch


class ProfileQueryAligner:
    """Aligns an HMM-profile query DB against an encoded sequence target
    set given (profile_idx, target_idx) candidate pairs, on `device`."""

    def __init__(self, params, profile_db, target_db, device="cuda"):
        self.params = params
        self.profiles = profile_db
        self.device = torch.device(device)
        self.prof_lens = np.array([len(p) for p in profile_db.pssms],
                                  np.int64)
        self.targets_enc = [encode_aa(target_db.seq_bytes(i))
                            for i in range(len(target_db))]
        self.target_lens = np.array([len(t) for t in self.targets_enc],
                                    np.int64)
        self.evaluer = EvalueComputation(target_db.total_residues(),
                                         gapped=True)

    def search(self, pair_generator, eval_thr=None):
        """HIT_DTYPE rows (orf_idx = profile index) in compareHits order."""
        p = self.params
        pairs = np.asarray(list(pair_generator), dtype=np.int64)
        if len(pairs) == 0:
            return np.zeros(0, dtype=HIT_DTYPE)
        pi, ti = pairs[:, 0], pairs[:, 1]
        keep = (self.prof_lens[pi] > 0) & (self.target_lens[ti] > 0)
        pi, ti = pi[keep], ti[keep]
        if len(pi) == 0:
            return np.zeros(0, dtype=HIT_DTYPE)

        dev = self.device
        lq_b = np.array([_bucket(max(l, 1)) for l in self.prof_lens])[pi]
        lt_b = np.array([_bucket(max(l, 1)) for l in self.target_lens])[ti]
        out_parts = []
        for (Lq, Lt) in sorted(set(zip(lq_b.tolist(), lt_b.tolist()))):
            sel = np.flatnonzero((lq_b == Lq) & (lt_b == Lt))
            p_ids, li_all = np.unique(pi[sel], return_inverse=True)
            t_ids, lj_all = np.unique(ti[sel], return_inverse=True)
            prof_mat = np.zeros((len(p_ids), Lq, 21), np.int32)
            for k, pid in enumerate(p_ids):
                pm = self.profiles.pssms[pid]
                prof_mat[k, :len(pm)] = pm
            staged = (
                torch.from_numpy(prof_mat).to(dev),
                torch.from_numpy(self.prof_lens[p_ids].astype(np.int32)).to(
                    dev),
                torch.from_numpy(pad_rows([self.targets_enc[t]
                                           for t in t_ids], Lt,
                                          np.uint8)).to(dev),
                torch.from_numpy(self.target_lens[t_ids].astype(
                    np.int32)).to(dev))
            batch_cap = pairs_per_launch(dev.type, Lq, Lt)
            for s in range(0, len(sel), batch_cap):
                chunk = sel[s:s + batch_cap]
                li = torch.from_numpy(
                    li_all[s:s + batch_cap].astype(np.int32)).to(dev)
                lj = torch.from_numpy(
                    lj_all[s:s + batch_cap].astype(np.int32)).to(dev)
                score, qs, qe, ts, te = (
                    o.cpu().numpy()
                    for o in sw_cuda.align_full_prof(*staged, li, lj,
                                                     cap=None))
                part = np.zeros(len(chunk), dtype=HIT_DTYPE)
                part["orf_idx"] = pi[chunk]
                part["target_idx"] = ti[chunk]
                part["score_raw"] = score
                part["q_start"], part["q_end"] = qs, qe
                part["q_len"] = self.prof_lens[pi[chunk]]
                part["t_start"], part["t_end"] = ts, te
                part["t_len"] = self.target_lens[ti[chunk]]
                out_parts.append(part)
        hits = np.concatenate(out_parts)
        ev = self.evaluer
        score = hits["score_raw"].astype(np.float64)
        hits["evalue"] = ev.compute_evalue(score,
                                           hits["q_len"].astype(np.float64))
        hits["bit_score"] = ev.compute_bit_score_int(score)

        thr = p.search_evalue_thr if eval_thr is None else eval_thr
        aligned = (hits["t_end"] >= 0) & (hits["score_raw"] > 0) \
            & (hits["t_start"] >= 0)
        aln_len = np.maximum(np.abs(hits["q_end"] - hits["q_start"]),
                             np.abs(hits["t_end"] - hits["t_start"])) + 1
        q_cov = (np.abs(hits["q_end"] - hits["q_start"]) + 1) \
            / np.maximum(hits["q_len"], 1)
        t_cov = (np.abs(hits["t_end"] - hits["t_start"]) + 1) \
            / np.maximum(hits["t_len"], 1)
        if p.cov_mode == 1:  # COV_MODE_TARGET (Util.cpp:496-511)
            has_cov = t_cov >= p.cov_thr
        elif p.cov_mode == 2:  # COV_MODE_QUERY
            has_cov = q_cov >= p.cov_thr
        else:
            has_cov = (q_cov >= p.cov_thr) & (t_cov >= p.cov_thr)
        ok = (aligned & (hits["evalue"] <= thr) & has_cov
              & (aln_len >= p.aln_len_thr))
        hits = hits[ok]
        order = np.lexsort((hits["target_idx"], hits["t_len"],
                            -hits["bit_score"], hits["evalue"],
                            hits["orf_idx"]))
        return hits[order]

    def backtraces(self, hits):
        """(backtrace strings, exact seqIds) for accepted hits — the
        PROFILE_SEQ banded traceback; identity counts target residues
        matching the profile's query letters. Copied from
        profile_align.py:131."""
        from .. import native

        p = self.params
        bts = []
        seq_ids = np.zeros(len(hits), np.float32)
        for idx, h in enumerate(hits):
            pidx = int(h["orf_idx"])
            pssm = np.asarray(self.profiles.pssms[pidx], np.int32)
            qseq = self.profiles.query_seqs[pidx]
            t_enc = self.targets_enc[int(h["target_idx"])]
            qs, qe = int(h["q_start"]), int(h["q_end"])
            ts, te = int(h["t_start"]), int(h["t_end"])
            band = abs((te - ts + 1) - (qe - qs + 1)) + 1
            bt = native.banded_sw_traceback_prof(
                pssm[qs:qe + 1], t_enc[ts:te + 1], int(h["score_raw"]),
                band, p.gap_open, p.gap_extend)
            if bt is None:
                bt = ""
            bts.append(bt)
            if bt:
                qp, tp, ids = qs, ts, 0
                for op in bt:
                    if op == "M":
                        ids += int(qseq[qp] == t_enc[tp])
                        qp += 1
                        tp += 1
                    elif op == "I":
                        qp += 1
                    else:
                        tp += 1
                seq_ids[idx] = np.float32(ids) / np.float32(len(bt))
        return bts, seq_ids
