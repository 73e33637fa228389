"""Profile-target search (the --exhaustive-search sliced-profile mode) on
one torch device.

Counterpart of metaeuk_tpu/search/profile_search.py: the reference's
inverted profile search (workflow/Search.cpp:357-400 +
data/workflow/searchslicedtargetprofile.sh): profiles act as queries
against the fragment DB (PROFILE_SEQ alignment, no composition bias), the
E-value threshold is scaled by (#fragments / #profiles), and swapresults
re-keys hits per fragment, recomputing the E-value from the integer bit
score with the profile-side residue count (Matcher::result_t::swapResult,
Matcher.h:94-115; swapresults.cpp:76, :273).

The alignment runs on the PSSM entries of K1/K2 (ops/sw_cuda.py
align_full_prof, csrc/sw_pair.cu), which read each pair's profile and
fragment from per-bucket staged matrices by index, at every profile length:
the JAX driver's XLA route for profiles over 4096 rows, its power-of-4
padding of batch rows and its deferred fetch are not ported (they serve
the TPU's jit shapes and host link). The hit array is the JAX driver's,
field for field.
"""

import math
import os
import time

import numpy as np
import torch

from ..data.submat import encode_aa
from ..ops import sw_cuda
from ..utils import log
from .driver import (CELL_BUDGET, HIT_DTYPE, MAX_PAIRS_PER_LAUNCH,
                     estimate_seq_id, pad_rows)
from .evalue import EvalueComputation

# staged-profile bytes per slice (searchslicedtargetprofile.sh:46-120
# sizes profile slices to a disk budget; here the budget bounds the host
# and device staging of the PSSM matrices, counted as int32 as the JAX
# driver counts them). Overridable per run via Params.disk_space_limit (the
# reference's --disk-space-limit role) or METAEUK_SLICE_BUDGET. Copied from
# profile_search.py:21.
SLICE_BUDGET = 1 << 28

# wall seconds per search() phase and the pairs and DP cells aligned
# (forward over every candidate pair, reverse up to each hit's end cell),
# summed over calls; reset by the caller
PHASE_SECONDS = {}
COUNTS = {"pairs": 0, "fwd_cells": 0, "rev_cells": 0}


def _slice_budget(params):
    """Copied from profile_search.py:29."""
    env = os.environ.get("METAEUK_SLICE_BUDGET")
    if env:
        return max(1 << 20, int(env))
    if getattr(params, "disk_space_limit", 0):
        return max(1 << 20, int(params.disk_space_limit))
    return SLICE_BUDGET


def _bucket(n, lo=256):
    """Coarse x4 length tiers (copied from profile_search.py:39)."""
    b = lo
    while b < n:
        b *= 4
    return b


def pairs_per_launch(device_type, Lq, Lt):
    """Pairs a launch of the PSSM kernels takes in an (Lq, Lt) bucket: the
    pair kernels' cap (search/driver.py), CELL_BUDGET cells of Lq x Lt and
    at most MAX_PAIRS_PER_LAUNCH pairs; with profiles over 512 rows a launch
    holds a (pairs, Lt) int32 stripe hand-off, at most 2^34 / Lq bytes."""
    budget = CELL_BUDGET.get(device_type, CELL_BUDGET["cpu"])
    return max(8, min(budget // (Lq * Lt), MAX_PAIRS_PER_LAUNCH))


def slice_search_db(query_db, prof_db, out_db, evalue=0.001,
                    add_backtrace=True, params=None, device="cuda"):
    """DB-level sliced profile-target search (`search
    --exhaustive-search [-a]`, searchslicedtargetprofile.sh): fragments
    vs an HMM-profile DB, results keyed per fragment (profile_search.py:49,
    with the alignment on `device`)."""
    import dataclasses

    from ..io import mmseqsdb
    from ..io.profiledb import ProfileDB
    from ..params import Params
    from ..pipeline.alnformat import (compress_backtrace,
                                      matcher_seq_id_text)

    p = params or Params()
    p = dataclasses.replace(p, search_evalue_thr=evalue)
    qdb = mmseqsdb.read_seqdb(query_db)
    profiles = ProfileDB.from_db(str(prof_db))
    driver = ProfileSearchDriver(p, profiles, device)
    qbytes = [qdb.seq_bytes(i) for i in range(len(qdb))]
    hits = driver.search(qbytes)
    bts = sids = None
    if add_backtrace:
        orfs_enc = [encode_aa(s) for s in qbytes]
        bts, sids = driver.backtraces(hits, orfs_enc)
    by_query = {i: [] for i in range(len(qdb))}
    for idx, h in enumerate(hits):
        sid = sids[idx] if sids is not None else h["seq_id"]
        line = (f"{profiles.keys[int(h['target_idx'])]}\t"
                f"{int(h['bit_score'])}\t{matcher_seq_id_text(sid)}\t"
                f"{'%.3E' % h['evalue']}\t{int(h['q_start'])}\t"
                f"{int(h['q_end'])}\t{int(h['q_len'])}\t"
                f"{int(h['t_start'])}\t{int(h['t_end'])}\t"
                f"{int(h['t_len'])}")
        if bts is not None:
            line += f"\t{compress_backtrace(bts[idx])}"
        by_query[int(h["orf_idx"])].append(line + "\n")
    out = [(int(qdb.keys[i]), "".join(by_query[i]).encode())
           for i in range(len(qdb))]
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_ALIGNMENT_RES)
    return out_db


class ProfileSearchDriver:
    """Aligns encoded fragments against an HMM-profile DB (inverted) on
    `device`."""

    def __init__(self, params, profile_db, device="cuda"):
        self.params = params
        self.profiles = profile_db
        self.device = torch.device(device)
        self.profile_lens = np.array([len(p) for p in profile_db.pssms],
                                     np.int64)
        self.phase_seconds = {}

    def _candidate_pairs(self, orfs_enc, orf_lens, n_orfs, n_prof):
        """(profile_idx, orf_idx) candidate pairs (copied from
        profile_search.py:138).

        Default mode mirrors the reference's sliced workflow
        (searchslicedtargetprofile.sh:108-110 runs the k-mer PREFILTER
        with the profiles as queries against the fragment DB, with
        maxResListLen = max(300, #fragments), Search.cpp:373): the
        native profile-query prefilter (pf_match_profile) generates the
        candidate set, and only candidates are aligned on the device.
        METAEUK_PROFILE_PREF=exhaustive restores the full cross
        product (aligns every (profile, fragment) pair; equivalent
        output whenever every E-value survivor also passes the k-mer
        gate, but O(n_prof*n_orfs) device work)."""
        mode = os.environ.get(
            "METAEUK_PROFILE_PREF",
            getattr(self.params, "prefilter_mode", "kmer"))
        raws = getattr(self.profiles, "raw_scores", None)
        if mode == "kmer" and raws is not None and n_orfs > 0:
            import concurrent.futures as cf
            import threading

            from .prefilter_kmer import (KmerPrefilter,
                                         profile_kmer_threshold)
            pf = KmerPrefilter(orfs_enc, kmer_score=0,
                               max_res_list_len=max(300, n_orfs))
            prof_thr = profile_kmer_threshold(self.params.sensitivity)
            # one native scratch per worker thread: the ctypes call
            # releases the GIL and every mutable buffer lives in the
            # scratch, so per-profile matches run on all host cores
            # against the shared read-only index
            nw = max(1, min(os.cpu_count() or 1, 8))
            tls = threading.local()
            prog = log.progress(n_prof, "profile prefilter")

            def one(pid):
                sc = getattr(tls, "sc", None)
                if sc is None:
                    sc = tls.sc = pf.new_scratch()
                ids, _scs, _dgs = pf.match_profile(
                    raws[pid], self.profiles.query_seqs[pid],
                    kmer_thr=prof_thr, scratch=sc)
                prog.update()
                return ids

            if nw > 1:
                with cf.ThreadPoolExecutor(nw) as ex:
                    per = list(ex.map(one, range(n_prof), chunksize=64))
            else:
                per = [one(pid) for pid in range(n_prof)]
            prog.finish()
            pi_parts, oi_parts = [], []
            for pid, ids in enumerate(per):
                if len(ids):
                    pi_parts.append(np.full(len(ids), pid, np.int64))
                    oi_parts.append(ids.astype(np.int64))
            if not pi_parts:
                return (np.zeros(0, np.int64), np.zeros(0, np.int64))
            return np.concatenate(pi_parts), np.concatenate(oi_parts)
        pi = np.repeat(np.arange(n_prof, dtype=np.int64), n_orfs)
        oi = np.tile(np.arange(n_orfs, dtype=np.int64), n_prof)
        return pi, oi

    def search(self, orf_aa_seqs):
        p = self.params
        orfs_enc = [encode_aa(s) for s in orf_aa_seqs]
        orf_lens = np.array([len(e) for e in orfs_enc], np.int64)
        n_orfs = len(orfs_enc)
        n_prof = len(self.profiles)
        if n_orfs == 0 or n_prof == 0:
            return np.zeros(0, dtype=HIT_DTYPE)
        phase_s = {}
        t_last = time.perf_counter()

        def mark(name):
            nonlocal t_last
            t = time.perf_counter()
            phase_s[name] = phase_s.get(name, 0.0) + (t - t_last)
            t_last = t

        # evaluers: inverted pass vs swapped results (swapresults.cpp:76)
        total_orf_res = int(orf_lens.sum())
        ev_inv = EvalueComputation(total_orf_res, gapped=True)
        ev_swap = EvalueComputation(self.profiles.total_residues(),
                                    gapped=True)
        # Search.cpp:366-368: evalThr *= (float)queryDbSize/targetDbSize
        scaled_thr = p.search_evalue_thr * float(
            np.float32(np.float32(n_orfs) / np.float32(n_prof)))

        pi, oi = self._candidate_pairs(orfs_enc, orf_lens, n_orfs, n_prof)
        keep = (orf_lens[oi] > 0) & (self.profile_lens[pi] > 0)
        pi, oi = pi[keep], oi[keep]
        mark("profile prefilter")

        # per (Lq, Lt) bucket: the bucket's fragments staged once, its
        # profiles in slices sized to the staging budget (the reference
        # sizes profile slices to --disk-space-limit,
        # searchslicedtargetprofile.sh:46-120), pairs gathered on the
        # device by index
        lq_b = np.array([_bucket(l) for l in self.profile_lens])[pi]
        lt_b = np.array([_bucket(max(l, 1)) for l in orf_lens])[oi]
        dev = self.device
        parts = []
        slice_rows = _slice_budget(p)
        for (Lq, Lt) in sorted(set(zip(lq_b.tolist(), lt_b.tolist()))):
            bsel = np.flatnonzero((lq_b == Lq) & (lt_b == Lt))
            p_ids_all = np.unique(pi[bsel])
            o_ids = np.unique(oi[bsel])
            t_dev = torch.from_numpy(pad_rows([orfs_enc[o] for o in o_ids],
                                              Lt, np.uint8)).to(dev)
            tl_dev = torch.from_numpy(orf_lens[o_ids].astype(np.int32)).to(
                dev)
            o_remap = np.zeros(int(o_ids.max()) + 1, np.int32)
            o_remap[o_ids] = np.arange(len(o_ids), dtype=np.int32)
            per_slice = max(8, slice_rows // (Lq * 21 * 4))
            pos_of = np.searchsorted(p_ids_all, pi[bsel])
            for s0 in range(0, len(p_ids_all), per_slice):
                p_ids = p_ids_all[s0:s0 + per_slice]
                sel = bsel[(pos_of >= s0) & (pos_of < s0 + per_slice)]
                prof_mat = np.zeros((len(p_ids), Lq, 21), np.int32)
                for k, pid in enumerate(p_ids):
                    pssm = self.profiles.pssms[pid]
                    prof_mat[k, :len(pssm)] = pssm
                prof_dev = torch.from_numpy(prof_mat).to(dev)
                pl_dev = torch.from_numpy(
                    self.profile_lens[p_ids].astype(np.int32)).to(dev)
                p_remap = np.zeros(int(p_ids.max()) + 1, np.int32)
                p_remap[p_ids] = np.arange(len(p_ids), dtype=np.int32)
                cap = pairs_per_launch(dev.type, Lq, Lt)
                for s in range(0, len(sel), cap):
                    chunk = sel[s:s + cap]
                    li = torch.from_numpy(p_remap[pi[chunk]]).to(dev)
                    lj = torch.from_numpy(o_remap[oi[chunk]]).to(dev)
                    outs = sw_cuda.align_full_prof(prof_dev, pl_dev, t_dev,
                                                   tl_dev, li, lj)
                    parts.append((chunk, [o.cpu().numpy() for o in outs]))
        mark("align")
        if not parts:
            return np.zeros(0, dtype=HIT_DTYPE)
        rows = np.concatenate([c for c, _ in parts])
        cat = [np.concatenate([o[k] for _, o in parts]) for k in range(5)]
        # store inverted-orientation coords; swapped later
        hits = np.zeros(len(rows), dtype=HIT_DTYPE)
        hits["orf_idx"] = oi[rows]
        hits["target_idx"] = pi[rows]
        hits["score_raw"] = cat[0]
        hits["q_start"], hits["q_end"] = cat[1], cat[2]
        hits["q_len"] = self.profile_lens[pi[rows]]
        hits["t_start"], hits["t_end"] = cat[3], cat[4]
        hits["t_len"] = orf_lens[oi[rows]]
        hit = cat[4] >= 0
        COUNTS["pairs"] += len(rows)
        COUNTS["fwd_cells"] += int((hits["q_len"].astype(np.int64)
                                    * hits["t_len"]).sum())
        COUNTS["rev_cells"] += int(((cat[2][hit].astype(np.int64) + 1)
                                    * (cat[4][hit].astype(np.int64) + 1))
                                   .sum())
        out = self._filter_swap_sort(hits, ev_inv, ev_swap, scaled_thr)
        mark("filter_swap_sort")
        self.phase_seconds = phase_s
        for k, v in phase_s.items():
            PHASE_SECONDS[k] = PHASE_SECONDS.get(k, 0.0) + v
        log.info("profile search phases: " + "  ".join(
            f"{k}={v:.2f}s" for k, v in phase_s.items())
            + f"  pairs={len(rows)} hits={len(out)}")
        return out

    def backtraces(self, hits, orfs_enc):
        """True backtraces + seqIds for SWAPPED output rows (the -a /
        alignment-mode-3 path of the sliced search): the PROFILE_SEQ
        banded traceback on the pre-swap orientation, then the
        swapresults I<->D cigar flip (Matcher.h swapResult). Copied from
        profile_search.py:332."""
        from .. import native

        p = self.params
        bts = []
        seq_ids = np.zeros(len(hits), np.float32)
        swap = str.maketrans("ID", "DI")
        for idx, h in enumerate(hits):
            pidx = int(h["target_idx"])
            pssm = np.asarray(self.profiles.pssms[pidx], np.int32)
            qletters = self.profiles.query_seqs[pidx]
            frag = orfs_enc[int(h["orf_idx"])]
            # pre-swap: profile = (t_start..t_end), fragment = (q..)
            ps, pe = int(h["t_start"]), int(h["t_end"])
            fs, fe = int(h["q_start"]), int(h["q_end"])
            band = abs((fe - fs + 1) - (pe - ps + 1)) + 1
            bt = native.banded_sw_traceback_prof(
                pssm[ps:pe + 1], frag[fs:fe + 1], int(h["score_raw"]),
                band, p.gap_open, p.gap_extend)
            if not bt:
                bts.append("")
                continue
            pp, fp, ids = ps, fs, 0
            for op in bt:
                if op == "M":
                    ids += int(qletters[pp] == frag[fp])
                    pp += 1
                    fp += 1
                elif op == "I":
                    pp += 1
                else:
                    fp += 1
            seq_ids[idx] = np.float32(ids) / np.float32(len(bt))
            bts.append(bt.translate(swap))
        return bts, seq_ids

    def _filter_swap_sort(self, hits, ev_inv, ev_swap, scaled_thr):
        """Copied from profile_search.py:372."""
        p = self.params
        score = hits["score_raw"].astype(np.float64)
        # inverted pass: evalue over the profile length
        eval_inv = ev_inv.compute_evalue(score,
                                         hits["q_len"].astype(np.float64))
        bit = ev_inv.compute_bit_score_int(score)
        q_aln = np.maximum(hits["q_end"] - hits["q_start"], 1)
        t_aln = np.maximum(hits["t_end"] - hits["t_start"], 1)
        seq_id = estimate_seq_id(hits["score_raw"], q_aln, t_aln)
        aligned = (hits["t_end"] >= 0) & (hits["score_raw"] > 0) \
            & (hits["t_start"] >= 0)
        aln_len = np.maximum(np.abs(hits["q_end"] - hits["q_start"]),
                             np.abs(hits["t_end"] - hits["t_start"])) + 1
        ok = (aligned & (eval_inv <= scaled_thr) & (seq_id >= p.seq_id_thr)
              & (aln_len >= p.aln_len_thr))
        hits = hits[ok]
        bit = bit[ok]
        seq_id = seq_id[ok]

        # swapResult (Matcher.h:94-115): raw from the integer bit score,
        # evalue over the fragment length with profile-side residue count
        raw2 = (ev_swap.log_k + bit.astype(np.float64) * math.log(2.0)) \
            / ev_swap.p["lam"]
        eval_swap = ev_swap.compute_evalue(raw2,
                                           hits["t_len"].astype(np.float64))

        out = np.zeros(len(hits), dtype=HIT_DTYPE)
        out["orf_idx"] = hits["orf_idx"]
        out["target_idx"] = hits["target_idx"]
        out["score_raw"] = hits["score_raw"]
        out["bit_score"] = bit
        out["seq_id"] = seq_id
        out["evalue"] = eval_swap
        # swapped orientation: fragment is the query now
        out["q_start"], out["q_end"] = hits["t_start"], hits["t_end"]
        out["q_len"] = hits["t_len"]
        out["t_start"], out["t_end"] = hits["q_start"], hits["q_end"]
        out["t_len"] = hits["q_len"]
        order = np.lexsort((out["target_idx"], out["t_len"],
                            -out["bit_score"], out["evalue"],
                            out["orf_idx"]))
        return out[order]
