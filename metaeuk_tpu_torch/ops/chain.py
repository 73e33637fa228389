# Copy of metaeuk_tpu/ops/chain.py; only the imports differ.
"""Optimal exon-set chaining dynamic program.

Exact port of the reference's collectoptimalset core
(src/exonpredictor/collectoptimalset.cpp):

- PotentialExon coordinate model with negative contig coordinates on the
  minus strand (src/commons/PredictionParser.h:38-51)
- pair compatibility: same strand, containment/overlap exclusion, intron
  length window, bounded target overlap, colinear target order
  (collectoptimalset.cpp:36-82)
- transition penalty on missed/overlapping target residues
  (getPenaltyForProtCoords, :84-106), +int(log2(numExons)) bonus (:174)
- target-coverage gate on pathAALen/targetLen (:194)
- suboptimal-set iteration via isUsed marking (:313-349, :121-130)
- combined E-value = totAAs * 2 * 2^-S (:322-324)
"""

import dataclasses
import math

import numpy as np

PLUS = 1
MINUS = -1


@dataclasses.dataclass
class PotentialExon:
    """One candidate exon (an ORF↔target alignment mapped to contig coords)."""
    exon_key: int              # ORF key
    target_key: int
    strand: int
    bit_score: int
    seq_id_text: str           # 3-decimal text as serialized by the aligner
    evalue_text: str           # %.3E text as serialized by the aligner
    target_match_start: int
    target_match_end: int
    target_len: int
    contig_start: int          # negative on MINUS strand (PredictionParser.h:184-186)
    contig_end: int
    nucleotide_len: int
    contig_start_before_trim: int
    contig_end_before_trim: int
    aa_len: int = 0
    target_cov: float = 0.0
    is_used: bool = False
    adjusted_contig_start: int = 0

    def __post_init__(self):
        self.aa_len = self.nucleotide_len // 3
        self.target_cov = float(self.target_match_end - self.target_match_start + 1) \
            / float(self.target_len)


def make_potential_exon(orf_key, target_key, bit_score, seq_id_text, evalue_text,
                        orf_prot_start, orf_prot_end, target_match_start,
                        target_match_end, target_len, contig_start_before_trim,
                        contig_end_before_trim):
    """PotentialExon::setByAln (PredictionParser.h:15-65)."""
    if contig_start_before_trim < contig_end_before_trim:
        contig_start = contig_start_before_trim + orf_prot_start * 3
        contig_end = contig_start_before_trim + orf_prot_end * 3 + 2
        strand = PLUS
    else:
        contig_start = -1 * (contig_start_before_trim - orf_prot_start * 3)
        contig_end = -1 * (contig_start_before_trim - orf_prot_end * 3 - 2)
        strand = MINUS
    nucleotide_len = contig_end - contig_start + 1
    if nucleotide_len % 3 != 0:
        raise ValueError("illegal codon segment length")
    return PotentialExon(
        exon_key=orf_key, target_key=target_key, strand=strand,
        bit_score=bit_score, seq_id_text=seq_id_text, evalue_text=evalue_text,
        target_match_start=target_match_start, target_match_end=target_match_end,
        target_len=target_len, contig_start=contig_start, contig_end=contig_end,
        nucleotide_len=nucleotide_len,
        contig_start_before_trim=contig_start_before_trim,
        contig_end_before_trim=contig_end_before_trim)


def is_pair_compatible(first, second, min_intron, max_intron, max_aa_overlap):
    """(compatible, aa_overlap_target) — collectoptimalset.cpp:36-82."""
    if first.strand != second.strand:
        return False, 0
    if second.contig_end < first.contig_end:
        return False, 0
    diff_on_contig = second.contig_start - first.contig_end - 1
    if diff_on_contig < 0:
        return False, 0
    if diff_on_contig < min_intron or diff_on_contig > max_intron:
        return False, 0
    diff_aas = second.target_match_start - first.target_match_end - 1
    aa_overlap = 0
    if diff_aas < 0:
        aa_overlap = -diff_aas
        if aa_overlap > max_aa_overlap:
            return False, 0
    if second.target_match_start < first.target_match_start:
        return False, 0
    return True, aa_overlap


def penalty_for_prot_coords(prev, curr, gap_open, gap_extend):
    """collectoptimalset.cpp:84-106 (gap_open/extend are negative)."""
    diff_aas = curr.target_match_start - prev.target_match_end - 1
    if diff_aas < 0:
        return gap_open + gap_extend * (-diff_aas - 1)
    if diff_aas <= 1:
        return 0
    return gap_open + gap_extend * (diff_aas - 1)


def find_optimal_set(candidates, params):
    """One DP round over a mutable candidate list; marks used exons.

    Returns (total_bit_score, optimal_exon_set). The candidate list is
    pruned of previously used exons, exactly like the reference
    (collectoptimalset.cpp:108-222).
    """
    if not candidates:
        return 0, []
    # stable sort by (isUsed, contigStart, contigEnd)
    candidates.sort(key=lambda e: (e.is_used, e.contig_start, e.contig_end))
    # drop used tail
    first_used = len(candidates)
    for i, e in enumerate(candidates):
        if e.is_used:
            first_used = i
            break
    del candidates[first_used:]
    n = len(candidates)
    if n == 0:
        return 0, []

    target_len = candidates[0].target_len
    p = params

    # native O(n^2) DP when available (native/host_ops.cpp chain_dp)
    from .. import native
    nat = native.chain_dp(
        np.array([e.contig_start for e in candidates]),
        np.array([e.contig_end for e in candidates]),
        np.array([e.target_match_start for e in candidates]),
        np.array([e.target_match_end for e in candidates]),
        np.array([e.bit_score for e in candidates]),
        np.array([e.aa_len for e in candidates]),
        target_len, p)
    if nat is not None:
        prev_id, _path_score, best_last, best_score = nat
        if best_score == 0:
            return 0, []
        optimal = []
        curr = best_last
        while prev_id[curr] != curr:
            optimal.append(candidates[curr])
            candidates[curr].is_used = True
            curr = int(prev_id[curr])
        optimal.append(candidates[curr])
        candidates[curr].is_used = True
        optimal.reverse()
        return int(best_score), optimal

    prev_id = np.arange(n, dtype=np.int64)
    path_score = np.array([e.bit_score for e in candidates], dtype=np.int64)
    num_exons = np.ones(n, dtype=np.int64)
    path_aa_len = np.array([e.aa_len for e in candidates], dtype=np.int64)

    best_score = 0
    best_last = 0
    for curr in range(n):
        ec = candidates[curr]
        for prev in range(curr):
            epv = candidates[prev]
            compatible, aa_overlap = is_pair_compatible(
                epv, ec, p.min_intron_length, p.max_intron_length, p.max_aa_overlap)
            if not compatible:
                continue
            cost = penalty_for_prot_coords(
                epv, ec, p.set_gap_open_penalty, p.set_gap_extend_penalty)
            k = num_exons[prev] + 1
            bonus = int(math.log2(k))
            cand_score = path_score[prev] + cost + ec.bit_score + bonus
            if cand_score > path_score[curr]:
                prev_id[curr] = prev
                path_score[curr] = cand_score
                num_exons[curr] = k
                path_aa_len[curr] = path_aa_len[prev] + ec.aa_len - aa_overlap
        if float(path_aa_len[curr]) / float(target_len) >= p.metaeuk_tcov_thr:
            if path_score[curr] > best_score:
                best_last = curr
                best_score = int(path_score[curr])

    if best_score == 0:
        return 0, []

    optimal = []
    curr = best_last
    while prev_id[curr] != curr:
        optimal.append(candidates[curr])
        candidates[curr].is_used = True
        curr = int(prev_id[curr])
    optimal.append(candidates[curr])
    candidates[curr].is_used = True
    optimal.reverse()
    return best_score, optimal


@dataclasses.dataclass
class Prediction:
    """One optimal exon set (Prediction, PredictionParser.h:218-443)."""
    target_key: int
    strand: int
    total_bitscore: int
    combined_evalue: float
    combined_evalue_text: str
    exons: list
    low_contig_coord: int = 0
    high_contig_coord: int = 0
    # clustering state (reduceredundancy)
    cluster_id: int = 0
    cluster_low_coord: int = 0
    no_overlap_cluster_id: int = 0
    no_overlap_cluster_low_coord: int = 0

    def __post_init__(self):
        first, last = self.exons[0], self.exons[-1]
        if first.strand == PLUS:
            self.low_contig_coord = first.contig_start
            self.high_contig_coord = last.contig_end
        else:
            self.low_contig_coord = -1 * last.contig_end
            self.high_contig_coord = -1 * first.contig_start

    @property
    def num_exons(self):
        return len(self.exons)


def collect_optimal_sets(groups, tot_aas_in_target_db, params):
    """All predictions for one contig.

    groups: iterable of (target_key, plus_exons, minus_exons) sorted by
    target_key ascending (the reference's streaming order,
    collectoptimalset.cpp:288-369). Returns list[Prediction] in emission
    order (per target: up to max_exon_sets iterations; PLUS then MINUS).
    """
    p = params
    log2_m = math.log2(tot_aas_in_target_db)
    out = []
    for target_key, plus_exons, minus_exons in groups:
        plus = [e for e in plus_exons if abs(e.nucleotide_len) // 3 >= p.min_exon_aa_length]
        minus = [e for e in minus_exons if abs(e.nucleotide_len) // 3 >= p.min_exon_aa_length]
        iters = 0
        while iters < p.max_exon_sets and (plus or minus):
            score_plus, set_plus = find_optimal_set(plus, p)
            score_minus, set_minus = find_optimal_set(minus, p)
            for strand, score, exon_set in ((PLUS, score_plus, set_plus),
                                            (MINUS, score_minus, set_minus)):
                if not exon_set:
                    continue
                log2_e = log2_m + 1.0 - score
                evalue = math.pow(2.0, log2_e)
                if evalue <= p.metaeuk_evalue_thr:
                    # downstream stages in the reference parse the %.3E text
                    # (Prediction::setByDPRes, PredictionParser.h:254), so the
                    # effective E-value is the text round-trip
                    text = "%.3E" % evalue
                    out.append(Prediction(
                        target_key=target_key, strand=strand,
                        total_bitscore=score, combined_evalue=float(text),
                        combined_evalue_text=text, exons=list(exon_set)))
            iters += 1
    return out
