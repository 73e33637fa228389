"""End-to-end gene prediction (easy-predict) with the alignment on a torch
device.

Counterpart of metaeuk_tpu/pipeline/predict.py: EasyPredict.run and
predict_exons, the pipelined extract/prefilter/align path and the serial
k-mer, ungapped (--prefilter-mode ungapped, the gapless scores on the
device) and exhaustive paths, on the port's SearchDriver (search/driver.py)
and an explicit `device`, and the profile-DB path on ProfileSearchDriver
(search/profile_search.py). The host stages (ORF extraction, the k-mer
prefilter, the chain DP, reduce and the writers) are the port's own copies
of metaeuk_tpu's modules. The module-level helpers below are copied from
metaeuk_tpu/pipeline/predict.py; each names its origin. contig_range runs
one contig partition (parallel/multihost.py), and `devices` fans the
driver's launches over a device list (search/driver.py).
"""

import os

import numpy as np

from .. import native
from ..io import mmseqsdb
from ..io.profiledb import DBTYPE_HMM_PROFILE, ProfileDB
from ..io.seqdb import SeqDB, DBTYPE_AA, DBTYPE_NUCL
from ..ops.chain import MINUS, PLUS, PotentialExon, Prediction
from ..ops.orf import OrfExtractor
from ..params import Params
from ..search.driver import HIT_DTYPE, SearchDriver, device_list
from ..utils import log, session
from .output import PredictionWriter
from .reduce import reduce_redundancy


def format_seq_id(seq_id):
    """Util::fastSeqIdToBuffer (Util.cpp:222-251); copied from
    predict.py:26."""
    s = np.float32(seq_id)
    if s == np.float32(1.0):
        return "1.000"
    out = "0."
    if s < np.float32(0.10):
        out += "0"
    if s < np.float32(0.01):
        out += "0"
    return out + str(int(s * np.float32(1000)))


def format_evalue(e):
    """%.3E, identical to printf (Matcher.cpp:288); copied from
    predict.py:39."""
    return "%.3E" % e


def load_sequence_input(path, default_dbtype):
    """FASTA file or MMseqs sequence-DB path (copied from predict.py:44)."""
    if os.path.exists(f"{path}.dbtype"):
        return mmseqsdb.read_seqdb(path)
    return SeqDB.from_fasta(path, default_dbtype)


def load_target_input(path):
    """FASTA, MMseqs sequence DB, or MMseqs HMM-profile DB (copied from
    predict.py:52)."""
    if os.path.exists(f"{path}.dbtype"):
        if mmseqsdb.read_dbtype(path) == DBTYPE_HMM_PROFILE:
            return ProfileDB.from_db(path)
        db = mmseqsdb.read_seqdb(path)
        # remember the source so the prefilter can reuse a persisted
        # createindex artifact ({path}.kidx)
        db.source_path = str(path)
        return db
    return SeqDB.from_fasta(path, DBTYPE_AA)


def _chain_dp_py(cs, ce, ts, te, bit, aa, target_len, p):
    """Pure-Python chain DP over columns (native chain_dp fallback);
    same contract as native.chain_dp (collectoptimalset.cpp:108-222).
    Copied from predict.py:67."""
    import math
    n = len(cs)
    prev_id = np.arange(n, dtype=np.int64)
    path_score = bit.astype(np.int64).copy()
    num_exons = np.ones(n, np.int64)
    path_aa = aa.astype(np.int64).copy()
    best_score = 0
    best_last = 0
    for curr in range(n):
        for prev in range(curr):
            if ce[curr] < ce[prev]:
                continue
            diff_c = cs[curr] - ce[prev] - 1
            if diff_c < p.min_intron_length or diff_c > p.max_intron_length:
                continue
            diff_aas = ts[curr] - te[prev] - 1
            aa_overlap = -diff_aas if diff_aas < 0 else 0
            if aa_overlap > p.max_aa_overlap:
                continue
            if ts[curr] < ts[prev]:
                continue
            if diff_aas < 0:
                cost = p.set_gap_open_penalty \
                    + p.set_gap_extend_penalty * (-diff_aas - 1)
            elif diff_aas <= 1:
                cost = 0
            else:
                cost = p.set_gap_open_penalty \
                    + p.set_gap_extend_penalty * (diff_aas - 1)
            k = num_exons[prev] + 1
            cand = path_score[prev] + cost + int(bit[curr]) \
                + int(math.log2(k))
            if cand > path_score[curr]:
                prev_id[curr] = prev
                path_score[curr] = cand
                num_exons[curr] = k
                path_aa[curr] = path_aa[prev] + aa[curr] - aa_overlap
        if float(path_aa[curr]) / float(target_len) >= p.metaeuk_tcov_thr \
                and path_score[curr] > best_score:
            best_last = curr
            best_score = int(path_score[curr])
    return prev_id, path_score, best_last, best_score


def _chain_groups_batched(hits, idx_all, kc, kt, plus, cs, ce, tstart,
                          tend, bit, aa, log2_m, mk_exon, p):
    """One native call for every (contig, target, strand) candidate set
    (collectoptimalset.cpp:273 OMP loop role). Returns the
    {contig: [Prediction]} map, or None when the native library is
    unavailable (callers fall back to the per-group loop). Copied from
    predict.py:114."""
    import math

    # strand-contiguous subgroups in (contig, target, plus-before-minus)
    # order — exactly the reference's emission sequence for one round
    sk = (~plus[idx_all]).astype(np.int8)
    order2 = np.lexsort((idx_all, sk, kt, kc))
    gidx = idx_all[order2]
    kc2 = kc[order2]
    kt2 = kt[order2]
    sk2 = sk[order2]
    change = np.nonzero((np.diff(kc2) != 0) | (np.diff(kt2) != 0)
                        | (np.diff(sk2) != 0))[0] + 1
    starts2 = np.concatenate([[0], change, [len(gidx)]])
    tlen_g = hits["t_len"][gidx[starts2[:-1]]].astype(np.int64)
    res = native.chain_dp_groups(
        starts2, cs[gidx], ce[gidx], tstart[gidx], tend[gidx], bit[gidx],
        aa[gidx], tlen_g, p)
    if res is None:
        return None
    best, plen, path = res
    preds_per_contig = {}
    for g in np.flatnonzero(best > 0):
        score = int(best[g])
        log2_e = log2_m + 1.0 - score
        evalue = math.pow(2.0, log2_e)
        if evalue > p.metaeuk_evalue_thr:
            continue
        lo = int(starts2[g])
        chosen = gidx[path[lo:lo + int(plen[g])]]
        text = "%.3E" % evalue
        preds_per_contig.setdefault(int(kc2[lo]), []).append(Prediction(
            target_key=int(kt2[lo]),
            strand=PLUS if sk2[lo] == 0 else MINUS,
            total_bitscore=score, combined_evalue=float(text),
            combined_evalue_text=text,
            exons=[mk_exon(int(j)) for j in chosen]))
    return preds_per_contig


def assemble_and_chain(hits, hit_contig, orf_locs, tot_aas, seqid_rounds, p):
    """Array-level candidate-exon assembly + chaining DP.

    Replaces the per-hit Python object loop (the reference OMPs the same
    loop, collectoptimalset.cpp:273): contig coordinates, strand, and
    lengths are computed as numpy columns over the sorted hit table,
    (contig, target) group boundaries come from one diff pass, each
    (group, strand) candidate set feeds native chain_dp directly from
    column slices, and PotentialExon objects are materialized only for
    exons that survive into an optimal set (the %.3E / seqId text round
    trips are per-surviving-exon, not per-hit).

    hits must be lexsorted by (contig, target, orf); returns
    {contig_idx: [Prediction]} in the reference emission order. Copied
    from predict.py:161."""
    import math

    n_orfs = len(orf_locs)
    orf_from = np.fromiter((l.from_pos for l in orf_locs), np.int64, n_orfs)
    orf_to = np.fromiter((l.to_pos for l in orf_locs), np.int64, n_orfs)
    oi = hits["orf_idx"]
    fb = orf_from[oi]
    tb = orf_to[oi]
    plus = fb < tb
    qs3 = hits["q_start"].astype(np.int64) * 3
    qe3 = hits["q_end"].astype(np.int64) * 3
    # PotentialExon::setByAln coordinate model (PredictionParser.h:15-65):
    # negative contig coordinates on the minus strand
    cs = np.where(plus, fb + qs3, -(fb - qs3))
    ce = np.where(plus, fb + qe3 + 2, -(fb - qe3 - 2))
    nl = ce - cs + 1
    if np.any(nl % 3 != 0):
        raise ValueError("illegal codon segment length")
    aa = nl // 3
    tstart = hits["t_start"].astype(np.int64)
    tend = hits["t_end"].astype(np.int64)
    bit = hits["bit_score"].astype(np.int64)

    keep = aa >= p.min_exon_aa_length
    idx_all = np.nonzero(keep)[0]
    preds_per_contig = {}
    if len(idx_all) == 0:
        return preds_per_contig
    kc = hit_contig[idx_all]
    kt = hits["target_idx"][idx_all]
    change = np.nonzero((np.diff(kc) != 0) | (np.diff(kt) != 0))[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(idx_all)]])

    log2_m = math.log2(tot_aas)

    def mk_exon(j):
        h = hits[j]
        # the reference re-parses and re-serializes the seqId text between
        # search and resultspercontig (strtod -> float -> fastSeqIdToBuffer),
        # which is lossy for values like 0.511 -> 0.510; replicate
        sid = format_seq_id(h["seq_id"])
        for _ in range(seqid_rounds):
            sid = format_seq_id(np.float32(float(sid)))
        return PotentialExon(
            exon_key=int(h["orf_idx"]), target_key=int(h["target_idx"]),
            strand=PLUS if plus[j] else MINUS, bit_score=int(h["bit_score"]),
            seq_id_text=sid, evalue_text=format_evalue(h["evalue"]),
            target_match_start=int(h["t_start"]),
            target_match_end=int(h["t_end"]), target_len=int(h["t_len"]),
            contig_start=int(cs[j]), contig_end=int(ce[j]),
            nucleotide_len=int(nl[j]),
            contig_start_before_trim=int(fb[j]),
            contig_end_before_trim=int(tb[j]))

    def dp_round(gidx, used):
        """One find_optimal_set round (collectoptimalset.cpp:108-222) on
        global hit indices gidx; marks used in-place. Returns
        (score, [global exon indices] low-to-high contig order)."""
        act = gidx[~used]
        if len(act) == 0:
            return 0, None
        # stable (contigStart, contigEnd) order with original-position
        # tie-break — the reference's repeated stable sorts reduce to this
        srt = np.lexsort((act, ce[act], cs[act]))
        act = act[srt]
        tlen = int(hits[act[0]]["t_len"])
        nat = native.chain_dp(cs[act], ce[act], tstart[act], tend[act],
                              bit[act], aa[act], tlen, p)
        if nat is None:
            nat = _chain_dp_py(cs[act], ce[act], tstart[act], tend[act],
                               bit[act], aa[act], tlen, p)
        prev_id, _ps, best_last, best_score = nat
        if best_score == 0:
            return 0, None
        path = []
        curr = best_last
        while prev_id[curr] != curr:
            path.append(curr)
            curr = int(prev_id[curr])
        path.append(curr)
        path.reverse()
        chosen = act[path]
        used[np.searchsorted(gidx, chosen)] = True
        return int(best_score), chosen

    if p.max_exon_sets == 1:
        # default regime: ONE optimal set per (contig,target,strand) —
        # the whole DP batches into a single native OpenMP call
        # (sort + chain + traceback per group, chain_dp_groups)
        out = _chain_groups_batched(hits, idx_all, kc, kt, plus, cs, ce,
                                    tstart, tend, bit, aa, log2_m,
                                    mk_exon, p)
        if out is not None:
            return out

    prog = log.progress(len(starts), "chain DP groups", step=256)
    for gi in range(len(starts)):
        prog.update()
        gsl = idx_all[starts[gi]:ends[gi]]
        ci = int(kc[starts[gi]])
        tk = int(kt[starts[gi]])
        gplus = gsl[plus[gsl]]
        gminus = gsl[~plus[gsl]]
        used_p = np.zeros(len(gplus), bool)
        used_m = np.zeros(len(gminus), bool)
        out = preds_per_contig.setdefault(ci, [])
        iters = 0
        # the reference's while-condition sees the lists as pruned by the
        # PREVIOUS round's find_optimal_set (used entries are removed
        # lazily at the start of the next call, collectoptimalset.cpp:
        # 121-130), so the check for round k+1 counts entries unused
        # before round k
        check_p, check_m = len(gplus), len(gminus)
        while iters < p.max_exon_sets and (check_p or check_m):
            check_p = int((~used_p).sum())
            check_m = int((~used_m).sum())
            for strand, gidx, used in ((PLUS, gplus, used_p),
                                       (MINUS, gminus, used_m)):
                score, chosen = dp_round(gidx, used)
                if chosen is None:
                    continue
                log2_e = log2_m + 1.0 - score
                evalue = math.pow(2.0, log2_e)
                if evalue <= p.metaeuk_evalue_thr:
                    text = "%.3E" % evalue
                    out.append(Prediction(
                        target_key=tk, strand=strand, total_bitscore=score,
                        combined_evalue=float(text),
                        combined_evalue_text=text,
                        exons=[mk_exon(int(j)) for j in chosen]))
            iters += 1
    prog.finish()

    return {ci: ps for ci, ps in preds_per_contig.items() if ps}


def _pipelined_extract_search(p, extractor, contigs, lo, hi, pref_fut,
                              mk_driver, n_batches):
    """Three-stage pipeline over contig ranges: fragment extraction +
    translation (worker A) → host k-mer prefilter matching (worker B) →
    device alignment (caller thread).  The reference runs extractorfs,
    translatenucs, prefilter and align strictly serially as separate
    processes (data/predictexons.sh:40-88); here batch k+1 extracts
    while batch k prefilters on the remaining host cores and batch k-1
    aligns on the device.  Per-fragment results are independent and
    batches are fragment-contiguous, so the concatenated hit table equals
    the single-pass one byte-for-byte (enforced by the forced-batches
    parity test). Copied from predict.py:315, without the prewarm.

    Returns (orf_locs, orf_aa, orf_contig, hits)."""
    import time as _time
    from concurrent.futures import ThreadPoolExecutor
    from ..search.prefilter_kmer import KmerPrefilter, log_prefilter_stats

    # contig-range bounds by residues (fragment yield tracks residue
    # count, and ranges must be contig-contiguous so fragment indices
    # stay in contig order).  Batch sizes grow geometrically (1:2:4:...)
    # instead of evenly: extraction of batch 0 is the serial ramp before
    # the first prefilter batch can start, so the first batch is kept
    # small (1/(2^n-1) of the residues) and later batches extract while
    # earlier ones prefilter underneath
    lens = np.asarray(contigs.lengths[lo:hi], np.float64)
    cum = np.concatenate([[0.0], np.cumsum(lens)])
    gw = np.cumsum([0.0] + [2.0 ** k for k in range(n_batches)])
    gw /= gw[-1]
    bounds = [lo + int(np.searchsorted(cum, cum[-1] * gw[k]))
              for k in range(n_batches + 1)]
    bounds[0], bounds[-1] = lo, hi
    for i in range(1, n_batches + 1):
        bounds[i] = max(bounds[i], bounds[i - 1])

    prog = log.progress(hi - lo, "extract+translate contigs")
    busy = {"extract": 0.0, "prefilter": 0.0}

    def extract_range(a, b):
        t0 = _time.perf_counter()
        locs, aas, cids = [], [], []
        for ci in range(a, b):
            l, frags = extractor.extract_contig(contigs.seq_bytes(ci), ci)
            aa = extractor.translate_fragments(frags)
            if p.reverse_fragments:
                aa = [x[::-1] for x in aa]
            locs.extend(l)
            aas.extend(aa)
            cids.extend([ci] * len(l))
            prog.update()
        busy["extract"] += _time.perf_counter() - t0
        return locs, aas, cids

    stats = np.zeros(5, np.int64)
    base_ctr = [0]

    def match_range(k, ex_futs):
        pref = pref_fut.result()
        if not isinstance(getattr(pref, "pf", None), KmerPrefilter):
            # split/distributed engines process the whole query set in
            # one call (per-batch calls would re-stream every split
            # index per batch); batch 0 carries everything
            if k > 0:
                return np.zeros((0, 2), np.int64)
            aas = []
            for f in ex_futs:
                aas.extend(f.result()[1])
            t0 = _time.perf_counter()
            pairs = pref.candidate_pairs(aas, 0, True)
            stats[:] += getattr(pref.pf, "stats", np.zeros(5, np.int64))
            busy["prefilter"] += _time.perf_counter() - t0
            return pairs
        aas = ex_futs[k].result()[1]
        t0 = _time.perf_counter()
        base = base_ctr[0]
        base_ctr[0] += len(aas)
        pairs = pref.candidate_pairs(aas, base, True)
        stats[:] += getattr(pref.pf, "stats", np.zeros(5, np.int64))
        busy["prefilter"] += _time.perf_counter() - t0
        return pairs

    orf_locs, orf_aa, orf_contig = [], [], []
    with ThreadPoolExecutor(1) as ex_pool, ThreadPoolExecutor(1) as pf_pool:
        ex_futs = [ex_pool.submit(extract_range, bounds[k], bounds[k + 1])
                   for k in range(n_batches)]
        pf_futs = [pf_pool.submit(match_range, k, ex_futs)
                   for k in range(n_batches)]
        # device alignment needs the full fragment set staged (shapes
        # are a function of the dataset's length histogram alone), so
        # collect extraction results first; prefilter matching of the
        # early batches is already running underneath
        for f in ex_futs:
            l, a, c = f.result()
            orf_locs.extend(l)
            orf_aa.extend(a)
            orf_contig.extend(c)
        prog.finish()
        log.info(f"fragments: {len(orf_aa)} "
                 f"(extract busy {busy['extract']:.2f}s)")
        driver = mk_driver()
        parts = []
        all_qi = []
        for k in range(n_batches):
            pairs_k = pf_futs[k].result()
            all_qi.append(pairs_k[:, 0] if len(pairs_k)
                          else np.zeros(0, np.int64))
            parts.append(driver.search(orf_aa, pair_generator=pairs_k))
    n = len(orf_aa)
    counts = np.bincount(np.concatenate(all_qi).astype(np.int64),
                         minlength=n) if n else np.zeros(0, np.int64)
    log_prefilter_stats(stats, counts)
    log.info(f"prefilter pairs kept: {int(counts.sum())} "
             f"({n_batches} pipelined batches; prefilter busy "
             f"{busy['prefilter']:.2f}s)")
    hits = np.concatenate(parts) if parts else np.zeros(0, HIT_DTYPE)
    return orf_locs, orf_aa, orf_contig, hits


class EasyPredict:
    """Runs the full pipeline and writes the four output files; the
    alignment runs on `device` (a CUDA device, or "cpu" for the kernels'
    plain versions), its launches fanned over `devices` (default:
    search/driver.py device_list)."""

    def __init__(self, params=None, device="cuda", devices=None):
        self.params = params or Params()
        self.device = device
        self.devices = devices

    def run(self, contigs_path, targets_path, out_prefix, tmp_dir=None,
            contig_range=None):
        """Full easy-predict. With tmp_dir set, the DP-predictions stage
        artifact is checkpointed and reused on re-runs (the reference's
        notExists-guarded resumability, data/predictexons.sh:40-88).

        contig_range=(lo, hi) processes only that contiguous contig block
        (the multi-process data-parallel partition: per-contig results are
        independent, so partition outputs concatenate byte-identically to
        a single run -- parallel/multihost.py + mergepredictions)."""
        p = self.params
        timer = log.StageTimer()
        with timer.stage("load contigs+targets"):
            contigs = load_sequence_input(contigs_path, DBTYPE_NUCL)
            targets = load_target_input(targets_path)
        # checkpoint names are qualified by the contig partition so
        # multi-process runs sharing one tmp_dir (multihost.py forwards
        # the same tmp_dir to every rank) never clobber or cross-load
        # each other's stage artifacts
        _part = (f"_{contig_range[0]}_{contig_range[1]}"
                 if contig_range else "")
        dp_ckpt = os.path.join(tmp_dir, f"dp_predictions{_part}") \
            if tmp_dir else None
        if dp_ckpt and os.path.exists(f"{dp_ckpt}.dbtype"):
            with timer.stage("resume dp_predictions"):
                from ..cli import _parse_dp_payload
                preds_per_contig = {
                    key: _parse_dp_payload(payload)
                    for key, payload in mmseqsdb.read_db(dp_ckpt) if payload}
                log.info(f"resumed {dp_ckpt}")
        else:
            with timer.stage("predictexons"):
                preds_per_contig = self.predict_exons(contigs, targets,
                                                      contig_range,
                                                      tmp_dir=tmp_dir)
            if dp_ckpt:
                os.makedirs(tmp_dir, exist_ok=True)
                from .dpformat import predictions_payload
                mmseqsdb.write_db(
                    dp_ckpt, ((ci, predictions_payload(preds_per_contig.get(ci, [])))
                              for ci in range(len(contigs))))
        writer = PredictionWriter(out_prefix, p)
        target_accs = [targets.accession(i) for i in range(len(targets))]
        # emulate the reference's DB memory layout (seq + '\n' + '\0' per
        # entry, entries adjacent): --len-scan-for-start can read past the
        # contig end (unitesetstofasta.cpp:83 with the dead clamp at :74),
        # and byte parity requires reading the same adjacent bytes
        chunks = []
        starts = []
        pos = 0
        for ci in range(len(contigs)):
            starts.append(pos)
            s = contigs.seq_bytes(ci)
            chunks.append(s + b"\n\x00")
            pos += len(s) + 2
        db_buffer = np.frombuffer(b"".join(chunks), dtype=np.uint8)
        log.MemoryTracker.track("contig db buffer", db_buffer.nbytes)
        n_written = 0
        lo, hi = contig_range if contig_range else (0, len(contigs))
        with timer.stage("reduceredundancy+write"):
            prog = log.progress(hi - lo, "write contigs", step=64)
            for ci in range(lo, hi):
                prog.update()
                preds = preds_per_contig.get(ci, [])
                if not preds:
                    continue
                reps, _rows = reduce_redundancy(preds, p.overlap_allowed)
                n_written += len(reps)
                contig_len = int(contigs.lengths[ci])
                contig = db_buffer[starts[ci]:]
                contig_acc = contigs.accession(ci)
                self._write_contig(writer, reps, ci, contig_acc, target_accs,
                                   contig, contig_len, p)
            prog.finish()
        writer.close()
        log.info(f"contigs: {len(contigs)}  targets: {len(targets)}  "
                 f"predictions written: {n_written}")
        log.MemoryTracker.report()
        self.stage_seconds = timer.report()
        return out_prefix

    def predict_exons(self, contigs, targets, contig_range=None,
                      tmp_dir=None):
        """contig_idx -> list[Prediction] (collectoptimalset emission order).

        With tmp_dir set, the prefilter candidate pairs and the
        post-align hit table are checkpointed (the reference's
        notExists-guarded stage DBs, data/predictexons.sh:40-88), so a
        large interrupted run resumes at the failed stage."""
        p = self.params
        lo, hi = contig_range if contig_range else (0, len(contigs))
        timer = log.StageTimer()
        extractor = OrfExtractor(p)
        is_profile = isinstance(targets, ProfileDB)
        # partition-qualified checkpoint names (see run()): ranks sharing
        # a tmp_dir each get their own stage artifacts
        _part = (f"_{contig_range[0]}_{contig_range[1]}"
                 if contig_range else "")
        _resumable = tmp_dir and any(
            os.path.exists(os.path.join(tmp_dir, f))
            for f in (f"search_hits{_part}.npy", f"pref_pairs{_part}.npy"))
        # overlap the k-mer index build (target masking + native fill)
        # with fragment extraction+translation — the two stages share no
        # data and the reference runs them serially as processes.  The
        # built index is a pure function of (target content, params) and
        # is session-cached: a resident process serving repeated queries
        # against one target DB builds it once (the reference's
        # createindex role, CreateIndex.cpp:14).
        pref_fut = None
        if (p.prefilter_mode == "kmer" and not _resumable
                and not is_profile):
            from concurrent.futures import ThreadPoolExecutor
            from ..search.prefilter_kmer import ReferenceKmerPrefilter
            pref_key = (session.db_fingerprint(targets), repr(p),
                        p.min_diag_score,
                        os.environ.get("METAEUK_DIST_TMP"))
            _pref_ex = ThreadPoolExecutor(max_workers=1)
            pref_fut = _pref_ex.submit(
                session.cached, "kmer_pref", pref_key,
                lambda: ReferenceKmerPrefilter(p, targets,
                                               p.min_diag_score))
            _pref_ex.shutdown(wait=False)

        def mk_driver():
            # driver staging (per-tier device-resident target matrices)
            # is likewise target-side state kept across runs; the key is
            # the port's own, apart from the JAX package's "driver", and
            # names the device list the launches fan over
            devs = device_list(self.device, self.devices)
            return session.cached(
                "driver_torch",
                (session.db_fingerprint(targets), repr(p),
                 tuple(str(d) for d in devs)),
                lambda: SearchDriver(p, targets, self.device, devices=devs))

        # fused-pipeline decision happens BEFORE extraction (fragment
        # count estimated from residues) so extraction itself can join
        # the overlap
        est_frags = int(np.asarray(contigs.lengths[lo:hi]).sum()) // 25
        n_b = int(os.environ.get("METAEUK_PIPELINE_BATCHES", "0"))
        if n_b == 0:
            n_b = 4 if est_frags >= 50_000 else 1
        n_b = max(1, min(n_b, hi - lo))
        hits_ckpt = os.path.join(tmp_dir, f"search_hits{_part}.npy") \
            if tmp_dir else None

        if pref_fut is not None and n_b > 1:
            with timer.stage("extract+prefilter+align (pipelined)"):
                orf_locs, orf_aa, orf_contig, hits = \
                    _pipelined_extract_search(p, extractor, contigs, lo,
                                              hi, pref_fut, mk_driver,
                                              n_b)
            if hits_ckpt and not os.path.exists(hits_ckpt):
                os.makedirs(tmp_dir, exist_ok=True)
                np.save(hits_ckpt, hits)
        else:
            # --- extractorfs + translatenucs (serial path) ---
            timer_ctx = timer.stage("extractorfs+translate")
            timer_ctx.__enter__()
            orf_locs = []          # global fragment records, key = index
            orf_aa = []
            orf_contig = []
            prog = log.progress(hi - lo, "extract+translate contigs")
            for ci in range(lo, hi):
                locs, frags = extractor.extract_contig(
                    contigs.seq_bytes(ci), ci)
                orf_locs.extend(locs)
                orf_aa.extend(extractor.translate_fragments(frags))
                orf_contig.extend([ci] * len(locs))
                prog.update()
            prog.finish()
            if p.reverse_fragments:
                orf_aa = [aa[::-1] for aa in orf_aa]
            timer_ctx.__exit__(None, None, None)
            log.info(f"fragments: {len(orf_aa)}")

            # --- search (prefilter + batched SW on device) ---
            if is_profile:
                # --exhaustive-search inverted profile mode
                from ..search.profile_search import ProfileSearchDriver
                with timer.stage("profile search"):
                    hits = ProfileSearchDriver(p, targets,
                                               self.device).search(orf_aa)
            elif hits_ckpt and os.path.exists(hits_ckpt):
                with timer.stage("resume search_hits"):
                    hits = np.load(hits_ckpt)
                    log.info(f"resumed {hits_ckpt} ({len(hits)} hits)")
            elif p.prefilter_mode in ("ungapped", "kmer"):
                driver = mk_driver()
                pairs_ckpt = os.path.join(tmp_dir,
                                          f"pref_pairs{_part}.npy") \
                    if tmp_dir else None
                pairs = None
                if pairs_ckpt and os.path.exists(pairs_ckpt):
                    pairs = np.load(pairs_ckpt)
                    log.info(f"resumed {pairs_ckpt} ({len(pairs)} pairs)")
                else:
                    if p.prefilter_mode == "ungapped":
                        # gapless scores of every fragment x target pair
                        # on the device (MetaEuk's GPU mode)
                        from ..search.prefilter import UngappedPrefilter
                        pref = UngappedPrefilter(p, targets,
                                                 p.min_diag_score,
                                                 device=self.device)
                    else:
                        # "kmer": the reference-default sensitivity-
                        # calibrated prefilter (byte-parity candidates)
                        from ..search.prefilter_kmer import \
                            ReferenceKmerPrefilter
                        pref = pref_fut.result() if pref_fut is not None \
                            else ReferenceKmerPrefilter(p, targets,
                                                        p.min_diag_score)
                    with timer.stage(f"{p.prefilter_mode} prefilter"):
                        pairs = pref.candidate_pairs(orf_aa)
                    if pairs_ckpt:
                        os.makedirs(tmp_dir, exist_ok=True)
                        np.save(pairs_ckpt, pairs)
                if pairs is not None:
                    log.info(f"prefilter pairs kept: {len(pairs)}")
                    with timer.stage("align"):
                        hits = driver.search(orf_aa, pair_generator=pairs)
            else:
                driver = mk_driver()
                with timer.stage("align (exhaustive)"):
                    hits = driver.search(orf_aa)
            if hits_ckpt and not os.path.exists(hits_ckpt):
                os.makedirs(tmp_dir, exist_ok=True)
                np.save(hits_ckpt, hits)
        tot_aas = targets.total_residues()
        # profile results pass through one extra text round trip
        # (swapresults re-serializes before resultspercontig)
        seqid_rounds = 2 if is_profile else 1

        # --- resultspercontig + collectoptimalset ---
        orf_contig = np.asarray(orf_contig, dtype=np.int64)
        preds_per_contig = {}
        if len(hits) == 0:
            return preds_per_contig
        hit_contig = orf_contig[hits["orf_idx"]]
        order = np.lexsort((hits["orf_idx"], hits["target_idx"], hit_contig))
        hits = hits[order]
        hit_contig = hit_contig[order]
        timer_chain = timer.stage("collectoptimalset"); timer_chain.__enter__()
        preds_per_contig = assemble_and_chain(
            hits, hit_contig, orf_locs, tot_aas, seqid_rounds, p)
        timer_chain.__exit__(None, None, None)
        self.predict_stage_seconds = dict(timer.stages)
        return preds_per_contig

    def _write_contig(self, writer, reps, contig_key, contig_acc, target_accs,
                      contig, contig_len, p):
        """Streaming (targetKey, lowCoord)-grouped emission, plus before
        minus per group (unitesetstofasta.cpp:449-567); copied from
        predict.py:694."""
        i = 0
        while i < len(reps):
            j = i
            group_key = (reps[i].target_key, reps[i].low_contig_coord)
            while j < len(reps) and \
                    (reps[j].target_key, reps[j].low_contig_coord) == group_key:
                j += 1
            group = reps[i:j]
            t_acc = (str(group_key[0]) if p.write_target_key
                     else target_accs[group_key[0]])
            for pred in [g for g in group if g.strand == PLUS] + \
                        [g for g in group if g.strand != PLUS]:
                writer.write_prediction(pred, contig_key, contig_acc, t_acc,
                                        contig, contig_len)
            i = j
