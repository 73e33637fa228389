# Copy of metaeuk_tpu/pipeline/result2profile.py; it differs from its original only in this note.
"""result2profile: alignment-result DB -> HMM-profile DB.

Port of lib/mmseqs/src/util/result2profile.cpp (result2profile path,
returnAlnRes=false) for the default configuration with --filter-msa 0:
  - hits with evalue < evalProfile (default = evalThr) enter the MSA;
    the query itself is skipped when query and target DB are the same
    (result2profile.cpp:198-208)
  - MultipleAlignment::computeMSA(center, seqSet, alns, noDeletionMSA=true)
    (MultipleAlignment.cpp:179-220): the first MSA row is the plain query,
    member rows live in query coordinates -- leading gaps up to qStart,
    'M' emits the target residue, 'I' a gap, 'D' skips the target residue
    (MultipleAlignment.cpp:95-180 with noDeletionMSA)
  - PSSMCalculator::computePSSMFromMSA (wg=0, scoreBias 0.0)
  - SubstitutionMatrix::calcGlobalAaBiasCorrection when --comp-bias-corr 1
  - Masker::maskPssm when --mask-profile 1 (Masker.cpp:57-86): tantan over
    the query sequence; masked positions get all 20 scores set to -1
  - PSSMCalculator::Profile::toBuffer keyed by queryKey

--filter-msa 1 (the reference default) applies the MsaFilter diversity
filter (ops/msafilter.py) to the MSA before the PSSM computation.
"""

import numpy as np

from ..io import mmseqsdb
from ..ops.pssm import GAP, compute_pssm_from_msa, global_aa_bias_correction, \
    profile_to_buffer
from ..ops.masker import repeat_probs


def expand_backtrace(cigar):
    """'5M2I3M' -> 'MMMMMIIMMM' (Matcher::result_t compressed backtrace)."""
    out = []
    n = 0
    for ch in cigar:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            out.append(ch * max(n, 1))
            n = 0
    return "".join(out)


def parse_aln_record(line):
    """Matcher::parseAlignmentRecord essentials: (key, evalue_text, qStart,
    dbStart, backtrace-or-None)."""
    cols = line.split("\t")
    key = int(cols[0])
    bt = cols[10].strip() if len(cols) > 10 else None
    return key, cols[3], int(cols[4]), int(cols[7]), bt


def msa_row_from_backtrace(center_len, t_enc, q_start, t_start, cigar):
    """One member MSA row in query coordinates (noDeletionMSA=true,
    MultipleAlignment.cpp:95-180)."""
    row = np.full(center_len, GAP, np.uint8)
    qpos, tpos = q_start, t_start
    for op in expand_backtrace(cigar):
        if op == "M":
            row[qpos] = t_enc[tpos]
            qpos += 1
            tpos += 1
        elif op == "I":
            qpos += 1
        else:  # 'D' consumes target only; dropped in noDeletionMSA mode
            tpos += 1
    return row


def profile_from_alignments(center_enc, members, comp_bias_correction=True,
                            mask_profile=True, mask_prob=0.9,
                            filter_msa=False, cov_msa_thr=0.0, qid=(0,),
                            qsc=-20.0, filter_max_seq_id=0.9, ndiff=1000,
                            filter_min_enable=0, pcmode=0, context_lib=None,
                            wg=False):
    """center_enc: query in internal codes; members: [(t_enc, qStart, tStart,
    cigar)] already e-value filtered. Returns the 25-byte/position payload."""
    L = len(center_enc)
    msa = np.empty((1 + len(members), L), np.uint8)
    msa[0] = center_enc
    for i, (t_enc, qs, ts, cigar) in enumerate(members):
        msa[1 + i] = msa_row_from_backtrace(L, t_enc, qs, ts, cigar)
    if filter_msa:
        from ..ops.msafilter import msa_filter
        _, order, _ = msa_filter(
            msa, coverage=int(cov_msa_thr * 100), qid_vec=qid, qsc=qsc,
            max_seqid=int(filter_max_seq_id * 100), ndiff=ndiff,
            filter_min_enable=filter_min_enable)
        msa = np.ascontiguousarray(msa[order])
    res = compute_pssm_from_msa(msa, wg_mode=wg, pcmode=pcmode,
                                context_lib=context_lib)
    pssm = res["pssm"]
    if comp_bias_correction:
        pssm = global_aa_bias_correction(pssm)
    if mask_profile:
        masked = repeat_probs(np.asarray(center_enc, np.uint8)) \
            >= np.float32(mask_prob)
        pssm = pssm.copy()
        pssm[masked] = -1
    return profile_to_buffer(pssm, np.asarray(center_enc, np.uint8),
                             res["consensus"], res["neff"])


def result2profile_db(query_db, target_db, aln_db, out_db, eval_profile=1e-3,
                      filter_msa=0, comp_bias_correction=True,
                      mask_profile=True, mask_prob=0.9, cov_msa_thr=0.0,
                      qid="0.0", qsc=-20.0, filter_max_seq_id=0.9,
                      ndiff=1000, filter_min_enable=0, pcmode=0,
                      context_lib=None, wg=False):
    """File-level driver: mmseqs-format seq DBs + alignment DB (with
    backtraces) -> profile DB. sameDatabase = identical paths. A profile
    query DB is accepted too (iterative search steps >= 2): the center is
    then the profile's query-letter sequence (Sequence::mapProfile sets
    numSequence[l] = queryLetter, Sequence.cpp:252-254)."""
    from ..data.submat import AA2NUM

    if isinstance(context_lib, str):
        from ..ops.csprofile import ContextLibrary
        context_lib = ContextLibrary.from_file(context_lib)

    def enc(arr):
        return AA2NUM[np.asarray(arr, np.uint8)]

    same = (query_db == target_db)
    if mmseqsdb.read_dbtype(query_db) == mmseqsdb.DBTYPE_HMM_PROFILE:
        from ..io.profiledb import ProfileDB
        pq = ProfileDB.from_db(query_db)
        centers_by_key = {int(k): np.asarray(pq.query_seqs[i], np.uint8)
                          for i, k in enumerate(pq.keys)}
        tdb = mmseqsdb.read_seqdb(target_db)
    else:
        qdb = mmseqsdb.read_seqdb(query_db)
        tdb = qdb if same else mmseqsdb.read_seqdb(target_db)
        centers_by_key = {int(k): enc(qdb.seq(i))
                          for i, k in enumerate(qdb.keys)}

    t_prof = None
    if mmseqsdb.read_dbtype(target_db) == mmseqsdb.DBTYPE_HMM_PROFILE:
        # profile TARGET (enrich workflow): MSA rows use the profiles'
        # stored query residues (Sequence::mapProfile numSequence)
        from ..io.profiledb import ProfileDB
        t_prof = ProfileDB.from_db(target_db)
        tdb = None
        t_by_key = {int(k): i for i, k in enumerate(t_prof.keys)}
    else:
        t_by_key = {int(k): i for i, k in enumerate(tdb.keys)}
    aln_entries = mmseqsdb.read_db(aln_db)
    out = []
    for qkey, payload in aln_entries:
        center = centers_by_key[qkey]
        members = []
        for line in payload.decode().splitlines():
            if not line:
                continue
            key, eval_text, qs, ts, bt = parse_aln_record(line)
            if key == qkey and same:
                continue
            if float(eval_text) < eval_profile:
                if bt is None:
                    raise NotImplementedError(
                        "alignment DB without backtraces (rerun search "
                        "with -a / alignment mode 3)")
                if t_prof is not None:
                    t_enc = np.asarray(t_prof.query_seqs[t_by_key[key]],
                                       np.uint8)
                else:
                    t_enc = enc(tdb.seq(t_by_key[key]))
                members.append((t_enc, qs, ts, bt))
        # reference: qid_vec = sorted((int)(strtod(s)*100)) (result2profile
        # .cpp:36-43)
        qid_vec = sorted(int(float(s) * 100) for s in str(qid).split(","))
        out.append((qkey, profile_from_alignments(
            center, members, comp_bias_correction, mask_profile, mask_prob,
            filter_msa=bool(filter_msa), cov_msa_thr=cov_msa_thr,
            qid=qid_vec, qsc=qsc, filter_max_seq_id=filter_max_seq_id,
            ndiff=ndiff, filter_min_enable=filter_min_enable,
            pcmode=pcmode, context_lib=context_lib, wg=wg)))
    # pcmode 1 marks the DB with the context-pseudo-counts extended
    # dbtype bit (result2profile.cpp:115-118)
    dbtype = mmseqsdb.DBTYPE_HMM_PROFILE
    if pcmode == 1:
        dbtype |= (4 & 0x7FFE) << 16
    mmseqsdb.write_db(out_db, out, dbtype)
    # header DB: reuse the query headers for the profile entries
    import pathlib
    qh = pathlib.Path(f"{query_db}_h")
    if qh.exists():
        h_map = dict(mmseqsdb.read_db(f"{query_db}_h"))
        mmseqsdb.write_db(f"{out_db}_h", [(k, h_map[k]) for k, _ in out],
                          mmseqsdb.DBTYPE_GENERIC)
    return out_db


def filterresult_db(query_db, target_db, aln_db, out_db,
                    include_identity=False, cov_msa_thr=0.0, qid="0.0",
                    qsc=-20.0, filter_max_seq_id=0.9, ndiff=1000,
                    filter_min_enable=0, compressed=False):
    """filterresult (result2profile.cpp:17 with returnAlnRes=true,
    195-253): per query, build the member MSA, run MsaFilter, and emit
    the surviving members' alignment lines (with backtrace) in filter
    order; isFiltering is always on, no e-value gate."""
    from ..data.submat import AA2NUM
    from ..ops.msafilter import msa_filter
    from .dbtools2 import aln_record_to_line
    from .dbtools2 import parse_aln_record as parse_full

    def enc(arr):
        return AA2NUM[np.asarray(arr, np.uint8)]

    same = (query_db == target_db)
    qdb = mmseqsdb.read_seqdb(query_db)
    tdb = qdb if same else mmseqsdb.read_seqdb(target_db)
    centers_by_key = {int(k): enc(qdb.seq(i)) for i, k in enumerate(qdb.keys)}
    t_by_key = {int(k): i for i, k in enumerate(tdb.keys)}
    qid_vec = sorted(int(float(s) * 100) for s in str(qid).split(","))

    out = []
    for qkey, payload in mmseqsdb.read_db(aln_db):
        center = centers_by_key[qkey]
        id_lines = []
        members = []
        recs = []
        for line in payload.decode().splitlines():
            if not line:
                continue
            r = parse_full(line)
            if r["dbKey"] == qkey and same:
                if include_identity:
                    id_lines.append(aln_record_to_line(r, True))
                continue
            members.append(
                msa_row_from_backtrace(len(center),
                                       enc(tdb.seq(t_by_key[r["dbKey"]])),
                                       r["qStart"], r["dbStart"],
                                       r["backtrace"]))
            recs.append(r)
        msa = np.empty((1 + len(members), len(center)), np.uint8)
        msa[0] = center
        for i, row in enumerate(members):
            msa[1 + i] = row
        _, order, filtered_size = msa_filter(
            msa, coverage=int(cov_msa_thr * 100), qid_vec=qid_vec, qsc=qsc,
            max_seqid=int(filter_max_seq_id * 100), ndiff=ndiff,
            filter_min_enable=filter_min_enable)
        kept = [o - 1 for o in order[1:filtered_size]]
        lines = id_lines + [aln_record_to_line(recs[i], True) for i in kept]
        out.append((qkey, "".join(lines).encode()))
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_ALIGNMENT_RES,
                      compressed=compressed)
    return out_db
