# Copy of metaeuk_tpu/pipeline/msa2profile.py; it differs from its original only in this note.
"""msa2profile: MSA DB / FASTA MSAs -> HMM-profile DB.

Port of lib/mmseqs/src/util/msa2profile.cpp (--match-mode 0/1,
--match-ratio 0.5, --pc-mode 0, --wg 0, --comp-bias-corr 1).
--filter-msa 1 (the reference default) applies the MsaFilter diversity
filter to the compressed MSA before the PSSM computation
(msa2profile.cpp:402-408).
"""

import numpy as np

from ..data.submat import AA2NUM
from ..io import mmseqsdb
from ..ops.pssm import (GAP, ENDGAP, compute_pssm_from_msa,
                        compute_sequence_weights, global_aa_bias_correction,
                        profile_to_buffer)


def _parse_msa_fasta(text):
    """[(name, aligned_seq_str)] from one MSA FASTA blob."""
    out = []
    name, parts = None, []
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        if line.startswith(">"):
            if name is not None:
                out.append((name, "".join(parts)))
            name = line[1:]
            parts = []
        elif name is not None:
            parts.append(line.strip())
    if name is not None:
        out.append((name, "".join(parts)))
    return out


def _a3m_matrix(entries, match_mode):
    """A3M (msa_type 1) row building with the reference's exact flat
    msaContent layout (msa2profile.cpp:275-320): per member, iterate the
    first centerLengthWithGaps RAW characters, skip lowercase (a3m
    insert states), append '-'->GAP else the residue code, then pad the
    row to a 16-byte boundary (VECSIZE_INT*4 of the SSE4.1 parity
    build).  Rows whose lowercase skips shrink them below the window
    are later READ and WRITTEN through their padding into the next
    row's head by the reference's mask/compress loops — replicated here
    by returning views over one flat buffer (K, L_gaps) strided by the
    true row starts.  A 16-aligned GAP tail bounds the last row (the
    reference reads heap bytes there; see PARITY_DEVIATIONS.md)."""
    L_gaps = len(entries[0][1])
    starts = []
    buf = bytearray()
    masked_first = None
    if match_mode == 0:
        first = entries[0][1][:L_gaps]
        masked_first = np.array([c == "-" for c in first], bool)
    for _, seq in entries:
        starts.append(len(buf))
        raw = seq[:L_gaps]
        for i, ch in enumerate(raw):
            if match_mode == 0 and masked_first[i]:
                continue
            if ch.islower():
                continue
            buf.append(GAP if ch == "-" else int(AA2NUM[ord(ch)]))
        while len(buf) % 16:
            buf.append(GAP)
    buf.extend([GAP] * L_gaps)
    flat = np.frombuffer(bytearray(buf), np.uint8).copy()
    rows = [flat[s:s + L_gaps] for s in starts]
    return rows, flat, L_gaps, masked_first


def msa_to_profile(entries, match_mode=1, match_ratio=0.5,
                   comp_bias_correction=True, filter_msa=False,
                   cov_msa_thr=0.0, qid=(0,), qsc=-20.0,
                   filter_max_seq_id=0.9, ndiff=1000, filter_min_enable=0,
                   pcmode=0, context_lib=None, msa_type=2,
                   skip_query=False):
    """One MSA -> (profile_payload_bytes, header_str).

    entries: [(name, aligned_seq)] — first sequence is the query.
    msa_type 1 = A3M (lowercase insert states skipped, ss_ entries
    dropped — the PDB70 chain, databases.sh:323-325); skip_query drops
    the first record before anything else (the CDD chain,
    msa2profile.cpp:229).
    """
    if skip_query:
        entries = entries[1:]
    if msa_type in (0, 1):
        entries = [(n, s) for n, s in entries
                   if not n.split()[0].startswith("ss_")] if entries else []
    if not entries:
        raise ValueError("empty MSA")
    if msa_type == 1:
        msa_m = _a3m_compress(entries, match_mode, match_ratio)
        return _profile_tail(msa_m, comp_bias_correction, filter_msa,
                             cov_msa_thr, qid, qsc, filter_max_seq_id,
                             ndiff, filter_min_enable, pcmode,
                             context_lib, entries[0][0])
    L_gaps = len(entries[0][1])
    K = len(entries)
    msa = np.zeros((K, L_gaps), np.uint8)
    for k, (_, seq) in enumerate(entries):
        if len(seq) != L_gaps:
            raise ValueError("ragged MSA")
        arr = np.frombuffer(seq.encode(), np.uint8)
        enc = AA2NUM[arr]
        enc = np.where(arr == ord("-"), np.uint8(GAP), enc)
        msa[k] = enc

    if match_mode == 0:
        # maskByFirst: columns where the query has a gap (msa2profile.cpp:175)
        masked = msa[0] == GAP
    else:
        # weighted gap fraction > match_ratio (msa2profile.cpp:334-365)
        w = compute_sequence_weights(msa)
        X = msa.copy()
        for k in range(K):
            i = 0
            while i < L_gaps and X[k, i] == GAP:
                X[k, i] = ENDGAP
                i += 1
            i = L_gaps - 1
            while i >= 0 and X[k, i] == GAP:
                X[k, i] = ENDGAP
                i -= 1
        masked = np.zeros(L_gaps, bool)
        for col in range(L_gaps):
            res = np.float32(0.0)
            gap = np.float32(0.0)
            for k in range(K):
                v = X[k, col]
                if v < GAP:
                    res = np.float32(res + w[k])
                elif v != ENDGAP:
                    gap = np.float32(gap + w[k])
            masked[col] = bool(gap / (res + gap) > np.float32(match_ratio)) \
                if (res + gap) != 0 else False
        # endgap columns revert to gaps in the compressed MSA
        msa = np.where(msa == ENDGAP, np.uint8(GAP), msa)

    kept = ~masked
    msa_m = np.ascontiguousarray(msa[:, kept])
    return _profile_tail(msa_m, comp_bias_correction, filter_msa,
                         cov_msa_thr, qid, qsc, filter_max_seq_id, ndiff,
                         filter_min_enable, pcmode, context_lib,
                         entries[0][0])


def _profile_tail(msa_m, comp_bias_correction, filter_msa, cov_msa_thr,
                  qid, qsc, filter_max_seq_id, ndiff, filter_min_enable,
                  pcmode, context_lib, header):
    """Shared filter -> PSSM -> payload back half (msa2profile.cpp:
    402-424) over the column-compressed MSA matrix."""
    if filter_msa:
        from ..ops.msafilter import msa_filter
        _, order, _ = msa_filter(
            msa_m, coverage=int(cov_msa_thr * 100), qid_vec=qid, qsc=qsc,
            max_seqid=int(filter_max_seq_id * 100), ndiff=ndiff,
            filter_min_enable=filter_min_enable)
        msa_m = np.ascontiguousarray(msa_m[order])
    res = compute_pssm_from_msa(msa_m, pcmode=pcmode,
                                context_lib=context_lib)
    pssm = res["pssm"]
    if comp_bias_correction:
        pssm = global_aa_bias_correction(pssm)
    payload = profile_to_buffer(pssm, msa_m[0], res["consensus"], res["neff"])
    return payload, header


def _a3m_compress(entries, match_mode, match_ratio):
    """A3M entries -> column-compressed (K, centerLength) MSA matrix,
    replicating the reference's in-place endgap/mask/compress loops
    over the flat msaContent buffer (msa2profile.cpp:334-378) —
    including the row-aliasing reads/writes through the 16-byte SIMD
    padding when lowercase skips shrink a row below the query window
    (see _a3m_matrix)."""
    rows, flat, L_gaps, masked_first = _a3m_matrix(entries, match_mode)
    K = len(rows)
    if match_mode == 0:
        center = L_gaps - int(masked_first.sum())
        return np.stack([np.asarray(r[:center]).copy() for r in rows])
    w = compute_sequence_weights(np.stack([np.asarray(r).copy()
                                           for r in rows]))
    for r in rows:
        i = 0
        while i < L_gaps and r[i] == GAP:
            r[i] = ENDGAP
            i += 1
        i = L_gaps - 1
        while i >= 0 and r[i] == GAP:
            r[i] = ENDGAP
            i -= 1
    masked = np.zeros(L_gaps, bool)
    for col in range(L_gaps):
        res = np.float32(0.0)
        gap = np.float32(0.0)
        for k in range(K):
            v = rows[k][col]
            if v < GAP:
                res = np.float32(res + w[k])
            elif v != ENDGAP:
                gap = np.float32(gap + w[k])
            else:
                rows[k][col] = GAP
        masked[col] = bool(gap / (res + gap) > np.float32(match_ratio)) \
            if (res + gap) != 0 else False
    for k in range(K):
        r = rows[k]
        cur = 0
        for l in range(L_gaps):
            if not masked[l]:
                r[cur] = r[l]
                cur += 1
        r[cur:L_gaps] = GAP
    center = L_gaps - int(masked.sum())
    return np.stack([np.asarray(r[:center]).copy() for r in rows])


def msa_db_to_profile_db(msa_entries, out_path, match_mode=1, match_ratio=0.5,
                         comp_bias_correction=True, filter_msa=False,
                         pcmode=0, context_lib=None, msa_type=2,
                         skip_query=False, **filter_kw):
    if isinstance(context_lib, str):
        from ..ops.csprofile import ContextLibrary
        context_lib = ContextLibrary.from_file(context_lib)
    """msa_entries: [(key, msa_text)] -> profile DB triple + _h."""
    payloads, headers = [], []
    for key, text in msa_entries:
        entries = _parse_msa_fasta(text)
        payload, header = msa_to_profile(entries, match_mode, match_ratio,
                                         comp_bias_correction,
                                         filter_msa=filter_msa,
                                         pcmode=pcmode,
                                         context_lib=context_lib,
                                         msa_type=msa_type,
                                         skip_query=skip_query,
                                         **filter_kw)
        payloads.append((key, payload))
        headers.append((key, (header + "\n").encode()))
    dbtype = mmseqsdb.DBTYPE_HMM_PROFILE
    if pcmode == 1:  # msa2profile.cpp:130-133
        dbtype |= (4 & 0x7FFE) << 16
    mmseqsdb.write_db(out_path, payloads, dbtype)
    mmseqsdb.write_db(f"{out_path}_h", headers, mmseqsdb.DBTYPE_GENERIC)
    return out_path
