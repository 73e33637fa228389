"""createlinindex / kmersearch / linsearch: linear-time search, byte-exact.

Port of the reference's linear search stack for amino-acid inputs:

  - kmerindexdb (lib/mmseqs/src/linclust/kmerindexdb.cpp): hash-selected
    k-mers of the target DB (same selection as kmermatcher, no
    whole-sequence hash entries), sorted by (kmer, seqLen desc, id,
    pos); pickCenterKmer (LinsearchIndexReader.cpp:21-62) keeps the
    FIRST entry per distinct k-mer (the longest sequence). k-mer length
    k = max(10, ln(targetResidues)/ln(8.7)), 13-letter reduced
    alphabet, 20 k-mers/sequence (setLinearFilterDefault +
    setKmerLengthAndAlphabet, kmermatcher.cpp:633-640, 1267-1295).
  - kmersearch (linclust/kmersearch.cpp): query k-mers (same selection,
    k from the index) merge-joined against the center entries — each
    query k-mer pairs with the single center entry of its k-mer value;
    the index pointer never advances on equality, so duplicate query
    k-mers hit the same center (searchInIndex:320-420). Result rows
    (default --result-direction 1 = target-centric): key = target id,
    hit = query id, diagonal = targetPos - queryPos (int16); sorted by
    (target, query, diag); per (target, query) group the written line
    is "query<TAB>sharedKmerCount<TAB>maxDiagonal" (writeResult:62-131,
    where the cnt>best update makes bestDiagonal the LAST diagonal of
    the sorted group).
  - linsearch workflow (data/workflow/linsearch.sh + workflow/
    Linsearch.cpp): kmersearch -> rescorediagonal (target-as-query,
    RESCORE_MODE_ALIGNMENT, covMode target, cov max(c,0.9)) ->
    filterdb --filter-file (drop queries already resolved ungapped) ->
    align (target-as-query, -e 100000, score+cov mode) -> swapresults
    (restores query-centric results, applies the user E-value).

The index is persisted as an .npz (kmer/id/pos/seqLen arrays + params)
— a TPU-framework-native artifact replacing the reference's packed
INDEX_DB; only the search OUTPUTS are interop surfaces.

Counterpart of metaeuk_tpu/search/linsearch_lin.py on the port's
SearchDriver: linsearch_workflow takes a `device` keyword (default cuda;
cpu runs the kernels' plain versions) for its align step; build_linindex
and kmersearch_db run on the host only, as there.
"""

import dataclasses
import math
import os

import numpy as np

from ..io import mmseqsdb
from .kmermatcher import _reduced, _select_kmers

LINIDX_SUFFIX = ".linidx.npz"


def _extract_entries(db, k, aa2red, alph, kmers_per_seq=21):
    """(kmer, key, pos, seqLen) rows for every hash-selected k-mer
    (fillKmerPositionArray with hashWholeSequence=false)."""
    rows = []
    for i in range(len(db)):
        key = int(db.keys[i])
        enc = aa2red[np.asarray(db.seq(i), np.uint8)]
        sel, _n = _select_kmers(enc, k, kmers_per_seq, alph)
        for kidx, pos in sel:
            rows.append((kidx, key, pos, len(enc)))
    return rows


def build_linindex(seq_db, out_path=None, kmer_size=None, alphabet=13,
                   kmers_per_seq=21):
    """createlinindex/kmerindexdb equivalent -> .linidx.npz next to the DB."""
    db = mmseqsdb.read_seqdb(seq_db)
    total_res = int(db.lengths.sum())
    k = kmer_size or max(10, int(math.log(float(total_res)) / math.log(8.7)))
    aa2red, _ = _reduced(alphabet)
    rows = _extract_entries(db, k, aa2red, alphabet, kmers_per_seq)
    # sort by (kmer, seqLen desc, id, pos); first per kmer = center
    rows.sort(key=lambda e: (e[0], -e[3], e[1], e[2]))
    kmers, ids, poss, lens = [], [], [], []
    prev = None
    for km, key, pos, slen in rows:
        if km != prev:
            kmers.append(km)
            ids.append(key)
            poss.append(pos)
            lens.append(slen)
            prev = km
    out = out_path or f"{seq_db}{LINIDX_SUFFIX}"
    np.savez(out, kmer=np.array(kmers, np.uint64),
             id=np.array(ids, np.uint32), pos=np.array(poss, np.int16),
             seq_len=np.array(lens, np.int32),
             params=np.array([k, alphabet, kmers_per_seq], np.int64))
    return out


def kmersearch_db(query_db, index_path, out_db, result_direction=1):
    """kmersearch: query DB x target lin-index -> prefilter result DB."""
    idx = np.load(index_path if os.path.exists(index_path)
                  else f"{index_path}{LINIDX_SUFFIX}")
    k, alph, kmers_per_seq = (int(x) for x in idx["params"])
    t_kmer = idx["kmer"].astype(np.uint64)
    t_id = idx["id"]
    t_pos = idx["pos"].astype(np.int64)

    qdb = mmseqsdb.read_seqdb(query_db)
    aa2red, _ = _reduced(alph)
    q_rows = _extract_entries(qdb, k, aa2red, alph, kmers_per_seq)
    q_rows.sort(key=lambda e: (e[0], -e[3], e[1], e[2]))

    # merge-join: one center entry per kmer; equality never advances the
    # index pointer, so every query occurrence pairs with the center
    q_kmers = np.array([r[0] for r in q_rows], np.uint64)
    hit_idx = np.searchsorted(t_kmer, q_kmers)
    in_range = hit_idx < len(t_kmer)
    matches = np.zeros(len(q_rows), bool)
    matches[in_range] = t_kmer[hit_idx[in_range]] == q_kmers[in_range]

    switched = result_direction == 1
    out_rows = []  # (group_id, hit_id, diag)
    for qi in np.flatnonzero(matches):
        km, q_key, q_pos, q_len = q_rows[qi]
        ti = hit_idx[qi]
        diag = int(t_pos[ti]) - int(q_pos) if switched \
            else int(q_pos) - int(t_pos[ti])
        diag = ((diag + 0x8000) & 0xFFFF) - 0x8000  # short assignment wrap
        if switched:
            out_rows.append((int(t_id[ti]), q_key, diag))
        else:
            out_rows.append((q_key, int(t_id[ti]), diag))
    out_rows.sort(key=lambda r: (r[0], r[1], r[2]))

    entries = []
    i, n = 0, len(out_rows)
    while i < n:
        gid = out_rows[i][0]
        lines = []
        j = i
        while j < n and out_rows[j][0] == gid:
            hid = out_rows[j][1]
            e = j
            top = 0
            best_diag = out_rows[j][2]
            while e < n and out_rows[e][0] == gid and out_rows[e][1] == hid:
                # cnt>best fires every step -> bestDiagonal = last (max)
                best_diag = out_rows[e][2]
                top += 1
                e += 1
            lines.append(f"{hid}\t{top}\t{best_diag}\n")
            j = e
        entries.append((gid, "".join(lines).encode()))
        i = j
    mmseqsdb.write_db(out_db, entries, mmseqsdb.DBTYPE_PREFILTER_RES)
    return out_db


def linsearch_workflow(query_db, target_db, out_db, tmp_dir, evalue=0.001,
                       cov=0.0, cov_mode=None, min_seq_id=0.0,
                       kmers_per_seq=21, alignment_mode=2, params=None,
                       device="cuda"):
    """linsearch.sh (protein path) with FILTER=1, byte-exact stages; the
    alignment on `device`."""
    from ..pipeline.dbtools2 import swapresults
    from ..pipeline.filterdb import filterdb
    from ..pipeline.rescorediagonal import rescorediagonal
    from .align_module import align_db

    os.makedirs(tmp_dir, exist_ok=True)
    idx_path = f"{target_db}{LINIDX_SUFFIX}"
    if not os.path.exists(idx_path):
        build_linindex(target_db, idx_path, kmers_per_seq=kmers_per_seq)
    pref = os.path.join(tmp_dir, "pref")
    kmersearch_db(query_db, idx_path, pref)

    # FILTER: ungapped rescore with covMode target / cov >= 0.9
    # (Linsearch.cpp:113-120), then drop those queries from the space
    reverse_ungap = os.path.join(tmp_dir, "reverse_ungapaln")
    rescorediagonal(target_db, query_db, pref, reverse_ungap,
                    rescore_mode=2, eval_thr=evalue,
                    cov_thr=max(cov, 0.9),
                    cov_mode=1 if cov_mode is None else cov_mode,
                    seq_id_thr=min_seq_id)
    pref_filter = os.path.join(tmp_dir, "pref_filter")
    filterdb(pref, pref_filter, filter_file=reverse_ungap,
             positive_filter=False)

    # gapped alignment, target as query, -e 100000 (Linsearch.cpp:126-129)
    reverse_aln = os.path.join(tmp_dir, "reverse_aln")
    align_db(target_db, query_db, pref_filter, reverse_aln, evalue=100000,
             cov=cov, cov_mode=cov_mode or 0, min_seq_id=min_seq_id,
             alignment_mode=alignment_mode, params=params, device=device)

    # swap back to query-centric, applying the user's E-value
    swapresults(target_db, query_db, reverse_aln, out_db, eval_thr=evalue)
    return out_db
