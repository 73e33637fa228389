# Copy of metaeuk_tpu/search/nucl_search.py; it differs from its original only in this note.
"""Nucleotide-vs-nucleotide search: the blastn.sh workflow at byte parity.

Pipeline (data/workflow/blastn.sh + Search.cpp:571-622, --search-type 3):
  extractframes query (strand 2: forward+reverse frame 1)
  -> splitsequence query & target (max-seq-len 10000, overlap 300)
  -> nucleotide k-mer prefilter (spaced 15-mers, search/prefilter_nucl.py)
  -> banded ksw2 alignment (search/nucl_align.py)
  -> offsetalignment back to source coordinates (pipeline/offsetaln.py)

Every stage is byte-identical to the reference binary on the committed
fixtures (tests/test_nucl_search.py).
"""

import os

from ..io import mmseqsdb
from ..pipeline import dbtools
from ..pipeline.offsetaln import offsetalignment
from .nucl_align import align_module_nucl
from .prefilter_nucl import prefilter_nucl_db


def nucl_search_workflow(query_db, target_db, out_db, tmp_dir,
                         evalue=0.001, strand=2, max_seq_len=10000,
                         sequence_overlap=0, kmer_size=15, max_seqs=300,
                         add_backtrace=False, cov_thr=0.0, cov_mode=0,
                         seq_id_thr=0.0):
    """search --search-type 3 for nucleotide query and target DBs."""
    os.makedirs(tmp_dir, exist_ok=True)
    qf = query_db
    if strand in (0, 2):
        qf = os.path.join(tmp_dir, "query_seqs")
        fwd = (1,) if strand == 2 else ()
        dbtools.extractframes(query_db, qf, forward_frames=fwd,
                              reverse_frames=(1,))
    qs = os.path.join(tmp_dir, "query_seqs_split")
    dbtools.splitsequence(qf, qs, max_seq_len=max_seq_len,
                          overlap=sequence_overlap)
    ts = os.path.join(tmp_dir, "target_seqs_split")
    dbtools.splitsequence(target_db, ts, max_seq_len=max_seq_len,
                          overlap=sequence_overlap)
    pref = os.path.join(tmp_dir, "pref")
    prefilter_nucl_db(qs, ts, pref, max_seqs=max_seqs, kmer_size=kmer_size)
    aln = os.path.join(tmp_dir, "aln")
    align_module_nucl(qs, ts, pref, aln, evalue=evalue,
                      add_backtrace=add_backtrace, cov_thr=cov_thr,
                      cov_mode=cov_mode, seq_id_thr=seq_id_thr)
    offsetalignment(query_db, qs, target_db, ts, aln, out_db,
                    search_type=3)
    return out_db


def nucl_search_fasta(query_path, target_path, out_dir, evalue=0.001):
    """FASTA convenience wrapper: createdb both sides, run the workflow,
    return the result alignment DB path."""
    from ..io.seqdb import SeqDB, DBTYPE_NUCL

    os.makedirs(out_dir, exist_ok=True)
    q_db = os.path.join(out_dir, "queryDB")
    t_db = os.path.join(out_dir, "targetDB")
    for path, db in ((query_path, q_db), (target_path, t_db)):
        sdb = SeqDB.from_fasta(path, DBTYPE_NUCL)
        mmseqsdb.write_seqdb(db, sdb)
    out_db = os.path.join(out_dir, "result")
    tmp = os.path.join(out_dir, "tmp")
    return nucl_search_workflow(q_db, t_db, out_db, tmp, evalue=evalue)
