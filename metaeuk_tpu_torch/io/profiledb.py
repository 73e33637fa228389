# Copy of metaeuk_tpu/io/profiledb.py; only the imports differ.
"""MMseqs HMM-profile DB reading.

Profile entries are 25-byte records per position
(Sequence::mapProfile, lib/mmseqs/src/commons/Sequence.cpp:241-292):
20 int8 scores (4x-scaled log-odds), query residue, consensus residue,
Neff byte, gap-del byte, gap-ins byte. The alignment PSSM is score/4 with
C truncation toward zero, X column = 0 (Sequence.cpp:272-280).
"""

import numpy as np

from .mmseqsdb import read_db, read_dbtype, DBTYPE_HMM_PROFILE

PROFILE_READIN_SIZE = 25
PROFILE_AA_SIZE = 20


class ProfileDB:
    """A set of profiles: per entry a PSSM (L, 21) int32 + consensus seq."""

    def __init__(self, pssms, consensus, query_seqs, headers, keys,
                 data_size=None, raw_scores=None):
        self.pssms = pssms
        self.consensus = consensus
        self.query_seqs = query_seqs
        self.headers = headers
        self.keys = keys
        # per entry (L, 20) int16 stored PSSM scores (4x-scaled), kept for
        # the profile-query k-mer prefilter's rankedDescSort20 rows
        self.raw_scores = raw_scores
        self.dbtype = DBTYPE_HMM_PROFILE
        # raw DB data size incl. per-entry NUL (DBReader dataSize)
        self.data_size = (data_size if data_size is not None
                          else sum(len(p) * PROFILE_READIN_SIZE + 1
                                   for p in pssms))

    def __len__(self):
        return len(self.pssms)

    def accession(self, i):
        from .fasta import parse_fasta_header
        return parse_fasta_header(self.headers[i])

    def total_residues(self):
        """getAminoAcidDBSize for profiles (DBReader.cpp:589-597):
        dataSize/25 - numEntries — dataSize includes the per-entry NUL, so
        this slightly undercounts the true column total; replicated for
        E-value parity."""
        return self.data_size // PROFILE_READIN_SIZE - len(self.pssms)

    @classmethod
    def from_db(cls, path):
        if read_dbtype(path) != DBTYPE_HMM_PROFILE:
            raise ValueError(f"{path} is not an HMM-profile DB")
        pssms, consensus, query_seqs, keys, raws = [], [], [], [], []
        for key, payload in read_db(path):
            raw = np.frombuffer(payload, dtype=np.int8)
            n = len(raw) // PROFILE_READIN_SIZE
            rec = raw[:n * PROFILE_READIN_SIZE].reshape(n, PROFILE_READIN_SIZE)
            scores = rec[:, :PROFILE_AA_SIZE].astype(np.int32)
            # C integer division truncates toward zero
            pssm20 = np.trunc(scores / 4.0).astype(np.int32)
            pssm = np.zeros((n, 21), dtype=np.int32)
            pssm[:, :20] = pssm20
            pssms.append(pssm)
            raws.append(scores.astype(np.int16))
            query_seqs.append(rec[:, PROFILE_AA_SIZE].astype(np.uint8))
            consensus.append(rec[:, PROFILE_AA_SIZE + 1].astype(np.uint8))
            keys.append(key)
        try:
            hdrs = dict(read_db(f"{path}_h"))
            headers = [hdrs[k].decode("utf-8", "replace").rstrip("\n")
                       for k in keys]
        except FileNotFoundError:
            headers = [str(k) for k in keys]
        return cls(pssms, consensus, query_seqs, headers, keys,
                   raw_scores=raws)
