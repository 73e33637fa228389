# Copy of metaeuk_tpu/io/seqdb.py; only the imports differ.
"""Flat sequence store — the data plane of the framework.

Replaces the reference's (data, .index, .dbtype) triple + DBReader mmap
(lib/mmseqs/src/commons/DBReader.h) with contiguous numpy arrays that are
directly device-transferable: one uint8 buffer holding all residues and an
int64 offsets array. Keys are stable uint32 identifiers (defaults 0..n-1 in
input order, like createdb with shuffle disabled).
"""

import numpy as np

from .fasta import parse_fasta_header, read_fasta

DBTYPE_AA = 0
DBTYPE_NUCL = 1
DBTYPE_HMM_PROFILE = 2


class SeqDB:
    """A set of sequences stored as one flat buffer plus offsets."""

    def __init__(self, data, offsets, headers=None, keys=None, dbtype=DBTYPE_AA):
        self.data = np.asarray(data, dtype=np.uint8)
        self.offsets = np.asarray(offsets, dtype=np.int64)
        n = len(self.offsets) - 1
        self.headers = headers if headers is not None else [str(i) for i in range(n)]
        self.keys = (np.asarray(keys, dtype=np.uint32) if keys is not None
                     else np.arange(n, dtype=np.uint32))
        self.dbtype = dbtype
        self._key_to_idx = None

    def __len__(self):
        return len(self.offsets) - 1

    @property
    def lengths(self):
        return (self.offsets[1:] - self.offsets[:-1]).astype(np.int64)

    def seq(self, i):
        """Sequence i as a uint8 view."""
        return self.data[self.offsets[i]:self.offsets[i + 1]]

    def seq_bytes(self, i):
        return self.seq(i).tobytes()

    def accession(self, i):
        return parse_fasta_header(self.headers[i])

    def id_of_key(self, key):
        if self._key_to_idx is None:
            self._key_to_idx = {int(k): i for i, k in enumerate(self.keys)}
        return self._key_to_idx[int(key)]

    def total_residues(self):
        """Total residue count — the E-value "m" term, matching
        DBReader::getAminoAcidDBSize for protein DBs (DBReader.h:181)."""
        return int(self.offsets[-1])

    @classmethod
    def from_fasta(cls, path, dbtype):
        headers = []
        parts = []
        offsets = [0]
        total = 0
        for header, seq in read_fasta(path):
            headers.append(header)
            parts.append(np.frombuffer(seq, dtype=np.uint8))
            total += len(seq)
            offsets.append(total)
        data = (np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint8))
        return cls(data, np.asarray(offsets), headers, dbtype=dbtype)

    @classmethod
    def from_sequences(cls, seqs, headers=None, dbtype=DBTYPE_AA, keys=None):
        parts = [np.frombuffer(bytes(s), dtype=np.uint8) for s in seqs]
        offsets = np.zeros(len(parts) + 1, dtype=np.int64)
        if parts:
            offsets[1:] = np.cumsum([len(p) for p in parts])
        data = np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint8)
        return cls(data, offsets, headers, keys=keys, dbtype=dbtype)


def detect_dbtype(path):
    """Guess nucleotide vs amino-acid content from the first sequences,
    like createdb's auto-detection."""
    nucl = set(b"ACGTNUacgtnu")
    n_nucl = 0
    n_tot = 0
    for i, (_, seq) in enumerate(read_fasta(path)):
        n_tot += len(seq)
        n_nucl += sum(1 for c in seq if c in nucl)
        if i >= 9:
            break
    if n_tot == 0:
        return DBTYPE_AA
    return DBTYPE_NUCL if n_nucl / n_tot > 0.9 else DBTYPE_AA
