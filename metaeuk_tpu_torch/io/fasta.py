# Copy of metaeuk_tpu/io/fasta.py; only the imports differ.
"""FASTA ingestion and header-accession parsing.

Replaces the reference's createdb + KSeqWrapper path
(lib/mmseqs/src/util/createdb.cpp) with a simple host-side parser feeding
flat arrays. Accession parsing mirrors Util::parseFastaHeader /
getFastaHeaderPosition (lib/mmseqs/src/commons/Util.cpp:117-200).
"""

import gzip

_DB_PREFIXES = [
    # (prefix, length, verticalBarPos) — Util.cpp:133-148
    ("uc", 2, 0),
    ("cl|", 3, 1),
    ("sp|", 3, 1),
    ("tr|", 3, 1),
    ("gb|", 3, 1),
    ("ref|", 4, 1),
    ("pdb|", 4, 1),
    ("bbs|", 4, 1),
    ("lcl|", 4, 1),
    ("pir||", 5, 1),
    ("prf||", 5, 1),
    ("gnl|", 4, 2),
    ("pat|", 4, 2),
    ("gi|", 3, 3),
]


def parse_fasta_header(header):
    """Extract the accession from a FASTA header line (without '>').

    Mirrors Util::parseFastaHeader: operate on the first whitespace-delimited
    word, then strip known database prefixes.
    """
    word = header.split()[0] if header.split() else ""
    if not word:
        return ""
    offset = 0
    if word.startswith("consensus_"):
        offset = 10
    for prefix, plen, bar_pos in _DB_PREFIXES:
        if word.startswith(prefix, offset):
            start = offset + plen
            if bar_pos > 1:
                for _ in range(bar_pos - 1):
                    end = word.find("|", start)
                    if end == -1:
                        return ""
                    start = end + 1
            end = word.find("|", start)
            if end == -1:
                return word[start:]
            return word[start:end]
    return word[offset:]


def read_fasta(path):
    """Yield (header, sequence_bytes) pairs from a FASTA file (.gz ok)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    header = None
    chunks = []
    with opener(path, "rb") as f:
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if header is not None:
                    yield header, b"".join(chunks)
                header = line[1:].decode("utf-8", "replace")
                chunks = []
            elif line and header is not None:
                chunks.append(line)
    if header is not None:
        yield header, b"".join(chunks)
