# Copy of metaeuk_tpu/io/mmseqsdb.py; only the imports differ.
"""MMseqs2 DB triple (data, .index, .dbtype) import/export shim.

Interop with the reference ecosystem (DBReader/DBWriter,
lib/mmseqs/src/commons/DBReader.h:56-120): index lines are
"key<TAB>offset<TAB>length", data entries are NUL-terminated (length
includes the trailing NUL). Used for stage-level parity testing and for
consuming/producing reference-compatible artifacts.
"""

import os
import struct

DBTYPE_AA = 0
DBTYPE_NUCL = 1
DBTYPE_HMM_PROFILE = 2
DBTYPE_ALIGNMENT_RES = 5
DBTYPE_PREFILTER_RES = 7
DBTYPE_GENERIC = 12


def read_dbtype(path):
    with open(f"{path}.dbtype", "rb") as f:
        return struct.unpack("<i", f.read(4))[0] & 0xFFFF


def read_dbtype_raw(path):
    """Full 32-bit dbtype word (bit 31 = compressed,
    bits 16-30 = extended dbtype flags)."""
    with open(f"{path}.dbtype", "rb") as f:
        return struct.unpack("<I", f.read(4))[0]


def is_compressed(path):
    import os
    return os.path.exists(f"{path}.dbtype") and \
        bool(read_dbtype_raw(path) & 0x80000000)


def read_db_str(path):
    """String-keyed DB read (DBReader<std::string>, e.g. maskbygff's
    input, maskbygff.cpp:14-16): index first column kept as the raw
    string. Returns [(name, payload_bytes)] in index-file order (the
    NOSORT access order)."""
    with open(f"{path}.index") as f:
        index = [(name, int(off), int(ln))
                 for name, off, ln in
                 (line.rstrip("\n").split("\t") for line in f)]
    with open(path, "rb") as f:
        data = f.read()
    entries = []
    for name, offset, length in index:
        payload = data[offset:offset + length]
        if payload.endswith(b"\x00"):
            payload = payload[:-1]
        entries.append((name, payload))
    return entries


def read_db(path):
    """Returns list of (key, payload_bytes) in index order; payload excludes
    the trailing NUL. Transparently decompresses MMseqs compressed DBs
    (entry = [u32 csize][frame][term], DBReader::getDataCompressed)."""
    entries = []
    with open(f"{path}.index") as f:
        index = [tuple(int(x) for x in line.split("\t")) for line in f]
    with open(path, "rb") as f:
        data = f.read()
    if is_compressed(path):
        from . import zstdio
        for key, offset, length in index:
            csize = struct.unpack_from("<I", data, offset)[0]
            blob = data[offset + 4:offset + 4 + csize]
            term = data[offset + 4 + csize]
            if term == 0:  # zstd stream; index length = orig size + 1
                payload = zstdio.decompress(blob, length - 1)
            else:  # 0xFF: raw short entry
                payload = blob
            if payload.endswith(b"\x00"):
                payload = payload[:-1]
            entries.append((key, payload))
        return entries
    for key, offset, length in index:
        payload = data[offset:offset + length]
        if payload.endswith(b"\x00"):
            payload = payload[:-1]
        entries.append((key, payload))
    return entries


def write_db(path, entries, dbtype=DBTYPE_GENERIC, sort_index=False,
             compressed=False):
    """entries: iterable of (key, payload_bytes); appends the NUL terminator
    and writes index/dbtype like DBWriter. sort_index replicates
    DBWriter::sortIndex (key-ascending index, data kept in write order).
    compressed=True writes the zstd per-entry framing with bit 31 set in
    .dbtype (DBWriter WRITER_COMPRESSED_MODE)."""
    index = []
    with open(path, "wb") as data_f:
        offset = 0
        if compressed:
            from . import zstdio
            for key, payload in entries:
                payload = bytes(payload)
                if len(payload) < 60:  # DBWriter::writeAdd NOTCOMPRESSED
                    blob = struct.pack("<I", len(payload)) + payload + b"\xff"
                else:
                    frame = zstdio.compress(payload)
                    blob = struct.pack("<I", len(frame)) + frame + b"\x00"
                data_f.write(blob)
                # index keeps the uncompressed size (+1 terminator)
                index.append((int(key), offset, len(payload) + 1))
                offset += len(blob)
        else:
            for key, payload in entries:
                blob = bytes(payload) + b"\x00"
                data_f.write(blob)
                index.append((int(key), offset, len(blob)))
                offset += len(blob)
    if sort_index:
        index.sort(key=lambda e: e[0])
    with open(f"{path}.index", "w") as idx_f:
        for key, off, length in index:
            idx_f.write(f"{key}\t{off}\t{length}\n")
    with open(f"{path}.dbtype", "wb") as f:
        f.write(struct.pack("<I", (dbtype | 0x80000000) if compressed
                            else dbtype))


def read_seq_entries(path):
    """(key, residue_bytes) with DBReader::getSeqLen semantics: sequence
    length = index length - 2. Required for soft/overlapping indexes
    (e.g. splitsequence windows into the parent data file) where entries
    have no own newline/NUL."""
    out = []
    with open(f"{path}.index") as f:
        index = [tuple(int(x) for x in ln.split("\t")) for ln in f]
    with open(path, "rb") as f:
        data = f.read()
    for key, offset, length in index:
        out.append((key, data[offset:offset + max(length - 2, 0)]))
    return out


def read_seqdb(path):
    """Read a sequence DB (+_h headers) into a SeqDB."""
    from .seqdb import SeqDB
    import numpy as np
    seq_entries = read_db(path)
    try:
        hdr_entries = read_db(f"{path}_h")
        headers = [h.decode("utf-8", "replace").rstrip("\n") for _, h in hdr_entries]
    except FileNotFoundError:
        headers = [str(k) for k, _ in seq_entries]
    seqs = [payload.rstrip(b"\n") for _, payload in seq_entries]
    keys = [k for k, _ in seq_entries]
    dbtype = read_dbtype(path)
    return SeqDB.from_sequences(seqs, headers, dbtype=dbtype, keys=keys)


def write_seqdb(path, seqdb, dbtype=None):
    """Write a SeqDB as a reference-compatible sequence DB with headers."""
    dbtype = seqdb.dbtype if dbtype is None else dbtype
    write_db(path, ((int(k), seqdb.seq_bytes(i) + b"\n")
                    for i, k in enumerate(seqdb.keys)), dbtype)
    write_db(f"{path}_h", ((int(k), seqdb.headers[i].encode() + b"\n")
                           for i, k in enumerate(seqdb.keys)), DBTYPE_GENERIC)
