# Copy of metaeuk_tpu/pipeline/dbtools4.py; it differs from its original only in this note.
"""Util batch 4: translateaa, compress/decompress, dbtype,
setextendeddbtype, view, aliasdb, diskspaceavail, version.

Reference behaviors:
  - translateaa (lib/mmseqs/src/util/translateaa.cpp): reverse-translate
    an AA DB to nucleotides using, per residue, the FIRST codon (in
    A,C,G,T nested enumeration order) whose translation equals
    subMat.num2aa[i]; X -> NNN; unknown residues map through the
    aa2num X fallback. Output dbtype NUCLEOTIDES; ancillary files
    (headers/lookup) soft-linked.
  - compress/decompress (util/compress.cpp): rewrite a DB with/without
    the zstd per-entry framing (see io/zstdio.py).
  - dbtype (util/dbtype.cpp): print Parameters::getDbTypeName.
  - setextendeddbtype (util/setextendeddbtype.cpp): dbtype |=
    (extended & 0x7FFE) << 16, preserving the compressed bit.
  - view (util/view.cpp): print entries by key (entryLen-1 bytes).
  - aliasdb (util/cpmvrmlndb.cpp + DBReader::aliasDb): symlink every
    DB file under the alias basename, links created inside the DB's
    directory.
  - diskspaceavail (util/diskspaceavail.cpp): bytes available on the
    path's filesystem (statvfs f_bavail * f_frsize).
"""

import os
import struct

from ..io import mmseqsdb

DBTYPE_NAMES = {
    0: "Aminoacid", 1: "Nucleotide", 2: "Profile", 5: "Alignment",
    6: "Clustering", 7: "Prefilter", 8: "Taxonomy", 9: "Index",
    10: "CA3M", 11: "MSA", 12: "Generic", 14: "Bi-directional prefilter",
    15: "Offsetted headers", 16: "Directory", 17: "Flatfile", 19: "stdin",
    20: "uri",
}


def dbtype_name(db):
    """Parameters::getDbTypeName on the dbtype file (mask 0xFFFF)."""
    return DBTYPE_NAMES.get(mmseqsdb.read_dbtype(db), "Unknown")


def setextendeddbtype(db, extended):
    raw = mmseqsdb.read_dbtype_raw(db)
    raw |= (extended & 0x7FFE) << 16
    with open(f"{db}.dbtype", "wb") as f:
        f.write(struct.pack("<I", raw))


def translateaa_db(in_db, out_db, translation_table=1):
    """AA DB -> nucleotide DB via first-codon reverse translation."""
    import numpy as np
    from ..data.gencode import GeneticCode
    from ..data.submat import AA2NUM, NUM2AA

    gc = GeneticCode(translation_table)
    nucs = b"ACGT"
    lookup = [None] * 21
    for n1 in nucs:
        for n2 in nucs:
            for n3 in nucs:
                codon = bytes([n1, n2, n3])
                aa = gc.translate_ascii(codon)
                for i in range(20):
                    if lookup[i] is None and aa[:1] == bytes([NUM2AA[i]]):
                        lookup[i] = codon
    lookup[20] = b"NNN"
    # 3-byte codon table indexed by residue num for a vectorized gather
    table = np.frombuffer(b"".join(lookup), np.uint8).reshape(21, 3)
    out = []
    for key, payload in mmseqsdb.read_db(in_db):
        seq = np.frombuffer(payload.rstrip(b"\n"), np.uint8)
        num = AA2NUM[seq]
        out.append((key, table[num].tobytes() + b"\n"))
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_NUCL)
    for suffix in ("_h", "_h.index", "_h.dbtype", ".lookup", ".source"):
        src = f"{in_db}{suffix}"
        dst = f"{out_db}{suffix}"
        if os.path.exists(src):
            if os.path.lexists(dst):
                os.remove(dst)
            os.symlink(os.path.abspath(src), dst)
    return out_db


def compress_db(in_db, out_db):
    """Entry bytes are compressed WITHOUT the NUL (compress.cpp passes
    entryLen-1 to writeData); writeEnd appends the terminator."""
    entries = mmseqsdb.read_db(in_db)
    mmseqsdb.write_db(out_db, entries, mmseqsdb.read_dbtype(in_db),
                      compressed=True)
    return out_db


def decompress_db(in_db, out_db):
    entries = mmseqsdb.read_db(in_db)
    mmseqsdb.write_db(out_db, entries, mmseqsdb.read_dbtype(in_db))
    return out_db


def view(db, ids, out=None):
    """Print entries by key; returns the concatenated bytes."""
    import sys
    data = dict(mmseqsdb.read_db(db))
    chunks = []
    for ref in ids:
        key = int(ref)
        if key not in data:
            continue
        chunks.append(data[key])
    blob = b"".join(chunks)
    (out or sys.stdout.buffer).write(blob)
    return blob


def aliasdb(db, alias):
    """Symlink all DB files under the alias basename, inside db's dir."""
    from .dbtools2 import DB_SUFFIXES
    base = os.path.basename(alias)
    d = os.path.dirname(os.path.abspath(db))
    for s in DB_SUFFIXES:
        src = db + s
        if os.path.exists(src):
            dst = os.path.join(d, base + s)
            if os.path.lexists(dst):
                os.remove(dst)
            os.symlink(os.path.basename(src) if
                       os.path.dirname(os.path.abspath(src)) == d
                       else os.path.abspath(src), dst)


def diskspaceavail(path):
    st = os.statvfs(path if os.path.isdir(path)
                    else os.path.dirname(os.path.abspath(path)) or ".")
    return st.f_bavail * st.f_frsize
