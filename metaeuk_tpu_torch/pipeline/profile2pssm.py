# Copy of metaeuk_tpu/pipeline/profile2pssm.py; it differs from its original only in this note.
"""profile2pssm: HMM-profile DB -> human-readable PSSM table.

Port of lib/mmseqs/src/util/profile2pssm.cpp.  Each entry renders as

    Query profile of sequence <key>
    Pos<TAB>Cns<TAB>A<TAB>C...
    <pos><TAB><consensus aa><TAB><20 scores>

where scores are the stored int8 profile bytes divided by 4 with C
truncation (Sequence::mapProfile, Sequence.cpp:274).  --db-out 1 writes a
generic DB (one entry per key, no text banner); the default writes one
flat text file (DBTYPE_OMIT_FILE: no .index/.dbtype).
"""

import numpy as np

from ..data.submat import ALPHABET
from ..io import mmseqsdb

_HEADER = "Pos\tCns\t" + "\t".join(ALPHABET[:20]) + "\n"


def profile_entry_to_pssm_text(payload, key, db_out=False):
    # L = (entryLen - 1) / PROFILE_READIN_SIZE (DBReader::getSeqLen,
    # DBReader.h:224-226); a 23-byte-record convertprofiledb DB is read
    # with the same 25-byte stride, reproducing the reference's misparse
    L = len(payload) // 25
    rec = np.frombuffer(payload[:L * 25], np.uint8).reshape(L, 25)
    scores = rec[:, :20].view(np.int8).astype(np.int32)
    # C integer division truncates toward zero
    scores = np.trunc(scores / 4).astype(np.int32)
    consensus = rec[:, 21]
    out = []
    if not db_out:
        out.append(f"Query profile of sequence {key}\n")
    out.append(_HEADER)
    for j in range(rec.shape[0]):
        # num2aa beyond the alphabet is zero-filled in the reference
        cns = ALPHABET[consensus[j]] if consensus[j] < len(ALPHABET) else "\0"
        out.append(f"{j}\t{cns}\t"
                   + "\t".join(str(int(s)) for s in scores[j]) + "\n")
    return "".join(out)


def profile2pssm_db(profile_db, out_path, db_out=False):
    entries = mmseqsdb.read_db(profile_db)
    if db_out:
        payloads = [(k, profile_entry_to_pssm_text(v, k, True).encode())
                    for k, v in entries]
        mmseqsdb.write_db(out_path, payloads, mmseqsdb.DBTYPE_GENERIC)
    else:
        with open(out_path, "w") as f:
            for k, v in entries:
                f.write(profile_entry_to_pssm_text(v, k, False))
    return out_path
