# Copy of metaeuk_tpu/pipeline/convertprofiledb.py; it differs from its original only in this note.
"""convertprofiledb: HH-suite .hhm text DB -> MMseqs HMM-profile DB.

Port of lib/mmseqs/src/util/convertprofiledb.cpp (parseHMM + driver).
Each position stores Sequence::scoreMask(prob) for the 20 amino acids --
an 8-bit minifloat (3 exponent / 5 mantissa bits, MathUtil.h:171-204)
of the emission probability plus one -- followed by the query residue,
the consensus residue, and the Neff byte.

Faithfully replicated reference quirks:
  - emission '*' -> prob 0.0; a word starting with '0' -> prob 1.0;
    otherwise prob = fpow2(-(int/1000)) (convertprofiledb.cpp:66-80)
  - the consensus byte is argmax(prob - pBack) but defaults to 21 (GAP)
    when no probability exceeds its background (convertprofiledb.cpp:100-113)
  - NEFF is parsed from word 7 of the *match-emission* line (the data
    pointer is never advanced to the transition line), i.e. the 6th
    emission value / 1000 (convertprofiledb.cpp:115-118)
"""

import numpy as np

from ..data.submat import AA2NUM, BLOSUM62_PBACK
from ..io import mmseqsdb
from ..ops.pssm import convert_neff_to_char, fpow2


def convert_float_to_char(v):
    """MathUtil::convertFloatToChar minifloat (MathUtil.h:185-204)."""
    import math
    v = float(np.float32(v))
    if math.isnan(v) or v <= 0.0:
        return 0
    if v >= 2.0:
        return 0xFF
    r, exp = math.frexp(v)
    exp += 6
    if exp > 7:
        return 0xFF
    if -exp >= 5:
        return 0
    mantissa = int(r * 64.0)
    if exp > 0:
        return ((exp << 5) | (mantissa & ~32)) & 0xFF
    return (mantissa >> (1 - exp)) & 31


def score_mask(prob):
    """Sequence::scoreMask (Sequence.h:503-507): minifloat + 1."""
    return (convert_float_to_char(prob) + 1) & 0xFF


def _fast_atoi(word):
    """Util::fast_atoi: leading digits only, no sign handling."""
    n = 0
    for ch in word:
        if not ch.isdigit():
            break
        n = n * 10 + ord(ch) - 48
    return n


def parse_hmm(text):
    """One .hhm entry -> (profile_payload, header_str)."""
    lines = text.splitlines()
    it = iter(range(len(lines)))
    li = 0
    while not lines[li].startswith("NAME"):
        li += 1
    header = lines[li][6:] + "\n"
    while not lines[li].startswith(">Consensus"):
        li += 1
    li += 1
    while not lines[li].startswith(">"):
        li += 1
    li += 1
    seq_parts = []
    while not (lines[li].startswith(">") or lines[li].startswith("#")):
        seq_parts.append(lines[li])
        li += 1
    sequence = "".join(seq_parts)
    while not lines[li].startswith("#"):
        li += 1
    li += 5
    out = bytearray()
    seq_pos = 0
    while not lines[li].startswith("//"):
        words = lines[li].split()
        probs = np.zeros(20, np.float32)
        for aa in range(20):
            w = words[aa + 2]
            if w[0] == "*":
                probs[aa] = np.float32(0.0)
            elif w[0] == "0":
                probs[aa] = np.float32(1.0)
            else:
                entry = _fast_atoi(w)
                probs[aa] = fpow2(np.float32(-(np.float32(entry)
                                               / np.float32(1000.0))))
        for aa in range(20):
            b = score_mask(probs[aa])
            if b == 0:
                raise ValueError("PSSM score of 0 is too large")
            out.append(b)
        maxw = np.float32(0.0)
        maxa = 21
        for aa in range(20):
            d = np.float32(probs[aa] - np.float32(BLOSUM62_PBACK[aa]))
            if d > maxw:
                maxw = d
                maxa = aa
        out.append(int(AA2NUM[ord(sequence[seq_pos])]))
        out.append(maxa)
        neff = np.float32(_fast_atoi(words[7])) / np.float32(1000.0)
        out.append(convert_neff_to_char(neff))
        seq_pos += 1
        li += 3
    return bytes(out), header


def convertprofiledb(in_db, out_db):
    """ffindex-style text DB of .hhm entries -> profile DB + _h."""
    import pathlib
    base = in_db
    if pathlib.Path(f"{in_db}.ffdata").exists():
        base = None
        data = pathlib.Path(f"{in_db}.ffdata").read_bytes()
        index_path = f"{in_db}.ffindex"
    else:
        data = pathlib.Path(in_db).read_bytes()
        index_path = f"{in_db}.index"
    entries = []
    with open(index_path) as f:
        for line in f:
            name, off, ln = line.split("\t")
            entries.append((name, int(off), int(ln)))
    payloads, headers = [], []
    for i, (name, off, ln) in enumerate(entries):
        blob = data[off:off + ln].rstrip(b"\x00").decode()
        payload, header = parse_hmm(blob)
        payloads.append((i, payload))
        headers.append((i, header.encode()))
    mmseqsdb.write_db(out_db, payloads, mmseqsdb.DBTYPE_HMM_PROFILE)
    mmseqsdb.write_db(f"{out_db}_h", headers, mmseqsdb.DBTYPE_GENERIC)
    return out_db
