# Copy of metaeuk_tpu/data/gencode.py; only the imports differ.
"""NCBI genetic-code tables and vectorized codon translation.

Re-implements the semantics of the reference's TranslateNucl
(reference: lib/mmseqs/src/commons/TranslateNucl.h:80-511): a 4-bit
IUPAC base encoding, a 4097-state codon table with full ambiguity
expansion (ambiguous codons resolve to a unique residue when all
expansions agree, to B/Z/J for Asx/Glx/Xle, else X), and per-table
start/stop codon sets.

The ncbieaa/sncbieaa strings are the standard public NCBI genetic-code
tables (https://www.ncbi.nlm.nih.gov/Taxonomy/Utils/wprintgc.cgi).
"""

import numpy as np

# base order in the 4-bit IUPAC encoding: index 0 = gap, 15 = N
_CHAR_TO_BASE = "-ACMGRSVTWYHKDBN"
_BASE_TO_COMP = "-TGKCYSBAWRDMHVN"

# codon index order inside ncbieaa strings is T,C,A,G
_CODON_IDX = {1: 2, 2: 1, 4: 3, 8: 0}  # A=1->2, C=2->1, G=4->3, T=8->0

# id -> (ncbieaa, sncbieaa); standard NCBI tables
# (same tables as reference TranslateNucl.h:110-280)
GENETIC_CODES = {
    1: ("FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
        "---M------**--*----M---------------M----------------------------"),
    2: ("FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSS**VVVVAAAADDEEGGGG",
        "----------**--------------------MMMM----------**---M------------"),
    3: ("FFLLSSSSYY**CCWWTTTTPPPPHHQQRRRRIIMMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
        "----------**----------------------MM----------------------------"),
    4: ("FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
        "--MM------**-------M------------MMMM---------------M------------"),
    5: ("FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSSSVVVVAAAADDEEGGGG",
        "---M------**--------------------MMMM---------------M------------"),
    6: ("FFLLSSSSYYQQCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
        "--------------*--------------------M----------------------------"),
    9: ("FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
        "----------**-----------------------M---------------M------------"),
    10: ("FFLLSSSSYY**CCCWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "----------**-----------------------M----------------------------"),
    11: ("FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "---M------**--*----M------------MMMM---------------M------------"),
    12: ("FFLLSSSSYY**CC*WLLLSPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "----------**--*----M---------------M----------------------------"),
    13: ("FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSGGVVVVAAAADDEEGGGG",
         "---M------**----------------------MM---------------M------------"),
    14: ("FFLLSSSSYYY*CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
         "-----------*-----------------------M----------------------------"),
    15: ("FFLLSSSSYY*QCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "----------*---*--------------------M----------------------------"),
    16: ("FFLLSSSSYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "----------*---*--------------------M----------------------------"),
    21: ("FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
         "----------**-----------------------M---------------M------------"),
    22: ("FFLLSS*SYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "------*---*---*--------------------M----------------------------"),
    23: ("FF*LSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "--*-------**--*-----------------M--M---------------M------------"),
    24: ("FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSSKVVVVAAAADDEEGGGG",
         "---M------**-------M---------------M---------------M------------"),
    25: ("FFLLSSSSYY**CCGWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "---M------**-----------------------M---------------M------------"),
    26: ("FFLLSSSSYY**CC*WLLLAPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "----------**--*----M---------------M----------------------------"),
    27: ("FFLLSSSSYYQQCCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "--------------*--------------------M----------------------------"),
    28: ("FFLLSSSSYYQQCCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "----------**--*--------------------M----------------------------"),
    29: ("FFLLSSSSYYYYCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "--------------*--------------------M----------------------------"),
    30: ("FFLLSSSSYYEECC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "--------------*--------------------M----------------------------"),
    31: ("FFLLSSSSYYEECCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "----------**-----------------------M----------------------------"),
}


def _build_base_to_idx():
    """256-entry map char -> 4-bit IUPAC base code (0..15).

    Matches reference TranslateNucl.h initConversionTable:
    unknown chars map to 0 (gap); U/u -> T; X/x -> N; raw 0..15 pass through.
    """
    m = np.zeros(256, dtype=np.int32)
    for i, ch in enumerate(_CHAR_TO_BASE):
        m[ord(ch)] = i
        m[ord(ch.lower())] = i
    m[ord("U")] = m[ord("T")]
    m[ord("u")] = m[ord("T")]
    m[ord("X")] = 15
    m[ord("x")] = 15
    for i in range(16):
        m[i] = i
    return m


BASE_TO_IDX = _build_base_to_idx()


class GeneticCode:
    """Translation tables for one NCBI genetic code.

    Attributes:
      aa: uint8[4096] residue (ASCII) for codon state ``256*(i-1)+16*(j-1)+(k-1)``
          where i,j,k are 1..16 base codes minus... see :meth:`codon_state`.
      stop_codons / start_codons: lists of 3-letter codon strings (unambiguous).
    """

    def __init__(self, table_id=1):
        if table_id not in GENETIC_CODES:
            raise ValueError(f"unknown translation table {table_id}")
        ncbieaa, sncbieaa = GENETIC_CODES[table_id]
        self.table_id = table_id
        # state st = 1 + (i-0)*256 + ... iterate i,j,k in 0..15 -> st = 1..4096
        aa = np.full(4097, ord("X"), dtype=np.uint8)
        orf = np.full(4097, ord("-"), dtype=np.uint8)
        stop_codons = set()
        start_codons = set()
        expansions = (1, 2, 4, 8)  # A, C, G, T bit codes
        st = 1
        for i in range(16):
            for j in range(16):
                for k in range(16):
                    a = None
                    o = None
                    for x in expansions:
                        if not (x & i):
                            continue
                        for y in expansions:
                            if not (y & j):
                                continue
                            for z in expansions:
                                if not (z & k):
                                    continue
                                cd = 16 * _CODON_IDX[x] + 4 * _CODON_IDX[y] + _CODON_IDX[z]
                                ch = ncbieaa[cd]
                                if a is None:
                                    a = ch
                                    if a == "*":
                                        stop_codons.add(cd)
                                elif a != ch:
                                    if a in "BDN" and ch in "DN":
                                        a = "B"
                                    elif a in "ZEQ" and ch in "EQ":
                                        a = "Z"
                                    elif a in "JIL" and ch in "IL":
                                        a = "J"
                                    else:
                                        a = "X"
                                so = sncbieaa[cd]
                                if o is None:
                                    o = so
                                elif o != so:
                                    o = "X"
                                if so == "M":
                                    start_codons.add(cd)
                    if a is not None:
                        aa[st] = ord(a)
                    if o is not None:
                        orf[st] = ord(o)
                    st += 1
        self.aa = aa
        self.orf = orf

        def cd_to_str(cd):
            tcag = "TCAG"
            return tcag[cd // 16] + tcag[(cd // 4) % 4] + tcag[cd % 4]

        self.stop_codons = sorted(cd_to_str(c) for c in stop_codons)
        self.start_codons = sorted(cd_to_str(c) for c in start_codons)

    def codon_states(self, b0, b1, b2):
        """Codon state indices for arrays of 4-bit base codes (1..4096)."""
        return 256 * b0 + 16 * b1 + b2 + 1

    def translate_ascii(self, nucl_bytes):
        """Translate an ASCII nucleotide array (len divisible by 3) to AA bytes.

        Preserves lowercase (a codon containing any lowercase base yields a
        lowercase residue), matching TranslateNucl::translate
        (reference TranslateNucl.h:488-503).
        """
        arr = np.frombuffer(bytes(nucl_bytes), dtype=np.uint8)
        n = (len(arr) // 3) * 3
        arr = arr[:n]
        codons = arr.reshape(-1, 3)
        b = BASE_TO_IDX[codons]
        states = self.codon_states(b[:, 0], b[:, 1], b[:, 2])
        res = self.aa[states]
        lower = np.any((codons >= ord("a")) & (codons <= ord("z")), axis=1)
        res = np.where(lower, res | 0x20, res)
        return res.tobytes()

    def translate_codes(self, base_codes):
        """Translate an int array of 4-bit base codes, shape (..., 3*L)."""
        b = base_codes.reshape(*base_codes.shape[:-1], -1, 3)
        states = self.codon_states(b[..., 0], b[..., 1], b[..., 2])
        return self.aa[states]


# IUPAC reverse complement on ASCII, matching Orf::iupacReverseComplementTable
# (reference lib/mmseqs/src/commons/Orf.cpp:48-52); unknown -> '.'
def _build_revcomp_table():
    t = np.full(256, ord("."), dtype=np.uint8)
    pairs = "TVGH..CD..M.KN...YSAABW.R"
    # table row for 'A'..'Z' then 'a'..'z' (same order as reference string)
    for off, base in ((0, ord("A")), (32, ord("a"))):
        for i, ch in enumerate(pairs):
            if ch != ".":
                t[base + i] = ord(ch) + off
    return t


REVCOMP_TABLE = _build_revcomp_table()


def reverse_complement_ascii(seq_bytes):
    """Reverse complement of an ASCII IUPAC nucleotide byte string.

    '.'-mapped (unknown) characters become 'N', matching Orf::setSequence
    (reference Orf.cpp:146-151).
    """
    arr = np.frombuffer(bytes(seq_bytes), dtype=np.uint8)
    rc = REVCOMP_TABLE[arr[::-1]]
    rc = np.where(rc == ord("."), np.uint8(ord("N")), rc)
    return rc.tobytes()
