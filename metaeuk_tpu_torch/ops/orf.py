# Copy of metaeuk_tpu/ops/orf.py; only the imports differ.
"""Six-frame stop-to-stop putative-protein-fragment extraction.

Re-implements Orf::findAll/findForward semantics
(reference lib/mmseqs/src/commons/Orf.cpp:171-348) as a vectorized
numpy scan per contig: fragments are runs of non-stop codons between stop
codons (ANY_TO_STOP start mode, MetaEuk's setting,
src/workflow/PredictExons.cpp:9), with incomplete-edge flags, gap (N)
codon counting, and min/max length filters.

Emission order matches the reference's single-pass position scan
(all three forward frames interleaved by closing position, then the
reverse-complement strand), which fixes the global fragment key order
(extractorfs renumbering, lib/mmseqs/src/util/extractorfs.cpp:141-155).
"""

import dataclasses

import numpy as np

from ..data.gencode import GeneticCode, reverse_complement_ascii

STRAND_PLUS = 1
STRAND_MINUS = -1


@dataclasses.dataclass
class OrfLocation:
    """One putative coding fragment on a contig.

    from_pos/to_pos are contig coordinates as written by extractorfs
    (extractorfs.cpp:92-98): scan coordinates on the plus strand;
    mirrored (L-1-x) on the minus strand so from_pos > to_pos there.
    """
    contig_idx: int
    from_pos: int
    to_pos: int
    has_incomplete_start: bool
    has_incomplete_end: bool
    strand: int


def _stop_mask(seq_upper, stop_codon_codes):
    """Boolean mask over positions p: triple at p is a stop codon."""
    L = len(seq_upper)
    if L < 3:
        return np.zeros(0, dtype=bool)
    tri = (seq_upper[:-2].astype(np.int32) << 16) | \
          (seq_upper[1:-1].astype(np.int32) << 8) | seq_upper[2:].astype(np.int32)
    mask = np.zeros(L - 2, dtype=bool)
    for code in stop_codon_codes:
        mask |= tri == code
    return mask


def _gapn_mask(seq_upper):
    """Codon contains N or a non-IUPAC char (isGapOrN, Orf.cpp:195-199)."""
    from ..data.gencode import REVCOMP_TABLE
    bad = (seq_upper == ord("N")) | (REVCOMP_TABLE[seq_upper] == ord("."))
    L = len(seq_upper)
    if L < 3:
        return np.zeros(0, dtype=bool)
    return bad[:-2] | bad[1:-1] | bad[2:]


def _find_forward(seq_upper, min_len, max_len, max_gaps, stop_codon_codes,
                  stop_codon_strs=None):
    """All fragments on one scanned strand; returns arrays
    (from, to, inc_start, inc_end, close_pos) in frame-interleaved scan order."""
    if stop_codon_strs is not None:
        from .. import native
        nat = native.orf_scan_strand(seq_upper, stop_codon_strs,
                                     min_len, max_len, max_gaps)
        if nat is not None:
            return nat
    L = len(seq_upper)
    stops = _stop_mask(seq_upper, stop_codon_codes)
    gapn = _gapn_mask(seq_upper)

    frs, tos, inc_s, inc_e, close = [], [], [], [], []
    for f in range(3):
        pos = np.arange(f, L - 2, 3)
        if len(pos) == 0:
            continue
        s = stops[pos]
        stop_idx = np.flatnonzero(s)
        # run boundaries in codon-index space: runs between stops and edges
        starts = np.concatenate(([0], stop_idx + 1))
        ends = np.concatenate((stop_idx, [len(pos)]))  # exclusive of stop
        g = np.concatenate(([0], np.cumsum(gapn[pos])))
        for k in range(len(starts)):
            a, b = starts[k], ends[k]
            n_codons = b - a
            if n_codons == 0:
                continue
            ended_by_stop = b < len(pos)
            n_gaps = g[b] - g[a]
            if n_gaps > max_gaps or n_codons > max_len or n_codons < min_len:
                continue
            frm = pos[a]
            to = pos[b - 1] + 2
            frs.append(frm)
            tos.append(to)
            inc_s.append(a == 0)          # no preceding stop in this frame
            inc_e.append(not ended_by_stop)
            close.append(to + 1 if ended_by_stop else to - 2)
    if not frs:
        z = np.zeros(0, dtype=np.int64)
        return z, z, np.zeros(0, bool), np.zeros(0, bool), z
    order = np.argsort(np.asarray(close), kind="stable")
    return (np.asarray(frs)[order], np.asarray(tos)[order],
            np.asarray(inc_s)[order], np.asarray(inc_e)[order],
            np.asarray(close)[order])


class OrfExtractor:
    """Extracts fragments + translated sequences from contigs."""

    def __init__(self, params):
        self.params = params
        self.gencode = GeneticCode(params.translation_table)
        self.stop_codes = [
            (ord(c[0]) << 16) | (ord(c[1]) << 8) | ord(c[2])
            for c in self.gencode.stop_codons
        ]

    def extract_contig(self, contig_ascii, contig_idx=0):
        """Fragments of one contig (both strands), in reference order.

        Returns (locations, nucl_fragments): the fragment nucleotide
        sequences are taken from the scanned strand (already
        reverse-complemented for minus), as Orf::getSequence does.
        """
        seq = np.frombuffer(bytes(contig_ascii), dtype=np.uint8)
        # U->T normalization (Orf::setSequence, Orf.cpp:141-144)
        seq = np.where(seq == ord("U"), np.uint8(ord("T")), seq)
        seq = np.where(seq == ord("u"), np.uint8(ord("t")), seq)
        L = len(seq)
        locs, frags = [], []
        if L < 3:
            return locs, frags
        fwd_upper = seq & np.uint8(~0x20 & 0xFF)
        p = self.params
        rc = np.frombuffer(reverse_complement_ascii(seq.tobytes()), dtype=np.uint8)
        rc_upper = rc & np.uint8(~0x20 & 0xFF)

        for strand, scan_seq, scan_upper in (
                (STRAND_PLUS, seq, fwd_upper), (STRAND_MINUS, rc, rc_upper)):
            frames = p.forward_frames if strand == STRAND_PLUS else p.reverse_frames
            frs, tos, inc_s, inc_e, _ = _find_forward(
                scan_upper, p.orf_min_length, p.orf_max_length,
                p.orf_max_gaps, self.stop_codes,
                stop_codon_strs=self.gencode.stop_codons)
            for i in range(len(frs)):
                if (frs[i] % 3) + 1 not in frames:
                    continue
                has_inc_start = bool(inc_s[i])
                has_inc_end = bool(inc_e[i])
                if p.contig_start_mode < 2 and has_inc_start == bool(p.contig_start_mode):
                    continue
                if p.contig_end_mode < 2 and has_inc_end == bool(p.contig_end_mode):
                    continue
                if strand == STRAND_PLUS:
                    from_pos, to_pos = int(frs[i]), int(tos[i])
                else:
                    from_pos, to_pos = L - 1 - int(frs[i]), L - 1 - int(tos[i])
                locs.append(OrfLocation(contig_idx, from_pos, to_pos,
                                        has_inc_start, has_inc_end, strand))
                frags.append(scan_seq[frs[i]:tos[i] + 1].tobytes())
        return locs, frags

    def translate_fragment(self, nucl_fragment):
        """Fragment nucleotides -> AA bytes (translatenucs equivalent)."""
        return self.gencode.translate_ascii(nucl_fragment)

    def translate_fragments(self, nucl_fragments):
        """Batched translation: one vectorized pass over the concatenated
        fragments (the per-fragment numpy call overhead dominated
        many-fragment contigs)."""
        import numpy as np
        lens = [len(f) for f in nucl_fragments]
        if not lens or any(l % 3 for l in lens):
            return [self.translate_fragment(f) for f in nucl_fragments]
        flat = b"".join(bytes(f) for f in nucl_fragments)
        aa = self.gencode.translate_ascii(flat)
        out = []
        off = 0
        for l in lens:
            out.append(aa[off:off + l // 3])
            off += l // 3
        return out


def orf_header_fields(loc):
    """(from, signed_len) pair as encoded in the ORF header
    (Orf::writeOrfHeader, Orf.cpp:440-457)."""
    length = abs(loc.from_pos - loc.to_pos)
    plus = loc.from_pos < loc.to_pos
    return loc.from_pos, (length if plus else -length)
