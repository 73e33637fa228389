"""Long-frame contigs, and tests/golden/long_slice.json.

MetaEuk keeps open reading frames up to orf_max_length = 32734 codons, so a
fragment can fall in the 16384 and 65536 length tiers, where the align
driver routes it to the row-tiled query-major kernels. The synthetic
metagenomes of tools/make_metagenome.py hold no such fragment (their
longest is a few hundred aa). long_frame_contigs() plants them: each
contig carries one stop-free exon of a chosen length that holds mutated
copies of implanted targets, separated by stop-free linkers, between two
stop codons. long_slice() appends such contigs to make_metagenome()'s.

Run as a script, it writes the sha256 of the four outputs of metaeuk_tpu's
EasyPredict on the CPU, in k-mer mode and in ungapped mode, on GOLDEN_INPUT
(make_metagenome(0.01, 500) plus two frames in the 16384 tier and two in
the 65536 tier):

    python3 tests/golden/make_long_slice.py > tests/golden/long_slice.json

metaeuk_tpu_torch's easy-predict must give the same digests (chip_smoke.py
holds the port to them on the card).
"""

import hashlib
import json
import pathlib
import sys
import tempfile

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from tools.make_metagenome import (AA, _rand_dna, _revcomp,  # noqa: E402
                                   _to_cds, make_metagenome)

SUFFIXES = ("fas", "codon.fas", "headersMap.tsv", "gff")
COMMAND = "python3 tests/golden/make_long_slice.py"
# make_metagenome's share of implanted targets (the first 30% of the pool)
IMPLANT_SHARE = 0.3
# the golden: the ungapped golden's metagenome plus four long frames
GOLDEN_INPUT = dict(mbp=0.01, targets=500, seed=20260820,
                    frame_lengths=[4300, 6100, 16500, 17300],
                    max_implants=4, frame_seed=20260823)
# the card's slice (chip_smoke.py phase 5c): the 0.4 Mbp ungapped slice
# plus 32 frames of 4,200-16,000 aa and 16 of 16,400-32,700 aa
CHIP_SLICE = dict(mbp=0.4, targets=3000, seed=20260820, n_mid=32,
                  mid=(4200, 16000), n_long=16, long=(16400, 32700),
                  max_implants=40, frame_seed=20260824)


def _aa_codes(seq):
    """AA bytes -> indices into tools.make_metagenome.AA."""
    lut = np.zeros(256, np.int64)
    lut[AA] = np.arange(len(AA))
    return lut[np.frombuffer(seq, np.uint8)]


def long_frame_contigs(proteins, lengths, seed, max_implants=40,
                       prefix="long"):
    """One contig per entry of `lengths`: a frame of exactly that many aa,
    without a stop codon, between a TAA and a TGA, with 100-400 random nt
    on each side; half are reverse-complemented. The frame holds up to
    max_implants (at least 4) copies of implanted targets of `proteins`
    (make_metagenome's pool, the first 30% implanted) with 2-12% of their
    residues mutated, each followed by a linker of 20-200 random aa; a last
    linker fills the frame to its length. Codons come from
    make_metagenome's stop-free tables, every 250th one a Leu coded TTA.
    Returns [(name, bytes)]."""
    rng = np.random.default_rng(seed)
    n_implant = max(1, int(len(proteins) * IMPLANT_SHARE))
    pool = [_aa_codes(proteins[i][1]) for i in range(n_implant)]
    contigs = []
    for k, L in enumerate(lengths):
        parts, used = [], 0
        while len(parts) < 2 * max_implants:
            prot = pool[int(rng.integers(0, n_implant))].copy()
            n_mut = max(1, int(len(prot) * rng.uniform(0.02, 0.12)))
            pos = rng.choice(len(prot), n_mut, replace=False)
            prot[pos] = rng.integers(0, 20, n_mut)
            linker = rng.integers(0, 20, int(rng.integers(20, 201)))
            if used + len(prot) + len(linker) > L:
                break
            parts += [prot, linker]
            used += len(prot) + len(linker)
        if len(parts) < 8:
            raise ValueError(f"a {L}-aa frame holds fewer than 4 implants")
        frame = np.concatenate([*parts, rng.integers(0, 20, L - used)])
        cds = _to_cds(rng, frame)
        # make_metagenome's codons never read as a stop on the antisense
        # strand either; every 250th codon becomes a Leu coded TTA (TAA on
        # the antisense strand), which keeps the antisense frame short
        cds.reshape(-1, 3)[::250] = np.frombuffer(b"TTA", np.uint8)
        dna = np.concatenate([
            _rand_dna(rng, int(rng.integers(100, 401))),
            np.frombuffer(b"TAA", np.uint8), cds,
            np.frombuffer(b"TGA", np.uint8),
            _rand_dna(rng, int(rng.integers(100, 401)))])
        if rng.random() < 0.5:
            dna = _revcomp(dna)
        contigs.append((f"{prefix}{k}", dna.tobytes()))
    return contigs


def chip_slice_lengths(cfg=CHIP_SLICE):
    """The frame lengths of CHIP_SLICE, drawn from its frame seed."""
    rng = np.random.default_rng(cfg["frame_seed"])
    return [int(x) for x in np.concatenate([
        rng.integers(cfg["mid"][0], cfg["mid"][1] + 1, cfg["n_mid"]),
        rng.integers(cfg["long"][0], cfg["long"][1] + 1, cfg["n_long"])])]


def long_slice(cfg):
    """(contigs, proteins): make_metagenome(cfg's mbp, targets, seed) with
    the long-frame contigs of cfg appended (cfg is GOLDEN_INPUT or
    CHIP_SLICE)."""
    contigs, proteins = make_metagenome(cfg["mbp"], cfg["targets"],
                                        cfg["seed"])
    lengths = cfg.get("frame_lengths") or chip_slice_lengths(cfg)
    return contigs + long_frame_contigs(proteins, lengths, cfg["frame_seed"],
                                        cfg["max_implants"]), proteins


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from metaeuk_tpu.params import Params
    from metaeuk_tpu.pipeline.predict import EasyPredict
    from tools.make_metagenome import write_fasta

    out = {"command": COMMAND, "input": GOLDEN_INPUT}
    with tempfile.TemporaryDirectory() as td:
        td = pathlib.Path(td)
        contigs, proteins = long_slice(GOLDEN_INPUT)
        write_fasta(td / "c.fna", contigs)
        write_fasta(td / "p.faa", proteins)
        for mode in ("kmer", "ungapped"):
            EasyPredict(Params(prefilter_mode=mode)).run(
                str(td / "c.fna"), str(td / "p.faa"), str(td / mode))
            out[mode] = {"sha256": {
                s: hashlib.sha256(pathlib.Path(f"{td / mode}.{s}")
                                  .read_bytes()).hexdigest()
                for s in SUFFIXES}}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
