"""The benchmark's one traffic generator: the target DB from the seed, each
job's contigs or queries from (seed, job index), by the parameters of a
configuration file (the DB) and a workload file (the jobs).

The sequence models are frozen copies of the repository's generators, so a
later change there cannot move the yardstick:

- make_metagenome, _to_cds, _intron, _revcomp, _mutate_dna: copied from
  tools/make_metagenome.py (contigs of multi-exon genes implanted on both
  strands; a protein DB of implanted genes, mutated family members and
  decoys). make_metagenome is kept whole for the CPU tests, which hold the
  reference to the goldens made from it.
- mutate: copied from tests/golden/make_search_slice.py (substitutions and
  indels of 1-5 residues), its new residues drawn by the DB's composition.

make_metagenome draws the DB and the contigs from one stream. Here they are
split: targets() draws the DB from the seed alone, and job inputs from
(seed, job) alone, each in bulk. Every seed gets the same sizes (target,
contig and query lengths) in another order, so that seeds change which
sequences a job holds and not how much work it is.

The DB keeps the shapes of a protein reference DB, which the configuration
states: target lengths log-normal at a given mean and sigma (stratified
quantiles, so every seed has the same multiset), residues drawn from a
given composition (BLOSUM62's background frequencies). The same
composition draws the decoys, the substitutions and the insertions.
"""

from statistics import NormalDist

import numpy as np

AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
DNA = np.frombuffer(b"ACGT", np.uint8)

CODON1 = {
    "A": "GCT", "C": "TGT", "D": "GAT", "E": "GAA", "F": "TTT",
    "G": "GGT", "H": "CAT", "I": "ATT", "K": "AAA", "L": "CTT",
    "M": "ATG", "N": "AAT", "P": "CCT", "Q": "CAA", "R": "CGT",
    "S": "TCT", "T": "ACT", "V": "GTT", "W": "TGG", "Y": "TAT",
}
CODON2 = {
    "A": "GCC", "C": "TGC", "D": "GAC", "E": "GAG", "F": "TTC",
    "G": "GGA", "H": "CAC", "I": "ATC", "K": "AAG", "L": "CTG",
    "M": "ATG", "N": "AAC", "P": "CCA", "Q": "CAG", "R": "AGA",
    "S": "AGC", "T": "ACC", "V": "GTG", "W": "TGG", "Y": "TAC",
}
_C1 = np.zeros((20, 3), np.uint8)
_C2 = np.zeros((20, 3), np.uint8)
for _i, _a in enumerate("ACDEFGHIKLMNPQRSTVWY"):
    _C1[_i] = np.frombuffer(CODON1[_a].encode(), np.uint8)
    _C2[_i] = np.frombuffer(CODON2[_a].encode(), np.uint8)
_STOPS = (b"TAA", b"TAG", b"TGA")


def rng_for(seed, *stream):
    """A generator for (seed, stream...): seeds of any size, streams apart."""
    return np.random.default_rng(
        [int(seed) % (1 << 64), *(int(s) for s in stream)])


def _rand_prot(rng, n):
    return rng.integers(0, 20, n)


def _to_cds(rng, prot_idx):
    pick = rng.integers(0, 2, len(prot_idx))[:, None]
    return np.where(pick == 0, _C1[prot_idx], _C2[prot_idx]).reshape(-1)


def _rand_dna(rng, n):
    return DNA[rng.integers(0, 4, n)]


def _intron(rng, n):
    body = _rand_dna(rng, n)
    stops = np.frombuffer(b"TAGCTAATGA", np.uint8)
    return np.concatenate([np.frombuffer(b"GT", np.uint8), body[:n // 2],
                           stops, body[n // 2:],
                           np.frombuffer(b"AG", np.uint8)])


def _revcomp(s):
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    return comp[s][::-1]


def _mutate_dna(rng, cds, rate):
    cds = cds.copy()
    n_mut = int(len(cds) * rate)
    if n_mut:
        pos = rng.choice(len(cds), n_mut, replace=False)
        cds[pos] = DNA[rng.integers(0, 4, n_mut)]
    return cds


def _gene(rng, prot, dna_mut):
    """One implanted gene: 1-3 exons of prot with introns, a stop before
    and after, on a random strand (make_metagenome's inner loop; one exon
    where prot is too short to cut, which make_metagenome's proteins of 120
    aa or more never are)."""
    n_ex = int(rng.integers(1, 4))
    if len(prot) - 40 < n_ex - 1:
        n_ex = 1    # too short for a cut 20 residues from either end
    cuts = np.sort(rng.choice(
        np.arange(20, len(prot) - 20), n_ex - 1,
        replace=False)) if n_ex > 1 else np.zeros(0, np.int64)
    bounds = [0, *cuts.tolist(), len(prot)]
    seg = []
    for e in range(n_ex):
        cds = _to_cds(rng, prot[bounds[e]:bounds[e + 1]])
        cds = _mutate_dna(rng, cds, rng.uniform(*dna_mut))
        seg.append(cds)
        if e + 1 < n_ex:
            seg.append(_intron(rng, int(rng.integers(40, 400))))
    stop = np.frombuffer(_STOPS[int(rng.integers(0, 3))], np.uint8)
    gene = np.concatenate([np.frombuffer(b"TAA", np.uint8), *seg, stop])
    if rng.random() < 0.5:
        gene = _revcomp(gene)
    return gene


def make_metagenome(n_mbp=8.0, n_targets=8000, seed=20260820,
                    gene_density=0.55):
    """Returns (contigs, proteins): lists of (name, bytes). A verbatim copy
    of tools/make_metagenome.py's, for the CPU tests' goldens."""
    rng = np.random.default_rng(seed)
    total_nt = int(n_mbp * 1e6)
    n_implant = max(1, int(n_targets * 0.3))
    n_family = int(n_targets * 0.2)
    prots = []
    for i in range(n_targets):
        if i < n_implant:
            L = int(rng.integers(120, 500))
        else:
            L = int(rng.integers(60, 600))
        prots.append(_rand_prot(rng, L))
    for i in range(n_family):
        src = prots[int(rng.integers(0, n_implant))]
        p = src.copy()
        n_mut = max(1, int(len(p) * rng.uniform(0.1, 0.4)))
        pos = rng.choice(len(p), n_mut, replace=False)
        p[pos] = rng.integers(0, 20, n_mut)
        prots[n_implant + i] = p
    contigs = []
    nt_done = 0
    ci = 0
    while nt_done < total_nt:
        clen_target = int(rng.integers(2000, 20000))
        parts = [_rand_dna(rng, int(rng.integers(60, 300)))]
        used = len(parts[0])
        while used < clen_target * gene_density:
            pi = int(rng.integers(0, n_implant))
            parts.append(_gene(rng, prots[pi], (0.02, 0.12)))
            parts.append(_rand_dna(rng, int(rng.integers(50, 400))))
            used += len(parts[-2]) + len(parts[-1])
        seq = np.concatenate(parts)
        contigs.append((f"ctg{ci}", seq.tobytes()))
        nt_done += len(seq)
        ci += 1
    proteins = [(f"prot{i}", AA[p].tobytes()) for i, p in enumerate(prots)]
    return contigs, proteins


def residues(rng, n, cdf):
    """n residue codes 0-19 by the cumulative composition cdf
    (composition_cdf)."""
    return np.minimum(np.searchsorted(cdf, rng.random(n), side="right"), 19)


def composition_cdf(freqs):
    """The cumulative of 20 residue frequencies (ACDEFGHIKLMNPQRSTVWY),
    normalised to 1."""
    f = np.asarray(freqs, np.float64)
    return np.cumsum(f / f.sum())


def lognormal_lengths(n, mean, sigma):
    """n lengths at the stratified quantiles (k + 0.5) / n of a log-normal
    of the given mean and sigma (of the log), rounded, ascending: the same
    multiset for every seed."""
    mu = np.log(mean) - sigma * sigma / 2
    nd = NormalDist()
    z = np.array([nd.inv_cdf((k + 0.5) / n) for k in range(n)])
    return np.maximum(np.rint(np.exp(mu + sigma * z)), 1).astype(np.int64)


def mutate(rng, seq, identity, indel_rate, indel_max, cdf):
    """seq (codes 0-19) with each residue substituted with probability
    1 - identity, and after each residue, with probability indel_rate, an
    insertion of 1-indel_max random residues or a deletion of as many; the
    new residues drawn by cdf."""
    sub = rng.random(len(seq)) >= identity
    out = np.where(sub, residues(rng, len(seq), cdf), seq)
    pieces, i = [], 0
    events = np.flatnonzero(rng.random(len(seq)) < indel_rate)
    skip_to = 0
    for e in events:
        if e < skip_to:
            continue
        n = int(rng.integers(1, indel_max + 1))
        pieces.append(out[i:e + 1])
        if rng.random() < 0.5:
            pieces.append(residues(rng, n, cdf))
            i = e + 1
        else:
            i = skip_to = e + 1 + n
    pieces.append(out[i:])
    return np.concatenate(pieces)


class TargetDB:
    """The configuration's protein DB as codes 0-19: flat residues, offsets,
    how many of the first entries are implanted genes, and the cumulative
    composition its residues were drawn by."""

    def __init__(self, codes, offsets, n_implant, cdf):
        self.codes = codes
        self.offsets = offsets
        self.n_implant = n_implant
        self.cdf = cdf

    def __len__(self):
        return len(self.offsets) - 1

    def seq(self, i):
        return self.codes[self.offsets[i]:self.offsets[i + 1]]

    @property
    def lengths(self):
        return np.diff(self.offsets)


def targets(seed, cfg):
    """The DB of a configuration from the seed, in bulk: cfg["n_targets"]
    proteins of the shapes in cfg["target_db"]: lengths log-normal
    ("length": mean, sigma), residues by "composition"; the first share
    "implanted" of them the genes that contigs carry, the next share
    "family" copies of random implanted genes with a share "family_mut" of
    their residues redrawn, the rest unrelated."""
    db = cfg["target_db"]
    rng = rng_for(seed, 0)
    n = int(cfg["n_targets"])
    cdf = composition_cdf(db["composition"])
    n_implant = max(1, int(n * db["implanted"]))
    n_family = int(n * db["family"])
    lens = rng.permutation(lognormal_lengths(n, db["length"]["mean"],
                                             db["length"]["sigma"]))
    src = rng.integers(0, n_implant, n_family)
    fam = slice(n_implant, n_implant + n_family)
    lens[fam] = lens[src]
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    codes = residues(rng, int(offsets[-1]), cdf).astype(np.uint8)
    # family members: copy the source gene, then redraw a share of it
    f_off = offsets[n_implant:n_implant + n_family]
    idx = np.concatenate([np.arange(offsets[s], offsets[s + 1]) for s in src]) \
        if n_family else np.zeros(0, np.int64)
    dst = np.concatenate([np.arange(o, o + lens[s]) for o, s in
                          zip(f_off, src)]) if n_family else idx
    codes[dst] = codes[idx]
    share = np.repeat(rng.uniform(*db["family_mut"], n_family), lens[src])
    hit = rng.random(len(dst)) < share
    codes[dst[hit]] = residues(rng, int(hit.sum()), cdf)
    return TargetDB(codes, offsets, n_implant, cdf)


def write_fasta(path, names, seqs):
    with open(path, "wb") as f:
        f.write(b"".join(b">" + n.encode() + b"\n" + s + b"\n"
                         for n, s in zip(names, seqs)))


def write_targets(path, tdb):
    aa = AA[tdb.codes].tobytes()
    o = tdb.offsets
    write_fasta(path, [f"prot{i}" for i in range(len(tdb))],
                [aa[o[i]:o[i + 1]] for i in range(len(tdb))])


def stratified(lo, hi, n):
    """n lengths spread evenly over [lo, hi): the same set for every seed."""
    return (lo + (hi - lo) * (np.arange(n) + 0.5) / n).astype(np.int64)


def contigs(seed, job, tdb, w):
    """A job of w["contigs"] contigs ([(name, bytes)]): lengths stratified
    over w["contig_len"], each filled with implanted genes up to
    w["gene_density"] of its length, then random DNA to its length."""
    rng = rng_for(seed, 1, job)
    lens = rng.permutation(stratified(*w["contig_len"], w["contigs"]))
    out = []
    for ci, clen in enumerate(lens):
        parts = [_rand_dna(rng, int(rng.integers(60, 300)))]
        used = len(parts[0])
        while used < clen * w["gene_density"]:
            prot = tdb.seq(int(rng.integers(0, tdb.n_implant)))
            gene = _gene(rng, prot, w["dna_mut"])
            if used + len(gene) > clen:
                break
            parts += [gene, _rand_dna(rng, int(rng.integers(50, 400)))]
            used += len(gene) + len(parts[-1])
        seq = np.concatenate(parts)[:clen]
        if len(seq) < clen:
            seq = np.concatenate([seq, _rand_dna(rng, clen - len(seq))])
        out.append((f"j{job}c{ci}", seq.tobytes()))
    return out


def by_length(rng, lens, n, max_len):
    """n indices of lens, one drawn from each of n strata of the entries
    no longer than max_len in length order, in random order: about the
    same lengths for every seed."""
    ok = np.flatnonzero(lens <= max_len)
    ok = ok[np.argsort(lens[ok], kind="stable")]
    edges = (np.arange(n + 1) * len(ok)) // n
    pick = edges[:-1] + (rng.random(n) * np.diff(edges)).astype(np.int64)
    return rng.permutation(ok[pick])


def queries(seed, job, tdb, w):
    """A job of protein queries ([(name, bytes)]) by w["kind"]:

    - "homologs": w["queries"] queries, a share w["homolog"] of them
      mutated copies of DB targets at w["identities"] in even shares
      (indels at w["indel_rate"], 1-w["indel_max"] long), the targets drawn
      across the DB's lengths up to w["max_len"] (by_length) and each copy
      cut to w["max_len"]; the rest decoys of random residues, their
      lengths those of as many more such targets;
    - "chained": w["queries"] queries of lengths stratified over
      w["query_len"], a share w["homolog"] of them mutated DB targets
      chained end to end and cut to the length, the rest random residues
      of the same lengths."""
    rng = rng_for(seed, 2, job)
    cdf = tdb.cdf
    n = int(w["queries"])
    n_hom = int(round(n * w["homolog"]))
    ids = w["identities"]
    pid = np.array([ids[k % len(ids)] for k in range(n_hom)])
    out = []
    if w["kind"] == "homologs":
        src = by_length(rng, tdb.lengths, n_hom, w["max_len"])
        lens = np.zeros(n, np.int64)
        lens[n_hom:] = tdb.lengths[by_length(rng, tdb.lengths, n - n_hom,
                                             w["max_len"])]
    else:
        lens = rng.permutation(stratified(*w["query_len"], n))
    for k in range(n):
        if k < n_hom:
            if w["kind"] == "homologs":
                t = int(src[k])
                q = mutate(rng, tdb.seq(t), pid[k], w["indel_rate"],
                           w["indel_max"], cdf)[:w["max_len"]]
            else:
                parts, total = [], 0
                while total < lens[k]:
                    t = int(rng.integers(0, len(tdb)))
                    parts.append(mutate(rng, tdb.seq(t), pid[k],
                                        w["indel_rate"], w["indel_max"],
                                        cdf))
                    total += len(parts[-1])
                q = np.concatenate(parts)[:lens[k]]
            name = f"j{job}q{k}_t{t}_{round(pid[k] * 100)}"
        else:
            q = residues(rng, int(lens[k]), cdf)
            name = f"j{job}decoy{k}"
        out.append((name, AA[q].tobytes()))
    order = rng.permutation(n)
    return [out[i] for i in order]
