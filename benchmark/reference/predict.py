"""MetaEuk's gene prediction around the alignment, as plain NumPy: the
reference for the fragments, the exon sets and the written predictions.

- fragments: Orf::findAll in ANY_TO_STOP mode (MetaEuk's setting,
  PredictExons.cpp:9): runs of at least min_codons non-stop codons between
  stops in the three frames of each strand, in order of their closing
  position, the plus strand first; translated with the standard code.
- exon sets: collectoptimalset.cpp (one optimal set per contig, target and
  strand): PotentialExon::setByAln coordinates, the chaining DP with its
  intron window, target-overlap penalty and log2 bonus, the target
  coverage gate and the combined E-value 2^(log2(DB residues) + 1 - S).
- reduceredundancy.cpp: exon-sharing clusters and same-strand overlap
  exclusion.
- unitesetstofasta.cpp at its defaults: header, trimmed exons, the four
  output files' records.
"""

import math

import numpy as np

PLUS, MINUS = 1, -1
_CODE = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
_BASE = np.full(256, 255, np.int64)
for _i, _b in enumerate(b"TCAG"):
    _BASE[_b] = _i
_AA = np.frombuffer(_CODE.encode(), np.uint8)
_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTacgt", b"TGCAtgca"):
    _COMP[_a] = _b


class Params:
    """MetaEuk's defaults that these stages read."""
    min_codons = 15
    max_codons = 32734
    min_exon_aa = 11
    min_intron = 15
    max_intron = 10000
    max_aa_overlap = 10
    gap_open = -1
    gap_extend = -1
    tcov = 0.5
    metaeuk_evalue = 0.001


def revcomp(seq):
    return _COMP[np.frombuffer(bytes(seq), np.uint8)[::-1]].tobytes()


def translate(nucl):
    a = np.frombuffer(bytes(nucl), np.uint8)
    c = _BASE[a[:len(a) // 3 * 3].reshape(-1, 3)]
    return _AA[16 * c[:, 0] + 4 * c[:, 1] + c[:, 2]].tobytes()


def _strand_runs(seq, p):
    """(from, to) of each fragment on one scanned strand, in closing order."""
    s = np.frombuffer(seq, np.uint8)
    L = len(s)
    if L < 3:
        return []
    tri = (s[:-2].astype(np.int64) << 16) | (s[1:-1].astype(np.int64) << 8) \
        | s[2:]
    stop = np.zeros(L - 2, bool)
    for c in (b"TAA", b"TAG", b"TGA"):
        stop |= tri == ((c[0] << 16) | (c[1] << 8) | c[2])
    runs = []
    for f in range(3):
        pos = np.arange(f, L - 2, 3)
        if not len(pos):
            continue
        si = np.flatnonzero(stop[pos])
        starts = np.concatenate(([0], si + 1))
        ends = np.concatenate((si, [len(pos)]))
        for a, b in zip(starts, ends):
            n = b - a
            if n == 0 or n < p.min_codons or n > p.max_codons:
                continue
            to = pos[b - 1] + 2
            close = to + 1 if b < len(pos) else to - 2
            runs.append((close, f, len(runs), int(pos[a]), int(to)))
    runs.sort(key=lambda r: (r[0], r[1], r[2]))
    return [(r[3], r[4]) for r in runs]


def fragments(contig, p=Params):
    """[(from_pos, to_pos, AA bytes)] of one contig: plus strand first;
    from > to on the minus strand (extractorfs' mirrored coordinates)."""
    L = len(contig)
    out = []
    for fr, to in _strand_runs(contig, p):
        out.append((fr, to, translate(contig[fr:to + 1])))
    rc = revcomp(contig)
    for fr, to in _strand_runs(rc, p):
        out.append((L - 1 - fr, L - 1 - to, translate(rc[fr:to + 1])))
    return out


def _chain(cs, ce, ts, te, bit, aa, tlen, p):
    """collectoptimalset's DP over candidates sorted by contig start:
    (best score, exon indices of its path)."""
    n = len(cs)
    prev_id = np.arange(n)
    score = bit.astype(np.int64).copy()
    nex = np.ones(n, np.int64)
    paa = aa.astype(np.int64).copy()
    best, last = 0, 0
    for c in range(n):
        for q in range(c):
            if ce[c] < ce[q]:
                continue
            gap = cs[c] - ce[q] - 1
            if gap < p.min_intron or gap > p.max_intron:
                continue
            d = ts[c] - te[q] - 1
            over = -d if d < 0 else 0
            if over > p.max_aa_overlap or ts[c] < ts[q]:
                continue
            if d < 0:
                cost = p.gap_open + p.gap_extend * (-d - 1)
            elif d <= 1:
                cost = 0
            else:
                cost = p.gap_open + p.gap_extend * (d - 1)
            k = nex[q] + 1
            cand = score[q] + cost + int(bit[c]) + int(math.log2(k))
            if cand > score[c]:
                prev_id[c], score[c], nex[c] = q, cand, k
                paa[c] = paa[q] + aa[c] - over
        if float(paa[c]) / float(tlen) >= p.tcov and score[c] > best:
            best, last = int(score[c]), c
    if best == 0:
        return 0, []
    path = [last]
    while prev_id[path[-1]] != path[-1]:
        path.append(int(prev_id[path[-1]]))
    return best, path[::-1]


def exon_sets(frags, h, db_res, p=Params):
    """Predictions of one contig from its fragments and its hit table h
    (hits.hit_table columns, q indexing frags): [dict], in
    collectoptimalset's order (target asc, plus before minus)."""
    fb = np.array([frags[q][0] for q in h["q"]], np.int64)
    tb = np.array([frags[q][1] for q in h["q"]], np.int64)
    plus = fb < tb
    qs3, qe3 = h["q_start"] * 3, h["q_end"] * 3
    cs = np.where(plus, fb + qs3, -(fb - qs3))
    ce = np.where(plus, fb + qe3 + 2, -(fb - qe3 - 2))
    nl = ce - cs + 1
    aa = nl // 3
    keep = np.flatnonzero(aa >= p.min_exon_aa)
    log2_m = math.log2(db_res)
    preds = []
    groups = {}
    for j in keep:
        groups.setdefault((int(h["t"][j]), 0 if plus[j] else 1), []).append(j)
    for (t, sk) in sorted(groups):
        g = np.array(sorted(groups[(t, sk)], key=lambda j: int(h["q"][j])))
        g = g[np.lexsort((np.arange(len(g)), ce[g], cs[g]))]
        best, path = _chain(cs[g], ce[g], h["t_start"][g], h["t_end"][g],
                            h["bits"][g], aa[g], int(h["t_len"][g[0]]), p)
        if best == 0:
            continue
        ev = math.pow(2.0, log2_m + 1.0 - best)
        if ev > p.metaeuk_evalue:
            continue
        ex = [dict(key=int(h["q"][j]), bits=int(h["bits"][j]),
                   cs=int(cs[j]), ce=int(ce[j]), nl=int(nl[j]),
                   ts=int(h["t_start"][j]), te=int(h["t_end"][j]),
                   from_pos=int(fb[j]), to_pos=int(tb[j])) for j in g[path]]
        strand = PLUS if sk == 0 else MINUS
        if strand == PLUS:
            low, high = ex[0]["cs"], ex[-1]["ce"]
        else:
            low, high = -ex[-1]["ce"], -ex[0]["cs"]
        preds.append(dict(t=t, strand=strand, score=best,
                          evalue=float("%.3E" % ev), exons=ex, low=low,
                          high=high))
    return preds


def _cluster(preds):
    preds = sorted(preds, key=lambda r: (r["low"], -r["high"], -r["score"],
                                         r["t"]))
    done = [False] * len(preds)
    reps = []
    for i in range(len(preds)):
        if done[i]:
            continue
        fid, flow, top = preds[i]["t"], preds[i]["low"], preds[i]["score"]
        done[i] = True
        members = [i]
        keys = {e["key"] for e in preds[i]["exons"]}
        for j in range(i + 1, len(preds)):
            if preds[j]["low"] >= preds[i]["high"]:
                break
            if not done[j] and any(e["key"] in keys for e in preds[j]["exons"]):
                done[j] = True
                if preds[j]["score"] > top:
                    fid, flow, top = preds[j]["t"], preds[j]["low"], \
                        preds[j]["score"]
                members.append(j)
        for k in members:
            if preds[k]["t"] == fid and preds[k]["low"] == flow:
                reps.append(preds[k])
    return reps


def _exclude_overlaps(reps):
    reps.sort(key=lambda r: (r["evalue"], r["low"]))
    taken = [False] * len(reps)
    for i in range(len(reps)):
        if taken[i]:
            continue
        taken[i] = True
        reps[i]["keep"] = True
        hi_i, lo_i = reps[i]["high"], reps[i]["low"]
        for j in range(i + 1, len(reps)):
            hi_j, lo_j = reps[j]["high"], reps[j]["low"]
            if ((lo_i < hi_j < hi_i) or (lo_i < lo_j < hi_i)
                    or (hi_j < hi_i and lo_j > lo_i)
                    or (hi_j > hi_i and lo_j < lo_i)):
                taken[j] = True
                # suppressed, unless by a set of its own target
                reps[j]["keep"] = reps[i]["t"] == reps[j]["t"]


def reduce(preds):
    """reduceredundancy's kept representatives, by (target, strand)."""
    out = []
    for s in (PLUS, MINUS):
        reps = _cluster([r for r in preds if r["strand"] == s])
        _exclude_overlaps(reps)
        out += reps
    out.sort(key=lambda r: (r["t"], r["strand"]))
    return [r for r in out if r["keep"]]


def records(reps, contig_key, contig_acc, contig, t_acc):
    """The contig's records of the four files, in write order: lists of
    (fas, codon.fas, headersMap.tsv, gff) strings."""
    buf = np.frombuffer(contig, np.uint8)
    out = ([], [], [], [])
    i = 0
    while i < len(reps):
        j = i
        while j < len(reps) and (reps[j]["t"], reps[j]["low"]) == \
                (reps[i]["t"], reps[i]["low"]):
            j += 1
        grp = reps[i:j]
        for r in [g for g in grp if g["strand"] == PLUS] + \
                [g for g in grp if g["strand"] != PLUS]:
            _write(out, r, contig_key, contig_acc, buf, t_acc[r["t"]])
        i = j
    return out


def _write(out, r, contig_key, contig_acc, buf, tacc):
    plus = r["strand"] == PLUS
    parts = [f"{tacc}|{contig_acc}|{'+' if plus else '-'}|{r['score']}|"
             f"{'%g' % r['evalue']}|{len(r['exons'])}|{r['low']}|{r['high']}"]
    seq = []
    last_t = -1
    adj = []
    for e in r["exons"]:
        a_start, a_len = e["cs"], e["nl"]
        if last_t >= e["ts"]:
            d = last_t - e["ts"] + 1
            a_start += 3 * d
            a_len -= 3 * d
        adj.append(a_start)
        low = a_start if plus else -e["ce"]
        seg = buf[low:low + a_len].tobytes()
        last_t = e["te"]
        parts.append(f"|{abs(e['cs'])}[{abs(a_start)}]:{abs(e['ce'])}"
                     f"[{abs(e['ce'])}]:{e['nl']}[{a_len}]")
        seq.append(seg if plus else revcomp(seg))
    header = "".join(parts)
    nucl = b"".join(seq)
    out[0].append(f">{header}\n{translate(nucl).decode()}\n")
    out[1].append(f">{header}\n{nucl.decode()}\n")
    span = r["high"] - r["low"] + 1
    coord = f"{r['low']}+{span}" if plus else f"{r['high']}-{span}"
    out[2].append(f"{contig_key}\t{coord}\t0\t{r['t']}\t{r['strand']}\t"
                  f"{header}\n")
    st = "+" if plus else "-"
    tcs = f"{tacc}|{contig_acc}|{st}|{r['low']}"
    g = []
    for level in ("gene", "mRNA"):
        attr = (f"TCS_ID={tcs}" if level == "gene"
                else f"TCS_ID={tcs}_mRNA;Parent={tcs}")
        g.append(f"{contig_acc}\tMetaEuk\t{level}\t{r['low'] + 1}\t"
                 f"{r['high'] + 1}\t{r['score']}\t{st}\t.\t"
                 f"Target_ID={tacc};{attr}\n")
    for k, (e, a_start) in enumerate(zip(r["exons"], adj)):
        s, a, en = abs(e["cs"]) + 1, abs(a_start) + 1, abs(e["ce"]) + 1
        for level, x in (("exon", s), ("CDS", a)):
            lo, hi = (x, en) if plus else (en, x)
            attr = (f"TCS_ID={tcs}_exon_{k};Parent={tcs}_mRNA"
                    if level == "exon" else
                    f"TCS_ID={tcs}_CDS_{k};Parent={tcs}_exon_{k}")
            g.append(f"{contig_acc}\tMetaEuk\t{level}\t{lo}\t{hi}\t"
                     f"{e['bits']}\t{st}\t.\tTarget_ID={tacc};{attr}\n")
    out[3].extend(g)
