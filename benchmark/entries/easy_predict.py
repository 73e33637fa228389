"""MetaEuk `easy-predict` with the ungapped prefilter, through the port's
CLI (cmd_easy_predict, EasyPredict.run): contigs as FASTA, the target DB
createdb'd once in set-up.

Spans: prefilter (UngappedPrefilter.candidate_pairs), align
(SearchDriver.search). Captured: the fragments given to the prefilter, its
candidate pairs, the aligner's hits, and EasyPredict's stage seconds.

The comparison, on contigs drawn from the seed out of the window's jobs:
each contig's fragments, their ordered candidate lists, their hits, and
the contig's records in the four output files, against the reference.
"""

import numpy as np

from .. import gen
from ..reference import gapless, hits, scoring, sw
from ..reference import predict as rp
from . import common

OUTPUTS = ("fas", "codon.fas", "headersMap.tsv", "gff")
# StageTimer stages outside the prefilter and the aligner
HOST_STAGES = ("load contigs+targets", "extractorfs+translate",
               "collectoptimalset", "reduceredundancy+write")


def setup(ctx):
    common.setup_db(ctx)
    from metaeuk_tpu_torch.pipeline import predict
    from metaeuk_tpu_torch.search import driver, prefilter
    rec = ctx.rec
    rec.wrap(prefilter.UngappedPrefilter, "candidate_pairs", "prefilter",
             keep=lambda a, out: (list(a[1]), out))
    rec.wrap(driver.SearchDriver, "search", "align",
             keep=lambda a, out: out)
    rec.wrap(predict.EasyPredict, "run", "run",
             keep=lambda a, out: dict(a[0].stage_seconds,
                                      **a[0].predict_stage_seconds))


def make_job(ctx, job, cut=None):
    cs = gen.contigs(ctx.seed, job, ctx.tdb, ctx.wl)
    if cut:
        cs = cs[:cut]
    d = ctx.workdir / f"job{job}"
    d.mkdir()
    gen.write_fasta(d / "contigs.fna", [n for n, _ in cs], [s for _, s in cs])
    return dict(dir=d, contigs=cs, work=sum(len(s) for _, s in cs) / 1e6)


def run_job(ctx, job):
    d = job["dir"]
    common.cli(["easy-predict", str(d / "contigs.fna"), str(ctx.db),
                str(d / "pred"), *common.flags(ctx.cfg), "--device", ctx.device])


def host_stage_s(ctx, j):
    st = ctx.rec.captured[j]["run"][0]
    return sum(st.get(k, 0.0) for k in HOST_STAGES)


def sample(ctx, done):
    """(job, contig) pairs to check: one contig drawn from the seed in each
    of the window's first and last completed jobs (state gone stale across
    jobs shows in the last; a contig at any place in a job's batch can be
    drawn)."""
    rng = gen.rng_for(ctx.seed, 3)
    jobs = sorted({done[0], done[-1]})
    return [(j, int(rng.integers(len(ctx.jobs[j]["contigs"])))) for j in jobs]


def _fragments(ctx, j):
    """The reference's fragments of every contig of job j, and each
    contig's offset in the job's fragment list."""
    key = ("frags", j)
    if key not in ctx.cache:
        fr = [rp.fragments(s) for _, s in ctx.jobs[j]["contigs"]]
        off = np.concatenate([[0], np.cumsum([len(f) for f in fr])])
        ctx.cache[key] = fr, off
    return ctx.cache[key]


def expected(ctx, picks, sat=None):
    """Per picked contig: (fragments, candidate lists, hit rows, output
    records), computed at `sat` (None: exact)."""
    out = []
    for j, c in picks:
        fr, _ = _fragments(ctx, j)
        frags = fr[c]
        qc = [scoring.encode(a) for _, _, a in frags]
        qb = scoring.comp_bias(qc)
        with common.timed("gapless"):
            s = gapless.scores(ctx.gdb, qc, qb, sat=sat)
        cands = gapless.candidates(s, ctx.cfg["min_ungapped_score"],
                                   ctx.cfg["max_seqs"])
        del s
        pairs = np.array([(k, t) for k, cl in enumerate(cands) for t in cl],
                         np.int64).reshape(-1, 2)
        with common.timed("sw"):
            aln = sw.align(qc, qb, ctx.tcodes, pairs, ctx.device, sat=sat)
        q_len = np.array([len(qc[k]) for k in pairs[:, 0]], np.int64)
        h = hits.hit_table(pairs[:, 0], pairs[:, 1], aln, q_len,
                           ctx.tlens[pairs[:, 1]], ctx.db_res,
                           ctx.cfg["evalue"], rp.Params.min_exon_aa)
        name, seq = ctx.jobs[j]["contigs"][c]
        reps = rp.reduce(rp.exon_sets(frags, h, ctx.db_res))
        recs = rp.records(reps, c, name, seq, ctx.t_acc)
        out.append(([a for _, _, a in frags], cands, _hit_rows(h), recs))
    return out


def _hit_rows(h):
    """Per fragment, its hits as comparable tuples."""
    rows = {}
    for r in range(len(h["q"])):
        rows.setdefault(int(h["q"][r]), []).append((
            int(h["t"][r]), int(h["score"][r]), int(h["bits"][r]),
            "%.3E" % h["evalue"][r], float(h["seq_id"][r]),
            int(h["q_start"][r]), int(h["q_end"][r]), int(h["q_len"][r]),
            int(h["t_start"][r]), int(h["t_end"][r]), int(h["t_len"][r])))
    return rows


def _records(path, contig_acc, contig_key):
    """The contig's records of the program's four output files."""
    out = []
    for ext in OUTPUTS:
        text = open(f"{path}.{ext}").read()
        if ext.endswith("fas"):
            lines = text.splitlines(keepends=True)
            recs = [lines[i] + lines[i + 1] for i in range(0, len(lines), 2)
                    if lines[i].split("|")[1] == contig_acc]
        elif ext == "gff":
            recs = [ln for ln in text.splitlines(keepends=True)
                    if ln.split("\t")[0] == contig_acc]
        else:
            recs = [ln for ln in text.splitlines(keepends=True)
                    if ln.split("\t")[0] == str(contig_key)]
        out.append(recs)
    return out


def program(ctx, picks):
    """The same of the program, from what its window produced."""
    out = []
    for j, c in picks:
        _, off = _fragments(ctx, j)
        lo, hi = int(off[c]), int(off[c + 1])
        seqs, pairs = ctx.rec.captured[j]["prefilter"][0]
        hit_arr = ctx.rec.captured[j]["align"][0]
        frags = [bytes(a) for a in seqs[lo:hi]]
        pairs = pairs[np.argsort(pairs[:, 0], kind="stable")]
        sub = pairs[np.searchsorted(pairs[:, 0], lo):
                    np.searchsorted(pairs[:, 0], hi)]
        cands = [sub[sub[:, 0] == q, 1] for q in range(lo, hi)]
        h = hit_arr[(hit_arr["orf_idx"] >= lo) & (hit_arr["orf_idx"] < hi)]
        rows = _hit_rows(dict(
            q=h["orf_idx"] - lo, t=h["target_idx"], score=h["score_raw"],
            bits=h["bit_score"], evalue=h["evalue"], seq_id=h["seq_id"],
            q_start=h["q_start"], q_end=h["q_end"], q_len=h["q_len"],
            t_start=h["t_start"], t_end=h["t_end"], t_len=h["t_len"]))
        name = ctx.jobs[j]["contigs"][c][0]
        out.append((frags, cands, rows,
                    _records(ctx.jobs[j]["dir"] / "pred", name, c)))
    return out


def compare(ctx, picks, got, want):
    n = dict(frag_rows_differ=0, pref_lists_differ=0, hit_rows_differ=0,
             pred_rows_differ=0)
    for (gf, gc, gh, gr), (wf, wc, wh, wr) in zip(got, want):
        n["frag_rows_differ"] += common.rows_differ(gf, wf)
        n["pref_lists_differ"] += sum(not np.array_equal(a, b)
                                      for a, b in zip(gc, wc)) \
            + abs(len(gc) - len(wc))
        for q in set(gh) | set(wh):
            n["hit_rows_differ"] += common.rows_differ(gh.get(q, []),
                                                       wh.get(q, []))
        n["pred_rows_differ"] += sum(common.rows_differ(a, b)
                                     for a, b in zip(gr, wr))
    return n
