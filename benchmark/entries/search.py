"""MMseqs2 `search` with the ungapped prefilter, through the port's CLI
(cmd_search): queries as FASTA, the target DB createdb'd once in set-up.

Spans: load (the query and target inputs), prefilter
(UngappedPrefilter.candidate_pairs), align (SearchDriver.search), write
(the alignment DB). Captured: the queries given to the prefilter, its
candidate pairs and the aligner's hits.

The comparison, on a sample of the window's queries drawn from the seed
with the longest among them: the ordered candidate list of each against
the reference's gapless top list, and its rows of the alignment DB against
the reference's hits.
"""

import numpy as np

from .. import gen
from ..reference import gapless, hits, scoring, sw
from . import common


def setup(ctx):
    common.setup_db(ctx)
    from metaeuk_tpu_torch.io import mmseqsdb
    from metaeuk_tpu_torch.pipeline import predict
    from metaeuk_tpu_torch.search import driver, prefilter
    rec = ctx.rec
    rec.wrap(predict, "load_sequence_input", "load")
    rec.wrap(predict, "load_target_input", "load")
    rec.wrap(prefilter.UngappedPrefilter, "candidate_pairs", "prefilter",
             keep=lambda a, out: (list(a[1]), out))
    rec.wrap(driver.SearchDriver, "search", "align",
             keep=lambda a, out: out)
    rec.wrap(mmseqsdb, "write_db", "write")


def make_job(ctx, job, cut=None):
    qs = gen.queries(ctx.seed, job, ctx.tdb, ctx.wl)
    if cut:
        qs = qs[:cut]
    d = ctx.workdir / f"job{job}"
    d.mkdir()
    gen.write_fasta(d / "q.faa", [n for n, _ in qs], [s for _, s in qs])
    return dict(dir=d, queries=qs, work=len(qs),
                aa=sum(len(s) for _, s in qs))


def run_job(ctx, job):
    d = job["dir"]
    common.cli(["search", str(d / "q.faa"), str(ctx.db), str(d / "aln"),
                *common.flags(ctx.cfg), "--device", ctx.device])


def host_stage_s(ctx, j):
    return sum(ctx.rec.seconds(j, n) for n in ("load", "write"))


def sample(ctx, done):
    """(job, query) pairs to check: the longest query of the window and
    ctx.wl["check"] more drawn from the seed."""
    allq = [(j, q) for j in done for q in range(len(ctx.jobs[j]["queries"]))]
    lens = [len(ctx.jobs[j]["queries"][q][1]) for j, q in allq]
    rng = gen.rng_for(ctx.seed, 3)
    pick = {allq[int(np.argmax(lens))]}
    for i in rng.permutation(len(allq)):
        if len(pick) > ctx.wl["check"]:
            break
        pick.add(allq[int(i)])
    return sorted(pick)


def expected(ctx, picks, sat=None):
    """The reference's (candidate lists, hit lines) of the picked queries,
    computed at `sat` (None: exact)."""
    qc = [scoring.encode(ctx.jobs[j]["queries"][q][1]) for j, q in picks]
    qb = scoring.comp_bias(qc)
    with common.timed("gapless"):
        s = gapless.scores(ctx.gdb, qc, qb, sat=sat)
    cands = gapless.candidates(s, ctx.cfg["min_ungapped_score"],
                               ctx.cfg["max_seqs"])
    del s
    pairs = np.array([(k, t) for k, c in enumerate(cands) for t in c],
                     np.int64).reshape(-1, 2)
    with common.timed("sw"):
        aln = sw.align(qc, qb, ctx.tcodes, pairs, ctx.device, sat=sat)
    q_len = np.array([len(qc[k]) for k in pairs[:, 0]], np.int64)
    h = hits.hit_table(pairs[:, 0], pairs[:, 1], aln, q_len,
                       ctx.tlens[pairs[:, 1]], ctx.db_res,
                       ctx.cfg["evalue"], 0)
    rows = hits.lines(h)
    lines = [[] for _ in picks]
    for k, r in zip(h["q"], rows):
        lines[k].append(r)
    return cands, lines


def program(ctx, picks):
    """The program's (candidate lists, DB rows) of the picked queries."""
    cands, lines = [], []
    for j, q in picks:
        pairs = ctx.rec.captured[j]["prefilter"][0][1]
        cands.append(pairs[pairs[:, 0] == q, 1])
        payload = common.read_db(ctx.jobs[j]["dir"] / "aln").get(q, "")
        lines.append(payload.splitlines(keepends=True))
    return cands, lines


def compare(ctx, picks, got, want):
    (gc, gl), (wc, wl) = got, want
    return {
        "pref_lists_differ": sum(not np.array_equal(a, b)
                                 for a, b in zip(gc, wc)),
        "aln_rows_differ": sum(common.rows_differ(a, b)
                               for a, b in zip(gl, wl)),
    }
