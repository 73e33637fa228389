"""Distributed k-mer prefilter: target splits fanned over processes.

Counterpart of metaeuk_tpu/parallel/dist_prefilter.py on torch.distributed.
The reference assigns memory-budgeted target splits to MPI ranks, each rank
matches the query set against its split's index, and per-query hit lists
are merged afterwards (Prefiltering::runMpiSplits + mergeTargetSplits,
lib/mmseqs/src/prefiltering/Prefiltering.cpp:575-660,379-466). Here the
same contract rides a process group and a shared filesystem:

  phase 1  every process writes its own encoded query block
  phase 2  splits are assigned round-robin (split s -> process s % pc);
           each process builds ONLY its splits' indices and matches
           EVERY process's query block against them, writing per-
           (split, query-block) hit files with the per-split hit budget
  phase 3  each process reads its own query block's hits from all
           splits and merges by (|score| desc, id asc)

The merged lists are byte-identical to the sequential SplitKmerPrefilter
(same per-split budget, same merge ordering), so a multi-process run with
splits produces the exact single-process outputs, while each process
builds 1/pc of the split indices. An empty query block still takes part in
every phase. The barriers are parallel/multihost.py's; with one
process the machinery degenerates to the sequential loop over all splits
through the same code path.
"""

import pathlib

import numpy as np

from ..search.prefilter_kmer import (KmerPrefilter, decompose_by_residues,
                                     split_max_res_list_len)
from .multihost import barrier, process_count, process_index


def _save_queries(path, query_encs, identity_ids):
    offs = np.zeros(len(query_encs) + 1, np.int64)
    for i, q in enumerate(query_encs):
        offs[i + 1] = offs[i] + len(q)
    data = (np.concatenate([np.asarray(q, np.uint8) for q in query_encs])
            if len(query_encs) else np.zeros(0, np.uint8))
    kw = dict(offs=offs, data=data)
    if identity_ids is not None:
        kw["ident"] = np.asarray(identity_ids, np.int64)
    np.savez(path, **kw)


def _load_queries(path):
    z = np.load(path)
    offs, data = z["offs"], z["data"]
    encs = [data[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]
    ident = z["ident"] if "ident" in z.files else None
    return encs, ident


class DistributedSplitKmerPrefilter:
    """Same match_batch contract as SplitKmerPrefilter, with the splits
    fanned over the process group's ranks via a shared tmp directory."""

    def __init__(self, target_encs, tmp_dir, n_splits, **kw):
        self.target_encs = target_encs
        self.kw = kw
        self.tmp = pathlib.Path(tmp_dir)
        self.pi, self.pc = process_index(), process_count()
        if self.pi == 0:
            self.tmp.mkdir(parents=True, exist_ok=True)
        self.n_splits = n_splits
        lens = [len(t) for t in target_encs]
        self.ranges = decompose_by_residues(lens, n_splits)
        mrl = min(len(target_encs), kw.get("max_res_list_len", 300))
        self.split_mrl = split_max_res_list_len(mrl, n_splits)
        self.n_targets = len(target_encs)

    def match_batch(self, query_encs, identity_ids=None):
        from ..utils import log
        barrier("dist_pref_tmp")
        # ---- phase 1: publish this process's query block ----
        _save_queries(self.tmp / f"q_{self.pi}.npz", query_encs,
                      identity_ids)
        barrier("dist_pref_queries")
        # ---- phase 2: my splits x every query block ----
        kw = dict(self.kw)
        kw["max_res_list_len"] = self.split_mrl
        for si, (start, count) in enumerate(self.ranges):
            if si % self.pc != self.pi or count == 0:
                continue
            log.info(f"prefilter split {si + 1}/{self.n_splits} "
                     f"on process {self.pi}: targets "
                     f"{start}..{start + count}")
            pf = KmerPrefilter(self.target_encs[start:start + count], **kw)
            for qp in range(self.pc):
                encs, ident = _load_queries(self.tmp / f"q_{qp}.npz")
                ids_local = None
                if ident is not None:
                    in_range = (ident >= start) & (ident < start + count)
                    ids_local = np.where(in_range, ident - start,
                                         0xFFFFFFFF).astype(np.uint32)
                counts, ids, scs, dgs = pf.match_batch_flat(
                    encs, identity_ids=ids_local)
                np.savez(self.tmp / f"hits_{si}_{qp}.npz", counts=counts,
                         ids=ids.astype(np.int64) + start, scs=scs,
                         dgs=dgs, stats=pf.stats)
            del pf
        barrier("dist_pref_hits")
        # ---- phase 3: merge my query block's lists over all splits ----
        nq = len(query_encs)
        parts = [[] for _ in range(nq)]
        self.stats = np.zeros(5, np.int64)
        for si, (start, count) in enumerate(self.ranges):
            if count == 0:
                continue
            z = np.load(self.tmp / f"hits_{si}_{self.pi}.npz")
            counts, ids, scs, dgs = (z["counts"], z["ids"], z["scs"],
                                     z["dgs"])
            self.stats = self.stats + z["stats"]
            offs = np.zeros(nq + 1, np.int64)
            np.cumsum(counts, out=offs[1:])
            for qi in range(nq):
                if counts[qi]:
                    parts[qi].append((ids[offs[qi]:offs[qi + 1]],
                                      scs[offs[qi]:offs[qi + 1]],
                                      dgs[offs[qi]:offs[qi + 1]]))
        out = []
        for qi in range(nq):
            if not parts[qi]:
                out.append((np.zeros(0, np.uint32), np.zeros(0, np.int32),
                            np.zeros(0, np.int16)))
                continue
            ids = np.concatenate([p[0] for p in parts[qi]])
            sc = np.concatenate([p[1] for p in parts[qi]])
            dg = np.concatenate([p[2] for p in parts[qi]])
            # hit_t::compareHitsByScoreAndId (mergeTargetSplits,
            # Prefiltering.cpp:464-466)
            order = np.lexsort((ids, -np.abs(sc.astype(np.int64))))
            out.append((ids[order].astype(np.uint32), sc[order],
                        dg[order]))
        return out
