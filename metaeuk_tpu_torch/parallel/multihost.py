"""Multi-process data-parallel easy-predict (the reference's MPI role) on
torch.distributed.

Counterpart of metaeuk_tpu/parallel/multihost.py. The unit of data
parallelism is the contig: per-contig predictions are independent (search
E-values depend only on the target DB), so each process runs a contiguous
contig block against the whole target DB and the partition outputs
concatenate byte-identically to a single-process run.

Start one process per rank with a process group of its own
(tools/dist_worker.py: init_process_group over tcp://HOST:PORT), or drive
the partitions by hand:

    metaeuk-tpu-torch easy-predict ... --contig-split I:N     # process I
    metaeuk-tpu-torch mergepredictions out part0 part1 ...    # afterwards

The rank and world size come from torch.distributed (0 and 1 when no
process group exists). The group is gloo even when the alignment runs on
CUDA (tools/dist_worker.py makes it so): its barriers only order files on
a shared filesystem, and two processes that share one GPU cannot form an
NCCL group.
"""

import os
import pathlib


def _group():
    """torch.distributed when a process group exists, else None."""
    import torch.distributed as tdist
    if tdist.is_available() and tdist.is_initialized():
        return tdist
    return None


def process_index():
    """This process's rank (0 without a process group)."""
    tdist = _group()
    return tdist.get_rank() if tdist else 0


def process_count():
    """The world size (1 without a process group)."""
    tdist = _group()
    return tdist.get_world_size() if tdist else 1


def barrier(tag):
    """Waits for every process of the group (no-op in a single process);
    `tag` names the barrier in the debug log, as jax's
    sync_global_devices(tag) does."""
    tdist = _group()
    if tdist is None or tdist.get_world_size() == 1:
        return
    from ..utils import log
    log.debug(f"barrier {tag}")
    tdist.barrier()


def contig_partition(n_contigs, process_index, process_count):
    """Contiguous block [lo, hi) for this process (the
    decomposeDomainByAminoAcid role, by count); multihost.py:27."""
    base = n_contigs // process_count
    rem = n_contigs % process_count
    lo = process_index * base + min(process_index, rem)
    hi = lo + base + (1 if process_index < rem else 0)
    return lo, hi


def merge_predictions(out_prefix, partition_prefixes):
    """Concatenate partition outputs into the single-run files
    (multihost.py:37).

    All four easy-predict outputs are strictly per-contig in ascending
    contig order with no global counters, so block-partitioned outputs
    concatenate byte-identically."""
    for suffix in ("fas", "codon.fas", "headersMap.tsv", "gff"):
        with open(f"{out_prefix}.{suffix}", "wb") as out:
            for prefix in partition_prefixes:
                out.write(pathlib.Path(f"{prefix}.{suffix}").read_bytes())
    return out_prefix


def distributed_easy_predict(params, contigs_path, targets_path, out_prefix,
                             tmp_dir=None, device="cuda", predictor=None):
    """Run this process's contig partition; process 0 merges after all
    partitions exist (shared filesystem). Works unchanged for a
    single-process run. `predictor` is the EasyPredict to run (default
    EasyPredict(params, device)); its stage_seconds hold this process's
    stages afterwards."""
    from ..io.seqdb import DBTYPE_NUCL, SeqDB
    from ..pipeline.predict import EasyPredict

    pi, pc = process_index(), process_count()
    n = len(SeqDB.from_fasta(contigs_path, DBTYPE_NUCL))
    lo, hi = contig_partition(n, pi, pc)
    part_prefix = f"{out_prefix}.part{pi}" if pc > 1 else out_prefix
    # shared scratch for the distributed prefilter (splits fanned over
    # processes, parallel/dist_prefilter.py) when the run uses splits
    prev_dist = os.environ.get("METAEUK_DIST_TMP")
    if pc > 1:
        os.environ["METAEUK_DIST_TMP"] = (
            os.path.join(tmp_dir, "dist_pref") if tmp_dir
            else f"{out_prefix}.dist_pref")
    try:
        ep = predictor or EasyPredict(params, device=device)
        ep.run(contigs_path, targets_path, part_prefix, tmp_dir=tmp_dir,
               contig_range=(lo, hi))
    finally:
        if pc > 1:
            if prev_dist is None:
                os.environ.pop("METAEUK_DIST_TMP", None)
            else:
                os.environ["METAEUK_DIST_TMP"] = prev_dist
    if pc > 1:
        # barrier over all processes, then rank 0 merges
        barrier("metaeuk_predict_parts")
        if pi == 0:
            merge_predictions(out_prefix,
                              [f"{out_prefix}.part{i}" for i in range(pc)])
    return out_prefix
