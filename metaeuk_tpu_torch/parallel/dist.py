"""Sharded search steps on a 2D device mesh (torch.distributed).

Counterpart of metaeuk_tpu/parallel/dist.py, the replacement for the
reference's split/MPI parallelism (Prefiltering::runSplits / runMpiSplits,
lib/mmseqs/src/prefiltering/Prefiltering.cpp:575-770, and
Alignment::run(mpiRank,...), alignment/Alignment.cpp:219-243): the
(fragment, target) alignment grid is laid out on a 2D mesh of the process
group's ranks -

  axis "frags":   fragment blocks data-parallel (the contig/query dim)
  axis "targets": the target DB sharded across ranks (the memory dim)

Each rank aligns its fragment block against its target shard through
ops/sw_cuda.py's sw_ends with cap=None (K1's uncapped instance, the
counterpart of sw_jax.sw_batch_ends; its plain version on the CPU), and the
per-fragment results are completed with an all-gather over the "targets"
group (NCCL on the card, gloo on the CPU). Each rank returns its fragment
block's rows, complete over targets: the block of the JAX step's output
(out_specs P("frags", None)) that lives on it. The top-k variant orders
ties as jax.lax.top_k does (the lower index first), with stable descending
sorts.
"""

import torch

from ..ops import sw_cuda

FRAGS_AXIS = "frags"
TARGETS_AXIS = "targets"

# per-mesh-axis collective traffic accounting (bytes RECEIVED per rank over
# the axis): an all-gather over an n-way axis delivers (n-1)/n of the
# gathered result to each rank. Updated from the static shapes at each
# sharded-step call, with dist.py's formulas.
COLLECTIVE_BYTES = {}


def _account(axis, nbytes):
    COLLECTIVE_BYTES[axis] = COLLECTIVE_BYTES.get(axis, 0) + int(nbytes)


def collective_report(reset=False):
    """{axis: bytes} accumulated since the last reset."""
    out = dict(COLLECTIVE_BYTES)
    if reset:
        COLLECTIVE_BYTES.clear()
    return out


def make_mesh(devices=None, frags=None, targets=None):
    """The 2D search mesh over the process group's ranks (rank r at
    (r // targets, r % targets)). devices: the mesh's device type, "cuda"
    (NCCL) or "cpu" (gloo); default "cuda" when the default group is NCCL.
    Defaults as dist.py:53: targets axis 1 (replicated DB), every rank
    data-parallel over fragments."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh

    if not (tdist.is_available() and tdist.is_initialized()):
        raise RuntimeError("make_mesh needs a process group "
                           "(torch.distributed.init_process_group)")
    n = tdist.get_world_size()
    if devices is None:
        devices = "cuda" if tdist.get_backend() == "nccl" else "cpu"
    if frags is None and targets is None:
        targets = 1
        frags = n
    elif frags is None:
        frags = n // targets
    elif targets is None:
        targets = n // frags
    if frags * targets != n:
        raise ValueError(f"a {frags} x {targets} mesh needs {frags * targets}"
                         f" ranks, the group has {n}")
    return init_device_mesh(devices, (frags, targets),
                            mesh_dim_names=(FRAGS_AXIS, TARGETS_AXIS))


def mesh_device(mesh):
    """The torch device this rank's part of `mesh` lives on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _local_cross(mesh, Lq, Lt, q_enc, q_bias, q_len, t_enc, t_len):
    """This rank's fragment block x target shard aligned on the mesh's
    device: (score, q_end, t_end), each (nq, nt) int32, and the shard's
    first target."""
    nf, ns = mesh.shape
    f, s = mesh.get_local_rank(FRAGS_AXIS), mesh.get_local_rank(TARGETS_AXIS)
    q_enc, q_bias, q_len, t_enc, t_len = (
        torch.as_tensor(a) for a in (q_enc, q_bias, q_len, t_enc, t_len))
    Bq, Nt = q_enc.shape[0], t_enc.shape[0]
    if q_enc.shape[1] != Lq or t_enc.shape[1] != Lt:
        raise ValueError(f"the step takes (Bq, {Lq}) fragments and (Nt, "
                         f"{Lt}) targets")
    if Bq % nf or Nt % ns:
        raise ValueError(f"{Bq} fragments and {Nt} targets do not split "
                         f"over a {nf} x {ns} mesh")
    nq, nt = Bq // nf, Nt // ns
    dev = mesh_device(mesh)
    fr, tr = slice(f * nq, (f + 1) * nq), slice(s * nt, (s + 1) * nt)
    q, qb, ql = (a[fr].to(dev) for a in (q_enc, q_bias, q_len))
    t, tl = (a[tr].to(dev) for a in (t_enc, t_len))
    # cross product of local fragments x local targets
    qi = torch.arange(nq, device=dev).repeat_interleave(nt)
    ti = torch.arange(nt, device=dev).repeat(nq)
    score, q_end, t_end = sw_cuda.sw_ends(q[qi], qb[qi], ql[qi], t[ti],
                                          tl[ti], cap=None)
    return (score.reshape(nq, nt), q_end.reshape(nq, nt),
            t_end.reshape(nq, nt), s * nt)


def _gather_columns(mesh, x):
    """x's columns from every rank of this rank's "targets" group, in the
    group's order (the target shards' order)."""
    import torch.distributed as tdist
    group = mesh.get_group(TARGETS_AXIS)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(tdist.get_world_size(group))]
    tdist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=1)


def sharded_search_step(mesh, Lq, Lt):
    """Returns step(q_enc, q_bias, q_len, t_enc, t_len) -> (score, q_end,
    t_end) (dist.py:70).

    Inputs are the global (Bq, Lq) fragments and (Nt, Lt) targets (numpy
    arrays or tensors, the same on every rank); the rank aligns its
    fragment block against its target shard and all-gathers the shards'
    columns, so its (Bq / frags, Nt) int32 rows are complete."""
    nf_shards, nt_shards = mesh.shape

    def step(q_enc, q_bias, q_len, t_enc, t_len):
        # 3 all-gathers of (nq_local, Nt) int32 over the targets axis
        nq_local = -(-q_enc.shape[0] // nf_shards)
        per_dev = 3 * nq_local * t_enc.shape[0] * 4
        _account(TARGETS_AXIS,
                 per_dev * (nt_shards - 1) // max(nt_shards, 1))
        score, q_end, t_end, _ = _local_cross(mesh, Lq, Lt, q_enc, q_bias,
                                              q_len, t_enc, t_len)
        return tuple(_gather_columns(mesh, x)
                     for x in (score, q_end, t_end))

    return step


def _top(x, k):
    """(values, indices) of each row's k largest, the lower index first
    among equal values (jax.lax.top_k's order)."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def sharded_search_topk_step(mesh, Lq, Lt, k):
    """Bandwidth-efficient variant for large target DBs (dist.py:123): each
    target shard reduces its scores to the per-fragment top-k BEFORE the
    gather, so the collective carries k hits per shard instead of the whole
    shard row (the reference's --max-seqs 300 contract: QueryMatcher keeps
    top max-seqs per query, QueryMatcher.h:206).

    Returns step -> (score, q_end, t_end, target_idx), each (Bq / frags,
    min(k, k_local * shards)) int32 rows of this rank, target_idx in GLOBAL
    target numbering: the exact top-k of the dense cross product, ties in
    global target order within a shard and in shard order across shards."""
    nf_shards, n_target_shards = mesh.shape

    def step(q_enc, q_bias, q_len, t_enc, t_len):
        # 4 all-gathers of (nq_local, k_local) int32 per shard: traffic
        # scales with k, not Nt
        nq_local = -(-q_enc.shape[0] // nf_shards)
        k_acc = min(k, -(-t_enc.shape[0] // n_target_shards))
        per_dev = 4 * nq_local * k_acc * n_target_shards * 4
        _account(TARGETS_AXIS,
                 per_dev * (n_target_shards - 1) // max(n_target_shards, 1))
        score, q_end, t_end, off = _local_cross(mesh, Lq, Lt, q_enc, q_bias,
                                                q_len, t_enc, t_len)
        k_local = min(k, score.shape[1])
        sc_k, idx_k = _top(score, k_local)
        gid_k = (idx_k + off).to(torch.int32)
        qe_k = torch.gather(q_end, 1, idx_k)
        te_k = torch.gather(t_end, 1, idx_k)
        # gather the per-shard candidate lists (k per shard, not nt)
        sc_all, gid_all, qe_all, te_all = (
            _gather_columns(mesh, x) for x in (sc_k, gid_k, qe_k, te_k))
        # final reduce to the global top-k
        kk = min(k, k_local * n_target_shards)
        sc_f, sel = _top(sc_all, kk)
        return (sc_f, torch.gather(qe_all, 1, sel),
                torch.gather(te_all, 1, sel), torch.gather(gid_all, 1, sel))

    return step
