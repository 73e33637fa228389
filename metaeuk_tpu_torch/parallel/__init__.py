"""Multi-process and multi-GPU layers of the port: contig partitions
(multihost), the target-split prefilter fanned over processes
(dist_prefilter), and the sharded search steps on a 2D device mesh (dist),
all on torch.distributed."""
