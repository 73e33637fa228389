"""The port's microbenchmarks, run as modules: `kbench` (T1-T3) and
`kernel_variants` (T4). They run on the card; `--device cpu` runs the
kernels' plain versions, untimed."""
