"""metaeuk_tpu_torch — the PyTorch and CUDA port of metaeuk_tpu for NVIDIA Hopper.

The device stages of easy-predict (the gapless prefilter scores and the
Smith-Waterman alignment) run in hand-written CUDA kernels (csrc/). The host
stages are the port's own copies of metaeuk_tpu's modules, under the same
sub-paths, with the native C++ host library built from native/ into build/.
No module of this package imports jax or metaeuk_tpu.
"""

__version__ = "0.1.0"
