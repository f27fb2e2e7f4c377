"""Hand-written CUDA kernels for the RTAC hot spot, each beside its plain
PyTorch version (the counterpart of `repro.kernels`).

bitpack_support  the stacked packed revise + fused packed fixpoint wrappers
ops              padding/packing, prepare_packed, the rows/frontier closures
ref              plain PyTorch oracles (int32 words, OR-packed)
build            nvcc build of csrc/*.cu for sm_90a, ctypes loading
"""

from . import bitpack_support, build, ops, ref

__all__ = ["bitpack_support", "build", "ops", "ref"]
