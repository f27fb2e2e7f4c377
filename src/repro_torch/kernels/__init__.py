"""Hand-written CUDA kernels for the RTAC hot spot, each beside its plain
PyTorch version (the counterpart of `repro.kernels`).

bitpack_support  packed revise (stacked and single-network) + fused packed
                 fixpoint wrappers
rtac_support     the same three wrappers for dense u8 networks
ops              padding/packing, prepare_dense/prepare_packed, the
                 single-network, rows and frontier closures
ref              plain PyTorch oracles (int32 words, OR-packed)
launch           operand checks, signatures and ctypes launches
build            nvcc build of csrc/*.cu for sm_90a, ctypes loading
autotune         tuned launch schedules per shape bucket (env-gated)
"""

from . import autotune, bitpack_support, build, launch, ops, ref, rtac_support

__all__ = ["autotune", "bitpack_support", "build", "launch", "ops", "ref", "rtac_support"]
