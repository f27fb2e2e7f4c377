"""Build the port's CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), at first use or all together through `build`. Libraries go
to ``kernels/_build/`` (ignored by git), named by a digest of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or header
rebuilds and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: nvcc/ptxas output of the last build of each source (registers, spills)
LOGS: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def sources():
    """The kernel sources' names (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                           "CUDA toolkit is installed")
    return path


def library_path(name: str) -> Path:
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None, force: bool = False) -> Dict[str, float]:
    """Compile ``names`` (default: every source) in parallel — one nvcc per
    source, all started together. Returns seconds per source built; raises
    with the compiler's output if any build fails."""
    names = list(sources() if names is None else names)
    todo = [n for n in names if force or not library_path(n).exists()]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out, time.perf_counter())
    seconds, errors = {}, []
    for n, (proc, tmp, out, t0) in procs.items():
        LOGS[n] = proc.communicate()[0]
        seconds[n] = time.perf_counter() - t0
        if proc.returncode:
            errors.append(f"{n}.cu: nvcc exited {proc.returncode}\n{LOGS[n]}")
        else:
            os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
