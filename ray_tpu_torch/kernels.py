"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface. At
first use it is compiled by ``nvcc`` for ``sm_90a`` into a shared library
under ``ray_tpu_torch/_build/`` (git-ignored), named by a hash of its
source and flags so an edited source rebuilds, and loaded with ``ctypes``.
No PyTorch headers are compiled: a build takes seconds, not minutes.

``LAUNCHES`` counts, per kernel, the launches its wrapper made on a CUDA
tensor; a run that resets it before the main path and reads it after can
show that the path went through the kernel.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")
KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")

LAUNCHES: collections.Counter = collections.Counter()

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler of the toolkit PyTorch finds (``CUDA_HOME``)."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return nvcc


def library_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _nvcc_command(name: str, out: str) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", out, os.path.join(CSRC, f"{name}.cu")]


def build(names=KERNELS) -> dict[str, float]:
    """Compile every named kernel that is not built yet, one ``nvcc``
    process per source, all started together; returns the seconds each
    build took (0.0 for one already built). Raises with the compiler's
    output if a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    secs: dict[str, float] = {}
    for name in names:
        lib = library_path(name)
        if os.path.exists(lib):
            secs[name] = 0.0
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(_nvcc_command(name, tmp),
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build((name,))
            lib = ctypes.CDLL(path)
            lib.rt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.rt_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.rt_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")
