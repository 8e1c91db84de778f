"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface; the
kernels share the headers ``csrc/*.cuh``. At first use a kernel is compiled
by ``nvcc`` for ``sm_90a`` into a shared library under
``ray_tpu_torch/_build/`` (git-ignored), named by a hash of its source, every
header and the flags, so an edited source or header rebuilds, and loaded
with ``ctypes``. No PyTorch headers are compiled: a build takes seconds, not
minutes. ``-Xptxas -v`` makes the compiler report each kernel
instantiation's registers, spills and static shared memory; the report is
kept beside the library (``<library>.log``) and read by ``build_report``.

``LAUNCHES`` counts, per kernel and inputs' dtype, the launches its wrapper
made on a CUDA tensor; a run that resets it before the main path and reads
it after (``launches()`` sums the dtypes) can show that the path went
through the kernel.
"""
from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import re
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")

LAUNCHES: collections.Counter = collections.Counter()  # (kernel, dtype) -> launches


def count_launch(name: str, dtype) -> None:
    """Count one launch of kernel ``name`` on inputs of ``dtype``."""
    LAUNCHES[name, str(dtype).removeprefix("torch.")] += 1


def launches() -> collections.Counter:
    """``LAUNCHES`` per kernel, summed over the dtypes."""
    out: collections.Counter = collections.Counter()
    for (name, _), n in LAUNCHES.items():
        out[name] += n
    return out

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
    """The library of kernel ``name``, named by a hash of its source, of
    every ``csrc/*.cuh`` header (by name and bytes) and of the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, f"{name}.cu"),
                 *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
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
        with open(f"{tmp}.log", "wb") as f:
            f.write(log)
        os.replace(f"{tmp}.log", f"{lib}.log")
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


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def _kernel_label(mangled: str) -> tuple[str, str | None, int | None]:
    """(kernel name, dtype, head dim) of a mangled kernel template name such
    as ``_ZN12_GLOBAL__N_120flash_bwd_dq_tc_kernelILi128EEEv...``: the
    ``*_tc_*`` kernels are bf16 only; the others carry their element type
    (``f`` float32, ``13__nv_bfloat16``) as the first template argument."""
    m = re.search(r"\d+(flash_\w*?kernel)I(.*?)EE", mangled)
    if m is None:
        return mangled, None, None
    name, args = m.groups()
    d = re.search(r"Li(\d+)E", args + "E")
    dtype = ("bfloat16" if "__nv_bfloat16" in args or "_tc_" in name
             else "float32" if args.startswith("f") else None)
    return name, dtype, int(d.group(1)) if d else None


def ptxas_report(log: str) -> list[dict]:
    """One row per kernel entry that ``nvcc -Xptxas -v`` compiled: its
    registers a thread, spill bytes and static shared memory (dynamic shared
    memory is set at launch and not in this report)."""
    rows: list[dict] = []
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            name, dtype, d = _kernel_label(m.group(1))
            rows.append({"kernel": name, "dtype": dtype, "D": d, "registers": None,
                         "spill_stores": 0, "spill_loads": 0, "smem_static": 0})
            continue
        if not rows:
            continue
        if m := _SPILL.search(line):
            rows[-1]["spill_stores"] = int(m.group(1))
            rows[-1]["spill_loads"] = int(m.group(2))
        if m := _REGS.search(line):
            rows[-1]["registers"] = int(m.group(1))
            if s := _SMEM.search(line):
                rows[-1]["smem_static"] = int(s.group(1))
    return rows


def build_report(name: str) -> list[dict]:
    """The compiler's report for kernel ``name`` (built first if need be),
    each row with the dynamic shared memory its launch sets where the
    library answers ``<name>_smem_bytes(D, dtype)``, else None."""
    lib = load(name)
    with open(f"{library_path(name)}.log", errors="replace") as f:
        rows = ptxas_report(f.read())
    query = getattr(lib, f"{name}_smem_bytes", None)
    if query is not None:
        query.argtypes = [ctypes.c_int, ctypes.c_int]
        query.restype = ctypes.c_int
    for row in rows:
        row["smem_dynamic"] = None
        if query is not None and row["D"] is not None and row["dtype"] is not None:
            row["smem_dynamic"] = query(row["D"], 0 if row["dtype"] == "float32" else 1)
    return rows
