"""The port's kernel build bookkeeping, on the CPU (no nvcc here): a
library's name follows its source, every shared header and the flags, and
the compiler's per-kernel report is read back by instantiation."""

import shutil

import pytest
import torch

from ray_tpu_torch import kernels
from ray_tpu_torch.ops.flash_attention import _fit, _rows_aligned

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122flash_bwd_dq_tc_kernelILi128EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_iiixxxxxxxxxxxxfi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_122flash_bwd_dq_tc_kernelILi128EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_iiixxxxxxxxxxxxfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 528 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120flash_bwd_dkv_kernelI13__nv_bfloat16Li256EEEvPKT_S4_S4_S4_PKfS6_PS2_S7_iiixxxxxxxxxxxxfi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120flash_bwd_dkv_kernelI13__nv_bfloat16Li256EEEvPKT_S4_S4_S4_PKfS6_PS2_S7_iiixxxxxxxxxxxxfi
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, 1024 bytes smem, 528 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119flash_bwd_dq_kernelIfLi64EEEvPKT_S3_S3_S3_PKfS5_PS1_iiixxxxxxxxxxxxfi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119flash_bwd_dq_kernelIfLi64EEEvPKT_S3_S3_S3_PKfS5_PS1_iiixxxxxxxxxxxxfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, 528 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119flash_fwd_tc_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiiixxxxxxxxxfi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119flash_fwd_tc_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiiixxxxxxxxxfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 184 registers, used 1 barriers, 496 bytes cmem[0]
"""


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of the kernel sources that the build reads instead."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", str(csrc))
    return csrc


def _paths():
    return {n: kernels.library_path(n) for n in kernels.KERNELS}


def test_library_path_changes_when_a_header_changes(csrc_copy):
    header = csrc_copy / "flash_tc.cuh"
    before = _paths()
    original = header.read_bytes()
    header.write_bytes(original + b"\n// one more line\n")
    after = _paths()
    assert all(after[n] != before[n] for n in kernels.KERNELS)
    header.write_bytes(original)
    assert _paths() == before


def test_library_path_changes_when_a_header_is_added(csrc_copy):
    before = _paths()
    (csrc_copy / "extra.cuh").write_bytes(b"#pragma once\n")
    assert all(p != before[n] for n, p in _paths().items())


@pytest.mark.parametrize("name", kernels.KERNELS)
def test_library_path_follows_its_own_source(csrc_copy, name):
    before = _paths()
    src = csrc_copy / f"{name}.cu"
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    after = _paths()
    assert after[name] != before[name]
    assert all(after[n] == before[n] for n in kernels.KERNELS if n != name)


def test_library_path_follows_the_flags(monkeypatch):
    before = _paths()
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-lineinfo",))
    assert all(p != before[n] for n, p in _paths().items())


def test_nvcc_asks_ptxas_for_its_report():
    flags = list(kernels.NVCC_FLAGS)
    assert flags[flags.index("-Xptxas") + 1] == "-v"


def test_ptxas_report_reads_each_instantiation():
    rows = kernels.ptxas_report(PTXAS_LOG)
    assert rows == [
        {"kernel": "flash_bwd_dq_tc_kernel", "dtype": "bfloat16", "D": 128,
         "registers": 168, "spill_stores": 0, "spill_loads": 0, "smem_static": 0},
        {"kernel": "flash_bwd_dkv_kernel", "dtype": "bfloat16", "D": 256,
         "registers": 255, "spill_stores": 12, "spill_loads": 16, "smem_static": 1024},
        {"kernel": "flash_bwd_dq_kernel", "dtype": "float32", "D": 64,
         "registers": 96, "spill_stores": 0, "spill_loads": 0, "smem_static": 0},
        {"kernel": "flash_fwd_tc_kernel", "dtype": "bfloat16", "D": 128,
         "registers": 184, "spill_stores": 0, "spill_loads": 0, "smem_static": 0},
    ]


def test_ptxas_report_of_a_log_without_entries_is_empty():
    assert kernels.ptxas_report("nvcc warning : nothing compiled\n") == []


def test_bf16_rows_alignment_rule():
    x = torch.zeros(2, 8, 2, 64, dtype=torch.bfloat16)
    assert _rows_aligned(x)
    assert _rows_aligned(x[:, 2:])  # 2 rows of 2 heads of 64 bf16 in: 512 bytes
    flat = torch.zeros(2 * 8 * 2 * 64 + 1, dtype=torch.bfloat16)
    assert not _rows_aligned(flat[1:].view(2, 8, 2, 64))  # 2 bytes off
    padded = torch.zeros(2, 8, 2, 68, dtype=torch.bfloat16)[..., :64]
    assert not _rows_aligned(padded)  # rows 136 bytes apart


def _unaligned_bf16():
    flat = torch.arange(2 * 8 * 2 * 64 + 1, dtype=torch.float32).bfloat16()
    return flat[1:].view(2, 8, 2, 64)  # 2 bytes off


@pytest.mark.parametrize("make", [
    _unaligned_bf16,
    lambda: torch.randn(2, 8, 2, 68).bfloat16()[..., :64],  # rows 136 bytes apart
    lambda: torch.randn(2, 2, 8, 64).transpose(-1, -2),  # head dim not contiguous
])
def test_fit_copies_what_the_kernels_cannot_read(make):
    x = make()
    y = _fit(x)
    assert y.data_ptr() != x.data_ptr() and y.is_contiguous()
    assert y.stride(-1) == 1 and (y.dtype != torch.bfloat16 or _rows_aligned(y))
    assert torch.equal(y, x)


@pytest.mark.parametrize("make", [
    lambda: torch.zeros(2, 8, 2, 64, dtype=torch.bfloat16),
    lambda: torch.zeros(2, 8, 2, 64, dtype=torch.bfloat16)[:, 2:],  # aligned view
    lambda: torch.zeros(2 * 8 * 2 * 64 + 1)[1:].view(2, 8, 2, 64),  # float32: any offset
    lambda: torch.zeros(2, 8, 4, 64, dtype=torch.bfloat16)[:, :, ::2],  # strided heads
])
def test_fit_passes_through_what_the_kernels_read(make):
    x = make()
    assert _fit(x) is x
