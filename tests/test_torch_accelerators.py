"""GPU discovery (``ray_tpu_torch.accelerators``) under a monkeypatched
``CUDA_VISIBLE_DEVICES`` and a faked NVML (and a faked CUDA for the device
list of ``utils/device.py``), on the CPU; NVML's own ``ctypes`` binding
against a stand-in ``libnvidia-ml`` built here with the C compiler; and a
raylet and ``start`` that count the cards without importing torch."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse
from ray_tpu_torch.accelerators import GPUAcceleratorManager as M
from ray_tpu_torch.accelerators import gpu
from ray_tpu_torch.utils import device


# the CLI case starts a head: ~5 s alone
_module_limit, _test_limit = time_limits(module_s=120, test_s=90)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cards(monkeypatch, names):
    """NVML on this host names ``names``."""
    monkeypatch.setattr(gpu, "nvml_device_names", lambda: list(names))


@pytest.fixture
def h100x4(monkeypatch):
    """A host whose NVML and CUDA count four H100s."""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.delenv(gpu.NOSET_CUDA_VISIBLE_DEVICES_ENV, raising=False)
    _cards(monkeypatch, ["NVIDIA H100 80GB HBM3"] * 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")


def test_resource_name():
    assert M.get_resource_name() == "GPU"


def test_visible_ids_from_the_environment(h100x4, monkeypatch):
    assert M.get_current_process_visible_accelerator_ids() is None
    assert M.get_current_node_num_accelerators() == 4  # what NVML counts
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1,3")
    assert M.get_current_process_visible_accelerator_ids() == ["1", "3"]
    assert M.get_current_node_num_accelerators() == 2
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")  # none visible
    assert M.get_current_process_visible_accelerator_ids() == []
    assert M.get_current_node_num_accelerators() == 0
    assert M.get_current_node_resources() == {}
    assert M.get_current_node_accelerator_type() is None


def test_node_resources_and_type(h100x4):
    assert M.get_current_node_accelerator_type() == "H100"
    assert M.get_current_node_resources() == {"GPU": 4.0, "accelerator_type:H100": 1.0}


@pytest.mark.parametrize("name, kind", [("NVIDIA H100 80GB HBM3", "H100"),
                                        ("NVIDIA A100-SXM4-80GB", "A100"),
                                        ("Tesla V100-SXM2-16GB", "V100")])
def test_accelerator_type_from_the_device_name(h100x4, monkeypatch, name, kind):
    _cards(monkeypatch, [name])
    assert M.get_current_node_accelerator_type() == kind


def test_no_cuda_no_gpus(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    _cards(monkeypatch, [])  # the library did not load
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert M.get_current_node_num_accelerators() == 0
    assert M.get_current_node_resources() == {}
    assert device.devices() == [] and device.local_device_count() == 0


def test_devices_lists_the_visible_cards(h100x4):
    assert device.devices() == [torch.device("cuda", i) for i in range(4)]
    assert device.local_device_count() == 4


@pytest.mark.parametrize("quantity, ok", [(0.5, True), (0.25, True), (1, True), (2, True),
                                          (4.0, True), (1.5, False), (0, False),
                                          (-1, False)])
def test_quantity_validation(quantity, ok):
    valid, why = M.validate_resource_request_quantity(quantity)
    assert valid == ok
    assert (why is None) == ok


def test_set_visible_ids(h100x4, monkeypatch):
    # recorded, so the setter's write is undone after the test: a leaked
    # CUDA_VISIBLE_DEVICES would make later runtimes in this process count cards
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    M.set_current_process_visible_accelerator_ids(["2", "0"])
    assert M.get_current_process_visible_accelerator_ids() == ["2", "0"]
    monkeypatch.setenv(gpu.NOSET_CUDA_VISIBLE_DEVICES_ENV, "1")
    M.set_current_process_visible_accelerator_ids(["3"])  # left as it was
    assert M.get_current_process_visible_accelerator_ids() == ["2", "0"]


def test_visible_cards_without_cuda_have_no_type(monkeypatch):
    """Cards named by CUDA_VISIBLE_DEVICES count as resources even where
    this host's NVML cannot name them (no type marker, no raise): a
    runtime's init on such a host still starts."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
    _cards(monkeypatch, [])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert M.get_current_node_accelerator_type() is None
    assert M.get_current_node_resources() == {"GPU": 2.0}


def test_type_of_the_first_visible_card(monkeypatch):
    """The type is the first visible card's: CUDA_VISIBLE_DEVICES=2 on a
    host of an A100 and two H100s names an H100."""
    _cards(monkeypatch, ["NVIDIA A100-SXM4-80GB", "NVIDIA H100 80GB HBM3",
                         "NVIDIA H100 80GB HBM3"])
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2")
    assert M.get_current_node_resources() == {"GPU": 1.0, "accelerator_type:H100": 1.0}
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "GPU-5e1d")  # a UUID: NVML's first
    assert M.get_current_node_accelerator_type() == "A100"


FAKE_NVML = r"""
#include <string.h>
static const char *names[] = {"NVIDIA H100 80GB HBM3", "NVIDIA H100 80GB HBM3"};
static int up = 0;
int nvmlInit_v2(void) { up = 1; return 0; }
int nvmlShutdown(void) { up = 0; return 0; }
int nvmlDeviceGetCount_v2(unsigned int *n) { if (!up) return 1; *n = 2; return 0; }
int nvmlDeviceGetHandleByIndex_v2(unsigned int i, void **h) {
    if (!up || i >= 2) return 2; *h = (void *)names[i]; return 0; }
int nvmlDeviceGetName(void *h, char *buf, unsigned int len) {
    if (!up) return 1; strncpy(buf, (const char *)h, len); buf[len - 1] = 0; return 0; }
"""


@pytest.fixture(scope="module")
def fake_nvml(tmp_path_factory):
    """A stand-in libnvidia-ml with NVML's five entry points and two H100s."""
    d = tmp_path_factory.mktemp("nvml")
    (d / "nvml.c").write_text(FAKE_NVML)
    lib = d / "libnvidia-ml.so.1"
    subprocess.run(["cc", "-shared", "-fPIC", "-o", str(lib), str(d / "nvml.c")], check=True)
    return str(lib)


def test_nvml_binding_counts_and_names(fake_nvml, monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(gpu, "NVML_LIBRARY", fake_nvml)
    assert gpu.nvml_device_names() == ["NVIDIA H100 80GB HBM3"] * 2
    assert M.get_current_node_resources() == {"GPU": 2.0, "accelerator_type:H100": 1.0}
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1")  # still decides the count
    assert M.get_current_node_resources() == {"GPU": 1.0, "accelerator_type:H100": 1.0}
    monkeypatch.setattr(gpu, "NVML_LIBRARY", os.path.join(os.path.dirname(fake_nvml), "none.so"))
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert gpu.nvml_device_names() == [] and M.get_current_node_resources() == {}


def test_raylet_and_start_count_cards_without_torch(tmp_path):
    """A raylet process registers its node (cards counted, none here)
    with no torch in ``sys.modules``; and ``start --head``'s processes
    (the GCS and the raylet) never map torch's library."""
    probe = (
        "import sys\n"
        "from ray_tpu_torch.accelerators import GPUAcceleratorManager as M\n"
        "import ray_tpu_torch.core.raylet as raylet\n"
        "res = M.get_current_node_resources()\n"
        "print(sorted(m for m in sys.modules if m == 'torch' or m.startswith('torch.')))\n")
    env = {k: v for k, v in os.environ.items() if k not in ("RT_ADDRESS", "CUDA_VISIBLE_DEVICES")}
    env.update(PYTHONPATH=REPO, TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", probe], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    cli = [sys.executable, "-m", "ray_tpu_torch"]
    r = subprocess.run(cli + ["start", "--head", "--num-cpus", "1"], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    address = [ln for ln in r.stdout.splitlines() if "started at" in ln][0].split()[-1]
    with open(os.path.join(str(tmp_path), "ray_tpu_torch", "session.json")) as f:
        pids = json.load(f)["pids"]
    try:
        deadline = time.monotonic() + 60
        while True:  # the raylet has registered: its discovery is behind it
            s = subprocess.run(cli + ["status", "--address", address], env=env,
                               capture_output=True, text=True, timeout=120)
            if "nodes: 1" in s.stdout:
                break
            assert time.monotonic() < deadline, s.stdout + s.stderr
            time.sleep(0.2)
        for pid in pids:
            with open(f"/proc/{pid}/maps") as f:
                assert "libtorch" not in f.read(), f"process {pid} loaded torch"
    finally:
        subprocess.run(cli + ["stop"], env=env, capture_output=True, timeout=60)
