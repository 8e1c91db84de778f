"""GPU discovery (``ray_tpu_torch.accelerators``) under a monkeypatched
``CUDA_VISIBLE_DEVICES`` and a faked CUDA, on the CPU; and the device list
of ``utils/device.py``."""

import pytest
import torch

from ray_tpu_torch.accelerators import GPUAcceleratorManager as M
from ray_tpu_torch.accelerators import gpu
from ray_tpu_torch.utils import device


@pytest.fixture
def h100x4(monkeypatch):
    """A host whose CUDA counts four H100s."""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.delenv(gpu.NOSET_CUDA_VISIBLE_DEVICES_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")


def test_resource_name():
    assert M.get_resource_name() == "GPU"


def test_visible_ids_from_the_environment(h100x4, monkeypatch):
    assert M.get_current_process_visible_accelerator_ids() is None
    assert M.get_current_node_num_accelerators() == 4  # what CUDA counts
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
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: name)
    assert M.get_current_node_accelerator_type() == kind


def test_no_cuda_no_gpus(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
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
    this process's torch has no CUDA to name them (no type marker, no
    raise): a runtime's init on such a host still starts."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert M.get_current_node_accelerator_type() is None
    assert M.get_current_node_resources() == {"GPU": 2.0}
