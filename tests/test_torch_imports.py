"""The PyTorch port stands alone: it imports neither jax nor ray_tpu."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ["ray_tpu_torch", "ray_tpu_torch.ops", "ray_tpu_torch.models",
               "ray_tpu_torch.llm", "ray_tpu_torch.llm.disagg",
               "ray_tpu_torch.serve", "ray_tpu_torch.data",
               "ray_tpu_torch.parallel", "ray_tpu_torch.parallel.comm",
               "ray_tpu_torch.parallel.mesh", "ray_tpu_torch.parallel.sharding",
               "ray_tpu_torch.parallel.ring_attention", "ray_tpu_torch.parallel.ulysses",
               "ray_tpu_torch.parallel.pipeline", "ray_tpu_torch.parallel.moe",
               "ray_tpu_torch.utils", "ray_tpu_torch.utils.serialization",
               "ray_tpu_torch.entry", "ray_tpu_torch.kernels",
               "ray_tpu_torch.accelerators", "ray_tpu_torch.accelerators.gpu",
               "ray_tpu_torch.collective", "ray_tpu_torch.collective.torch_group",
               "ray_tpu_torch.train", "ray_tpu_torch.train.worker",
               "ray_tpu_torch.train.trainer"]


def test_import_leaves_jax_and_ray_tpu_out():
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in SUBPACKAGES)
        + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'jaxlib', 'ray_tpu'))\n"
          "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def _sources():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "ray_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_source_scan_finds_no_jax_or_ray_tpu_import():
    found = []
    scanned = {os.path.relpath(os.path.dirname(p), ROOT) for p in _sources()}
    for sub in SUBPACKAGES:  # every subpackage directory is scanned
        if os.path.isdir(os.path.join(ROOT, *sub.split("."))):
            assert os.path.join(*sub.split(".")) in scanned, sub
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "ray_tpu"):
                    found.append(f"{os.path.relpath(path, ROOT)}:{node.lineno} {name}")
    assert not found, found


def test_resolve_device_raises_without_cuda(monkeypatch):
    from ray_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_llm_exports_match_jax():
    """ray_tpu_torch.llm exports every name of ray_tpu.llm but the
    scheduler's two, which ride on the JAX package's actor runtime."""
    import ray_tpu.llm as jllm

    import ray_tpu_torch.llm as tllm

    assert set(tllm.__all__) == set(jllm.__all__) - {"DisaggLLMServer",
                                                     "build_disagg_deployment"}
    assert all(hasattr(tllm, n) for n in tllm.__all__)
    assert tllm.prefix_hint is not None
