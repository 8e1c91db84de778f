"""The PyTorch port stands alone: it imports neither jax nor ray_tpu."""

import ast
import os
import re
import subprocess
import sys

import pytest
import torch

from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse

# slowest test 7.0 s, no module set-up (the port's modules alone under -n 6);
# the limits are several times that, so one that fires names a stalled test
_module_limit, _test_limit = time_limits(module_s=120, test_s=90)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ["ray_tpu_torch", "ray_tpu_torch.ops", "ray_tpu_torch.models",
               "ray_tpu_torch.llm", "ray_tpu_torch.llm.disagg",
               "ray_tpu_torch.serve", "ray_tpu_torch.data", "ray_tpu_torch.data.block",
               "ray_tpu_torch.data.executor", "ray_tpu_torch.data.optimizer",
               "ray_tpu_torch.data.iterator", "ray_tpu_torch.data.split",
               "ray_tpu_torch.data.dataset", "ray_tpu_torch.llm.batch",
               "ray_tpu_torch.parallel", "ray_tpu_torch.parallel.comm",
               "ray_tpu_torch.parallel.mesh", "ray_tpu_torch.parallel.sharding",
               "ray_tpu_torch.parallel.ring_attention", "ray_tpu_torch.parallel.ulysses",
               "ray_tpu_torch.parallel.pipeline", "ray_tpu_torch.parallel.moe",
               "ray_tpu_torch.utils", "ray_tpu_torch.utils.serialization",
               "ray_tpu_torch.entry", "ray_tpu_torch.kernels",
               "ray_tpu_torch.accelerators", "ray_tpu_torch.accelerators.gpu",
               "ray_tpu_torch.collective", "ray_tpu_torch.collective.torch_group",
               "ray_tpu_torch.collective.collective",
               "ray_tpu_torch.train", "ray_tpu_torch.train.worker",
               "ray_tpu_torch.train.trainer",
               "ray_tpu_torch.rllib", "ray_tpu_torch.rllib.envs", "ray_tpu_torch.rllib.core",
               "ray_tpu_torch.rllib.connectors", "ray_tpu_torch.rllib.replay_buffer",
               "ray_tpu_torch.rllib.env_runner", "ray_tpu_torch.rllib.learner",
               "ray_tpu_torch.rllib.ppo", "ray_tpu_torch.rllib.dqn",
               "ray_tpu_torch.rllib.impala", "ray_tpu_torch.rllib.appo",
               "ray_tpu_torch.rllib.sac", "ray_tpu_torch.rllib.multi_agent",
               "ray_tpu_torch.rllib.offline",
               "ray_tpu_torch.core", "ray_tpu_torch.core.api", "ray_tpu_torch.core.worker",
               "ray_tpu_torch.core.raylet", "ray_tpu_torch.core.gcs",
               "ray_tpu_torch.core.core_client", "ray_tpu_torch.core.cluster",
               "ray_tpu_torch.core.object_store", "ray_tpu_torch.core.ref",
               "ray_tpu_torch.core.policy", "ray_tpu_torch.core.tiering",
               "ray_tpu_torch.core.memory_monitor", "ray_tpu_torch.core.cgroup",
               "ray_tpu_torch.core.gcs_store", "ray_tpu_torch.core.metrics_store",
               "ray_tpu_torch.core.fastpath", "ray_tpu_torch.core.tunnel",
               "ray_tpu_torch._native", "ray_tpu_torch._version", "ray_tpu_torch.config",
               "ray_tpu_torch.runtime_env", "ray_tpu_torch.devtools",
               "ray_tpu_torch.devtools.chaos", "ray_tpu_torch.devtools.chaos.controller",
               "ray_tpu_torch.devtools.chaos.plan", "ray_tpu_torch.util",
               "ray_tpu_torch.util.scheduling_strategies", "ray_tpu_torch.util.actor_pool",
               "ray_tpu_torch.util.queue", "ray_tpu_torch.utils.ids", "ray_tpu_torch.utils.aio",
               "ray_tpu_torch.utils.rpc", "ray_tpu_torch.utils.schema",
               "ray_tpu_torch.utils.metrics", "ray_tpu_torch.utils.recorder",
               "ray_tpu_torch.utils.tracing",
               "ray_tpu_torch.sharded", "ray_tpu_torch.sharded.manifest",
               "ray_tpu_torch.sharded.plane", "ray_tpu_torch.sharded.reshard",
               "ray_tpu_torch.sharded.submit", "ray_tpu_torch.sharded.telemetry",
               "ray_tpu_torch.serve.context", "ray_tpu_torch.serve.schema",
               "ray_tpu_torch.serve.multiplex", "ray_tpu_torch.serve.replica",
               "ray_tpu_torch.serve.controller", "ray_tpu_torch.serve.handle",
               "ray_tpu_torch.serve.http_proxy", "ray_tpu_torch.serve.grpc_proxy",
               "ray_tpu_torch.serve.dataplane", "ray_tpu_torch.serve.dataplane.admission",
               "ray_tpu_torch.serve.dataplane.slo", "ray_tpu_torch.serve.dataplane.fastlane",
               "ray_tpu_torch.serve.dataplane.autoscaler", "ray_tpu_torch.serve.streaming",
               "ray_tpu_torch.serve.streaming.slo",
               "ray_tpu_torch.dag", "ray_tpu_torch.dag.channel", "ray_tpu_torch.dag.dag_node",
               "ray_tpu_torch.dag.compiled_dag", "ray_tpu_torch.dag.runner",
               "ray_tpu_torch.tune", "ray_tpu_torch.tune.search", "ray_tpu_torch.tune.schedulers",
               "ray_tpu_torch.tune.session", "ray_tpu_torch.tune.controller",
               "ray_tpu_torch.air", "ray_tpu_torch.air.integrations",
               "ray_tpu_torch.workflow", "ray_tpu_torch.workflow.api",
               "ray_tpu_torch.state", "ray_tpu_torch.job", "ray_tpu_torch.dashboard",
               "ray_tpu_torch.scripts", "ray_tpu_torch.client", "ray_tpu_torch.util.metrics",
               "ray_tpu_torch.devtools.chaos.cli",
               "ray_tpu_torch.autoscaler", "ray_tpu_torch.autoscaler.autoscaler",
               "ray_tpu_torch.autoscaler.instance_manager",
               "ray_tpu_torch.autoscaler.node_provider", "ray_tpu_torch.autoscaler.gke",
               "ray_tpu_torch.util.multiprocessing", "ray_tpu_torch.devtools.chaos.killers",
               "ray_tpu_torch.devtools.churn", "ray_tpu_torch.devtools.lint",
               "ray_tpu_torch.devtools.lint.cli", "ray_tpu_torch.devtools.lint.effects",
               "ray_tpu_torch.devtools.lint.engine", "ray_tpu_torch.devtools.lint.flow",
               "ray_tpu_torch.devtools.lint.rules"]
# the operator's surface: it serves from the card's host, which has no aiohttp
OPERATOR = ["ray_tpu_torch.state", "ray_tpu_torch.job", "ray_tpu_torch.dashboard",
            "ray_tpu_torch.scripts", "ray_tpu_torch.__main__", "ray_tpu_torch.client",
            "ray_tpu_torch.util.metrics", "ray_tpu_torch.devtools.chaos.cli"]


def test_import_leaves_jax_and_ray_tpu_out():
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in SUBPACKAGES)
        + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'jaxlib', 'ray_tpu', 'aiohttp'))\n"
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
            elif isinstance(node, ast.Constant) and isinstance(node.value, str) and \
                    re.fullmatch(r"(jax|jaxlib|ray_tpu)(\.\w+)+", node.value):
                # a module named in a string: `python -m ray_tpu.core.worker`
                # would start the JAX package's worker
                names = [node.value]
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
    """ray_tpu_torch.llm and ray_tpu_torch.llm.disagg export every name of
    ray_tpu.llm and ray_tpu.llm.disagg, the scheduler's two included."""
    import ray_tpu.llm as jllm
    import ray_tpu.llm.disagg as jdisagg

    import ray_tpu_torch.llm as tllm
    import ray_tpu_torch.llm.disagg as tdisagg

    assert set(tllm.__all__) == set(jllm.__all__)
    assert set(tdisagg.__all__) == set(jdisagg.__all__)
    assert tllm.DisaggLLMServer is tdisagg.DisaggLLMServer
    assert all(hasattr(tllm, n) for n in tllm.__all__)
    assert tllm.prefix_hint is not None


def test_data_exports_match_jax():
    """ray_tpu_torch.data exports exactly ray_tpu.data's names, in its
    order, and every one resolves."""
    import ray_tpu.data as jdata

    import ray_tpu_torch.data as tdata

    assert tdata.__all__ == jdata.__all__
    assert all(hasattr(tdata, n) for n in tdata.__all__)
    assert tdata.range is tdata.dataset.range


def test_dag_exports_match_jax():
    """ray_tpu_torch.dag exports every name of ray_tpu.dag, and an actor
    method's bind authors its graph node."""
    import ray_tpu.dag as jdag

    import ray_tpu_torch.dag as tdag
    from ray_tpu_torch.core.ref import ActorHandle, ActorMethod
    from ray_tpu_torch.utils.ids import ActorID

    assert tdag.__all__ == jdag.__all__
    assert all(hasattr(tdag, n) for n in tdag.__all__)
    handle = ActorHandle(ActorID.generate())  # no runtime: binding submits nothing
    node = ActorMethod(handle, "step").bind(tdag.InputNode(), 3)
    assert isinstance(node, tdag.ClassMethodNode)
    assert (node.actor_handle, node.method_name, node.args[1]) == (handle, "step", 3)


@pytest.mark.parametrize("package", ["tune", "air", "workflow"])
def test_tune_air_workflow_exports_match_jax(package):
    """ray_tpu_torch.tune, .air and .workflow export exactly the names of
    the JAX package's, in its order, and every one resolves."""
    import importlib

    ours = importlib.import_module(f"ray_tpu_torch.{package}")
    theirs = importlib.import_module(f"ray_tpu.{package}")
    assert ours.__all__ == theirs.__all__
    assert all(hasattr(ours, n) for n in ours.__all__)


def test_operator_modules_import_no_aiohttp():
    """The dashboard, the job path and the CLI import no aiohttp, anywhere
    in their source (not even inside a function, as serve's proxy does)."""
    found = []
    for mod in OPERATOR:
        path = os.path.join(ROOT, *mod.split(".")) + ".py"
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            found += [f"{mod}:{node.lineno} {n}" for n in names if n.split(".")[0] == "aiohttp"]
    assert not found, found


def _exports(mod) -> set:
    """A module's public names: its __all__, else what it defines itself
    (functions, classes, constants; not the modules and names it imports)."""
    import inspect

    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {n for n, v in vars(mod).items() if not n.startswith("_")
            and not inspect.ismodule(v) and getattr(v, "__module__", mod.__name__) == mod.__name__}


@pytest.mark.parametrize("name", ["state", "job", "dashboard", "client", "util.metrics"])
def test_operator_exports_match_jax(name):
    """state, job, dashboard, client and util.metrics export exactly the JAX
    package's names, and every one resolves."""
    import importlib

    ours = importlib.import_module(f"ray_tpu_torch.{name}")
    theirs = importlib.import_module(f"ray_tpu.{name}")
    assert _exports(ours) == _exports(theirs)
    assert all(hasattr(ours, n) for n in _exports(theirs))


# the GKE provider's TPU slice table and class become GPU ones
_GKE_RENAMES = {"GKETPUPodProvider": "GKEGPUNodeProvider", "TPU_SLICES": "GPU_NODE_TYPES"}


@pytest.mark.parametrize("name", ["autoscaler", "autoscaler.autoscaler",
                                  "autoscaler.instance_manager", "autoscaler.node_provider",
                                  "autoscaler.gke", "util.multiprocessing",
                                  "devtools.chaos.killers", "devtools.churn"])
def test_autoscaler_pool_killers_churn_exports_match_jax(name):
    """autoscaler/, util.multiprocessing, the killers and churn export the
    JAX package's names (the GKE provider's two renamed for GPUs), and
    every one resolves."""
    import importlib

    ours = importlib.import_module(f"ray_tpu_torch.{name}")
    theirs = importlib.import_module(f"ray_tpu.{name}")
    assert _exports(ours) == {_GKE_RENAMES.get(n, n) for n in _exports(theirs)}
    assert all(hasattr(ours, n) for n in _exports(ours))


def test_lint_exports_match_jax():
    """devtools.lint exports JAX's names (Finding, Rule, lint_paths,
    lint_source, register, rule_table, to_json, main), each from the
    port's own modules."""
    import ray_tpu.devtools.lint as jlint

    import ray_tpu_torch.devtools.lint as tlint

    names = {"Finding", "Rule", "lint_paths", "lint_source", "register", "rule_table",
             "to_json", "main"}
    theirs = {n for n in vars(jlint) if not n.startswith("_")
              and getattr(getattr(jlint, n), "__module__", "").startswith("ray_tpu.devtools.lint")}
    ours = {n for n in vars(tlint) if not n.startswith("_")
            and getattr(getattr(tlint, n), "__module__", "").startswith("ray_tpu_torch.devtools.lint")}
    assert ours == theirs == names
