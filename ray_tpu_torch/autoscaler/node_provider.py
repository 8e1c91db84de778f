"""Node providers: how the autoscaler creates and destroys nodes.

The port's copy of ``ray_tpu/autoscaler/node_provider.py`` (ref:
python/ray/autoscaler/node_provider.py NodeProvider,
_private/fake_multi_node/node_provider.py for the local variant). A local
node is a ``ray_tpu_torch.core.raylet`` process; it is given
``--num-gpus`` only when its resources name ``GPU``, and otherwise counts
the host's cards itself, as ``start`` does.
"""
from __future__ import annotations

import os
import subprocess
import sys


class NodeProvider:
    """Minimal provider surface the reconciler drives."""

    def create_node(self, resources: dict[str, float]) -> str:
        raise NotImplementedError

    def terminate_node(self, provider_node_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> list[str]:
        raise NotImplementedError

    def matches(self, provider_node_id: str, gcs_node: dict) -> bool:
        """Does this GCS cluster-view row belong to the given provider
        node? Providers link their instances to registered raylets their
        own way (local: pid; cloud: an ``instance`` node label)."""
        raise NotImplementedError


class LocalSubprocessProvider(NodeProvider):
    """Launches real raylet subprocesses against one GCS — scaling on a
    single machine (the reference's fake_multi_node provider role, but the
    nodes are real raylets with real stores and worker pools)."""

    def __init__(self, gcs_address: str, default_resources: dict[str, float] | None = None,
                 store_capacity: int | None = None):
        self.gcs_address = gcs_address
        self.default_resources = default_resources or {"CPU": 4.0}
        self.store_capacity = store_capacity
        self._procs: dict[str, subprocess.Popen] = {}
        self._counter = 0
        self._closed = False

    def create_node(self, resources: dict[str, float] | None = None) -> str:
        if self._closed:
            # a reconcile pass racing shutdown must not start an orphan
            raise RuntimeError("the provider is shut down")
        res = dict(resources or self.default_resources)
        env = dict(os.environ)
        pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_parent + os.pathsep + env.get("PYTHONPATH", "")
        cmd = [
            sys.executable, "-m", "ray_tpu_torch.core.raylet",
            "--gcs", self.gcs_address,
            "--num-cpus", str(res.get("CPU", 4.0)),
        ]
        extra = ",".join(f"{k}={v}" for k, v in res.items() if k not in ("CPU", "GPU"))
        if "GPU" in res:
            cmd += ["--num-gpus", str(res["GPU"])]
        if extra:
            cmd += ["--resources", extra]
        if self.store_capacity:
            cmd += ["--store-capacity", str(self.store_capacity)]
        proc = subprocess.Popen(cmd, env=env)
        self._counter += 1
        node_id = f"local-{self._counter}-{proc.pid}"
        self._procs[node_id] = proc
        return node_id

    def terminate_node(self, provider_node_id: str) -> None:
        """SIGTERM: the raylet ends its workers (a card worker's context
        with them), unlinks its arena and exits."""
        proc = self._procs.pop(provider_node_id, None)
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5)

    def non_terminated_nodes(self) -> list[str]:
        return [nid for nid, p in self._procs.items() if p.poll() is None]

    def pid_of(self, provider_node_id: str) -> int | None:
        proc = self._procs.get(provider_node_id)
        return proc.pid if proc is not None else None

    def matches(self, provider_node_id: str, gcs_node: dict) -> bool:
        pid = self.pid_of(provider_node_id)
        return pid is not None and int(gcs_node.get("pid", 0)) == pid

    def shutdown(self):
        self._closed = True
        for nid in list(self._procs):
            self.terminate_node(nid)
