"""ray_tpu_torch.autoscaler — demand-driven cluster scaling.

The port's copy of ``ray_tpu/autoscaler`` (ref:
python/ray/autoscaler/v2/ — instance-manager reconciler over a
NodeProvider). The scaling signal is per-node queued lease demand
reported through raylet heartbeats (a lease no node can hold parks on the
raylet it reached, and moves to a node that joins and can hold it); the
reconciler adds nodes while demand persists and drains idle ones after a
timeout. Providers are pluggable: LocalSubprocessProvider launches real
raylet subprocesses (``start --head --autoscale MIN:MAX``, and the tests);
GKEGPUNodeProvider scales GKE node pools of GPU VMs behind the same
methods.
"""
from ray_tpu_torch.autoscaler.autoscaler import Autoscaler, AutoscalerConfig
from ray_tpu_torch.autoscaler.gke import GKEGPUNodeProvider
from ray_tpu_torch.autoscaler.instance_manager import Instance, InstanceManager
from ray_tpu_torch.autoscaler.node_provider import LocalSubprocessProvider, NodeProvider

__all__ = [
    "Autoscaler",
    "AutoscalerConfig",
    "GKEGPUNodeProvider",
    "Instance",
    "InstanceManager",
    "LocalSubprocessProvider",
    "NodeProvider",
]
