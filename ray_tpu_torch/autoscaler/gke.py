"""GKE GPU node-pool provider.

The port's counterpart of ``ray_tpu/autoscaler/gke.py``
(``GKETPUPodProvider``): each autoscaled "node" is a GKE *node pool* of
one VM with its cards attached (ref role:
python/ray/autoscaler/batching_node_provider.py + the KubeRay provider).
A TPU slice is the unit ICI comes in; a GPU VM is the unit NVLink comes
in, so one pool holds one VM and there is no ``tpuTopology`` placement.

All cloud traffic goes through an injectable ``transport`` callable
``(method, path, body) -> dict`` speaking the GKE REST surface
(container.googleapis.com v1), so tests drive the full provider +
instance-manager + reconciler stack against a fake cloud, and production
supplies :func:`gcp_transport` (metadata-server auth). Node types come
from a static table of GKE's public GPU machine types.
"""

from __future__ import annotations

import json
import urllib.request

from ray_tpu_torch.autoscaler.node_provider import NodeProvider

# node type -> (gke machine type, acceleratorType, cards per VM), from
# Google Cloud's public GPU machine-type documentation (A3, A2, G2 series)
GPU_NODE_TYPES = {
    "h100-80gb-1": ("a3-highgpu-1g", "nvidia-h100-80gb", 1),
    "h100-80gb-2": ("a3-highgpu-2g", "nvidia-h100-80gb", 2),
    "h100-80gb-4": ("a3-highgpu-4g", "nvidia-h100-80gb", 4),
    "h100-80gb-8": ("a3-highgpu-8g", "nvidia-h100-80gb", 8),
    "h100-mega-80gb-8": ("a3-megagpu-8g", "nvidia-h100-mega-80gb", 8),
    "a100-40gb-1": ("a2-highgpu-1g", "nvidia-tesla-a100", 1),
    "a100-40gb-8": ("a2-highgpu-8g", "nvidia-tesla-a100", 8),
    "a100-80gb-1": ("a2-ultragpu-1g", "nvidia-a100-80gb", 1),
    "a100-80gb-8": ("a2-ultragpu-8g", "nvidia-a100-80gb", 8),
    "l4-1": ("g2-standard-8", "nvidia-l4", 1),
    "l4-4": ("g2-standard-48", "nvidia-l4", 4),
}

POOL_PREFIX = "rt-gpu-"


def gcp_transport(method: str, path: str, body: dict | None = None) -> dict:
    """Production transport: metadata-server token + container API."""
    tok = urllib.request.urlopen(urllib.request.Request(
        "http://metadata.google.internal/computeMetadata/v1/instance/"
        "service-accounts/default/token",
        headers={"Metadata-Flavor": "Google"}), timeout=10)
    token = json.loads(tok.read())["access_token"]
    req = urllib.request.Request(
        "https://container.googleapis.com/v1" + path,
        method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Authorization": f"Bearer {token}",
                 "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read() or b"{}")


class GKEGPUNodeProvider(NodeProvider):
    """Scales GPU VMs as GKE node pools.

    One ``create_node`` = one node pool = one VM with its cards; the
    raylet bootstrapped on it (via the pool's node labels -> startup
    DaemonSet, outside this provider's scope) counts the cards itself and
    registers with the node label ``instance=<pool name>``, which
    :meth:`matches` uses to link GCS rows back to instances."""

    def __init__(self, project: str, location: str, cluster: str,
                 node_type: str = "h100-80gb-8",
                 transport=gcp_transport):
        if node_type not in GPU_NODE_TYPES:
            raise ValueError(
                f"unknown node_type {node_type!r}; known: "
                f"{sorted(GPU_NODE_TYPES)}")
        self.parent = (f"/projects/{project}/locations/{location}"
                       f"/clusters/{cluster}")
        self.node_type = node_type
        self.transport = transport
        # Pool names must survive provider restarts: a counter alone can
        # collide with rt-gpu-* pools left by a previous autoscaler run
        # started within the same second (GKE would 409 → surface as
        # ALLOCATION_FAILED). A per-provider random token makes every
        # incarnation's names disjoint without an extra startup GET.
        import uuid

        self._counter = 0
        self._token = uuid.uuid4().hex[:6]
        # pool name -> last create/delete operation name (poll handles)
        self._ops: dict[str, str] = {}

    # --------------------------------------------------------------- CRUD
    def create_node(self, resources: dict | None = None) -> str:
        machine, accelerator, cards = GPU_NODE_TYPES[self.node_type]
        self._counter += 1
        name = f"{POOL_PREFIX}{self._token}-{self._counter}"
        body = {
            "nodePool": {
                "name": name,
                "initialNodeCount": 1,
                "config": {
                    "machineType": machine,
                    # int64 fields travel as strings in the API's JSON
                    "accelerators": [{"acceleratorType": accelerator,
                                      "acceleratorCount": str(cards)}],
                    # the node bootstrap propagates this node label to the
                    # raylet's --labels, which matches() joins on
                    "labels": {"instance": name},
                },
            }
        }
        op = self.transport("POST", f"{self.parent}/nodePools", body)
        self._ops[name] = op.get("name", "")
        return name

    def terminate_node(self, provider_node_id: str) -> None:
        op = self.transport(
            "DELETE", f"{self.parent}/nodePools/{provider_node_id}", None)
        self._ops[provider_node_id] = op.get("name", "")

    def non_terminated_nodes(self) -> list[str]:
        reply = self.transport("GET", f"{self.parent}/nodePools", None)
        out = []
        for pool in reply.get("nodePools", []):
            if not pool.get("name", "").startswith(POOL_PREFIX):
                continue  # never touch pools this provider didn't create
            if pool.get("status") in ("PROVISIONING", "RUNNING",
                                      "RECONCILING"):
                out.append(pool["name"])
        return out

    def matches(self, provider_node_id: str, gcs_node: dict) -> bool:
        labels = gcs_node.get("labels", {}) or {}
        return labels.get("instance") == provider_node_id

    def shutdown(self):
        pass  # node pools outlive the autoscaler process by design
