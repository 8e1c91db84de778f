"""Remote-driver client (the Ray Client role, ref: python/ray/util/client/
gRPC proxy + ARCHITECTURE.md), over the port's client mode
(``init(..., _client_mode=True)``).

A driver on a machine OUTSIDE the cluster connects with::

    import ray_tpu_torch.client
    ctx = ray_tpu_torch.client.connect("head-host:6379")
    ... ray_tpu_torch.remote / get / put / actors as usual ...
    ctx.disconnect()

Architecture difference from the reference: no proxy process. The wire
protocol is already network-transparent (length-prefixed pickle RPC with a
version handshake), so the remote driver speaks directly to the GCS, the
head raylet, and its leased workers. What changes in client mode:

- no shm attach: objects the driver owns live in its in-process memory
  store and are owner-served to borrowers over RPC;
- shm-resident results (large task returns, borrowed large objects) are
  materialized through the raylet's chunked transfer RPCs (pull to the
  raylet arena, then stream);
- everything else (leases, actors, placement groups, collectives metadata)
  already rides RPC.

The driver must be network-reachable from cluster nodes (workers dial the
owner back for argument fetches), as with any multi-node deployment.
"""

from __future__ import annotations

from ray_tpu_torch.core import api as _api


class ClientContext:
    """Handle for an active remote-driver connection."""

    def __init__(self, address: str):
        self.address = address
        self._connected = True

    def disconnect(self) -> None:
        if self._connected:
            _api.shutdown()
            self._connected = False

    def __enter__(self) -> "ClientContext":
        return self

    def __exit__(self, *exc) -> None:
        self.disconnect()


def connect(address: str, *, runtime_env: dict | None = None) -> ClientContext:
    """Attach this process to a remote cluster as a client-mode driver.

    ``address`` is the GCS address ("host:port"). Returns a ClientContext;
    use it as a context manager or call .disconnect().
    """
    _api.init(address, runtime_env=runtime_env, _client_mode=True)
    return ClientContext(address)
