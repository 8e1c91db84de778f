"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu.

A package beside ``ray_tpu`` that imports ``torch`` (never ``jax``, and
nothing of ``ray_tpu``) and mirrors its layout, every module of
``ray_tpu`` with a counterpart: the task/actor runtime (``core``,
``_native``, ``config``, ``runtime_env``, ``util`` with its
``multiprocessing.Pool``, ``devtools``' chaos engine, process killers,
churn harness and ``lint``, the static analyzer raylint), ``autoscaler`` (a local raylet provider and a GKE GPU
node-pool provider), ``sharded``, ``ops``, ``models``, ``llm``, ``serve``,
``data``, ``dag``, ``parallel``, ``collective``, ``train``, ``tune``
(with ``air``'s logger callbacks), ``workflow``, ``rllib``,
``accelerators`` and ``utils``, and the operator's surface: ``state`` (the
state API and timeline), ``job`` (job submission), ``dashboard`` (its
JSON API and ``dashboard_client/`` SPA on the standard library's HTTP
server), ``client`` (remote drivers) and the command line
(``python -m ray_tpu_torch start [--autoscale MIN:MAX]|stop|status|list|
summary|timeline|dashboard|job|serve|chaos|lint``, ``scripts.py``). Every
Pallas TPU kernel on a ported path becomes a kernel written by hand for Hopper (``csrc/``,
built by ``kernels``). Entry points run on the CUDA card unless the caller passes
``device="cpu"``; the runtime's ``num_gpus`` leases whole cards through
``CUDA_VISIBLE_DEVICES``.

The top-level API (``init``, ``remote``, ``get``, ``put``, ``wait``,
``kill``, ``put_sharded``, ``get_sharded``, ``reshard``, ...) is
``ray_tpu_torch.core.api``'s, imported on first use so that ``import
ray_tpu_torch`` stays cheap (no torch import).
"""

from ray_tpu_torch._version import __version__  # noqa: F401


def __getattr__(name):
    # Lazy top-level API: keep `import ray_tpu_torch` cheap (no torch import).
    try:
        from ray_tpu_torch.core import api as _api
    except ImportError:
        raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}") from None

    if hasattr(_api, name):
        return getattr(_api, name)
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")
