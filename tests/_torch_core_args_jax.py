"""What a task, a kwarg, an actor method and an actor constructor receive
for a by-value argument of 1 MiB on JAX's runtime, for the large-argument
cases of ``tests/test_torch_core.py``. Not a test module.

    python tests/_torch_core_args_jax.py <out.json>

Starts a fresh ``ray_tpu`` runtime in this process, passes ``arg(kind)``
(1 MiB of float32, as a numpy array or a torch tensor) down each path
(``digest_task``, ``digest_kwarg`` and ``Digester``, which the test makes
remote on the port's runtime as this script does on JAX's),
and writes ``{"<path>/<kind>": digest}``: the type, dtype, shape and
sha256 of what arrived, and a numpy array's ``writeable`` flag. The path
``actor_ctor_restarted`` is what the constructor of an actor with
``max_restarts=1`` receives after its process was killed. JAX's runtime
sends every such argument by value; the port seals it into its arena, and
the test holds what arrives there to what arrives here.
"""
import faulthandler
import json
import os
import signal
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARG_ELEMS = 1 << 18  # float32: 1 MiB, ten times the inline limit
PATHS = ("task", "kwarg", "actor_method", "actor_ctor")
KINDS = ("numpy", "torch")


def arg(kind: str, n: int = ARG_ELEMS):
    a = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    if kind == "torch":
        import torch

        return torch.from_numpy(a)
    return a


def digest(x) -> list:
    """What arrived, down to the bits; a numpy array's flag too, which a
    by-value argument has read-only. As JSON gives it back."""
    import hashlib

    a = x if isinstance(x, np.ndarray) else x.numpy()
    return [type(x).__name__, str(a.dtype), list(a.shape),
            hashlib.sha256(a.tobytes()).hexdigest(),
            bool(a.flags.writeable) if type(x) is np.ndarray else None]


def digest_task(x):
    return digest(x)


def digest_kwarg(*, x):
    return digest(x)


class Digester:
    """An actor that keeps what its constructor received."""

    def __init__(self, x=None):
        self.first = None if x is None else digest(x)

    def first_digest(self):
        return self.first

    def digest(self, x):
        return digest(x)

    def pid(self):
        return os.getpid()


def restarted_digest(rt, actor, timeout: float = 60.0) -> list:
    """Kill ``actor``'s process, then what its next incarnation's
    constructor received."""
    pid = rt.get(actor.pid.remote(), timeout=timeout)
    os.kill(pid, signal.SIGKILL)
    deadline = time.monotonic() + timeout
    while True:
        try:
            if rt.get(actor.pid.remote(), timeout=timeout) != pid:
                return rt.get(actor.first_digest.remote(), timeout=timeout)
        except Exception:  # the restart is under way
            if time.monotonic() > deadline:
                raise
        time.sleep(0.2)


def main() -> int:
    faulthandler.dump_traceback_later(100, exit=True)
    sys.path.insert(0, ROOT)
    import dataclasses

    import ray_tpu as rt
    from ray_tpu import config

    config.set_config(dataclasses.replace(config.get_config(), worker_lease_timeout_s=1.0))

    task, kwarg, actor_cls = (rt.remote(f) for f in (digest_task, digest_kwarg, Digester))
    rt.init(num_cpus=2)
    out = {}
    try:
        for kind in KINDS:
            x = arg(kind)
            out[f"task/{kind}"] = rt.get(task.remote(x), timeout=60)
            out[f"kwarg/{kind}"] = rt.get(kwarg.remote(x=x), timeout=60)
            actor = actor_cls.remote()
            out[f"actor_method/{kind}"] = rt.get(actor.digest.remote(x), timeout=60)
            rt.kill(actor)
            actor = actor_cls.remote(x)
            out[f"actor_ctor/{kind}"] = rt.get(actor.first_digest.remote(), timeout=60)
            rt.kill(actor)
        actor = actor_cls.options(max_restarts=1).remote(arg("numpy"))
        out["actor_ctor_restarted/numpy"] = restarted_digest(rt, actor)
        rt.kill(actor)
    finally:
        rt.shutdown()
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
