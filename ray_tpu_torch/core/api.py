"""Public task/actor API: init, @remote, get/put/wait, actors, placement groups.

Equivalent of the reference's user-facing layer (ref: python/ray/_private/
worker.py init:1332 get:2757 put:2893 wait:2958 remote:3346,
remote_function.py:41, actor.py:708). The driver hosts its control-plane
sockets on a background event loop (EventLoopThread) and bridges the sync
API onto it.
"""

from __future__ import annotations

import atexit
import functools
import logging
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Iterable, Sequence

from ray_tpu_torch.accelerators.gpu import GPUAcceleratorManager
from ray_tpu_torch.config import Config, get_config, set_config
from ray_tpu_torch.core.core_client import CoreClient
from ray_tpu_torch.core.ref import ActorHandle, ObjectRef
# NOTE: ray_tpu_torch.util.scheduling_strategies is imported lazily inside the
# .remote() methods — ray_tpu_torch.util's __init__ defines @remote actors and
# importing it here would recurse during package initialization
from ray_tpu_torch.utils import rpc, serialization
from ray_tpu_torch.utils.ids import PlacementGroupID

log = logging.getLogger(__name__)

_GPU = GPUAcceleratorManager.get_resource_name()

_core: CoreClient | None = None
_io: rpc.EventLoopThread | None = None
_head_procs: list[subprocess.Popen] = []
_owned_cluster = None  # in-process Cluster when init() started one


def is_initialized() -> bool:
    return _core is not None


def get_core() -> CoreClient:
    if _core is None:
        init()
    return _core


def init(
    address: str | None = None,
    *,
    num_cpus: float | None = None,
    num_gpus: float | None = None,
    resources: dict[str, float] | None = None,
    object_store_memory: int | None = None,
    runtime_env: dict | None = None,
    _in_process: bool = True,
    _client_mode: bool = False,
) -> None:
    """Bring up (or connect to) a cluster and attach this driver.

    Head mode (address=None) starts a GCS and one raylet. With
    ``_in_process=True`` (default) they run on the driver's background event
    loop — same wire protocol, no subprocess cost; with False they are real
    subprocesses like the reference's `ray start` topology
    (ref: _private/node.py:1479 start_ray_processes).
    """
    global _core, _io, _owned_cluster
    if _core is not None:
        return
    if address is None:
        # drivers launched by `job submit` auto-join their cluster
        # (ref: RAY_ADDRESS honored by ray.init)
        address = os.environ.get("RT_ADDRESS") or None
    cfg = get_config()
    if object_store_memory:
        cfg.object_store_memory = object_store_memory
        set_config(cfg)

    # deterministic fault injection (devtools/chaos): the driver — and
    # with it every in-process GCS/raylet — arms here; subprocess nodes
    # and workers arm in their own mains off the serialized config
    from ray_tpu_torch.devtools import chaos

    chaos.maybe_arm()

    _io = rpc.EventLoopThread()

    if address is None:
        res = dict(resources or {})
        labels: dict[str, str] = {}
        if num_cpus is not None:
            res["CPU"] = float(num_cpus)
        res.setdefault("CPU", float(os.cpu_count() or 1) * 4)
        if num_gpus is not None:
            res[_GPU] = float(num_gpus)
        else:
            # autodetection: the visible cards + the accelerator-type
            # marker (a card has no slice topology, so no labels)
            for k, v in GPUAcceleratorManager.get_current_node_resources().items():
                res.setdefault(k, v)
        if _in_process:
            from ray_tpu_torch.core.cluster import Cluster

            _owned_cluster = Cluster(io=_io)
            _owned_cluster.add_node(resources=res, labels=labels)
            gcs_addr = _owned_cluster.gcs_address
            raylet_addr = _owned_cluster.raylets[0].server.address
        else:
            gcs_addr, raylet_addr = _start_head_processes(res, labels)
    else:
        host, port = address.rsplit(":", 1)
        gcs_addr = (host, int(port))
        raylet_addr = _find_local_raylet(_io, gcs_addr)

    core = CoreClient(loop=_io.loop, client_mode=_client_mode)
    _io.run(core.connect(gcs_addr, raylet_addr), timeout=cfg.rpc_connect_timeout_s + 5)
    _core = core
    if runtime_env:
        core.default_runtime_env = _package_runtime_env(core, runtime_env)
    atexit.register(shutdown)


def _package_runtime_env(core: CoreClient, env: dict) -> dict:
    """Zip + upload runtime_env packages once (ref: working_dir.py
    upload_package_if_needed)."""
    from ray_tpu_torch.runtime_env import package_runtime_env

    def kv_put(key: str, blob: bytes):
        core._run_sync(core.gcs.call(
            "kv_put",
            {"ns": "runtime_env_packages", "key": key, "value": blob,
             "overwrite": False},
        ))

    return package_runtime_env(env, kv_put)




def _start_head_processes(resources, labels=None) -> tuple[tuple[str, int], tuple[str, int]]:
    cfg = get_config()
    tmp = tempfile.mkdtemp(prefix="rt_head_")
    addr_file = os.path.join(tmp, "gcs_addr")
    env = dict(os.environ)
    env.update(cfg.to_env())
    pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = pkg_parent + os.pathsep + env.get("PYTHONPATH", "")
    gcs = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.core.gcs", "--address-file", addr_file], env=env
    )
    _head_procs.append(gcs)
    deadline = time.monotonic() + cfg.rpc_connect_timeout_s
    while not os.path.exists(addr_file):
        if time.monotonic() > deadline:
            raise TimeoutError("GCS did not start")
        time.sleep(0.05)
    with open(addr_file) as f:
        host, port = f.read().strip().rsplit(":", 1)
    gcs_addr = (host, int(port))
    res_arg = ",".join(f"{k}={v}" for k, v in resources.items() if k not in ("CPU", _GPU))
    cmd = [
        sys.executable, "-m", "ray_tpu_torch.core.raylet",
        "--gcs", f"{host}:{port}",
        "--num-cpus", str(resources.get("CPU", os.cpu_count() or 1)),
    ]
    if _GPU in resources:  # an explicit 0 too: the raylet counts cards only unasked
        cmd += ["--num-gpus", str(resources[_GPU])]
    if res_arg:
        cmd += ["--resources", res_arg]
    if labels:
        cmd += ["--labels", ",".join(f"{k}={v}" for k, v in labels.items())]
    raylet = subprocess.Popen(cmd, env=env)
    _head_procs.append(raylet)
    raylet_addr = _find_local_raylet(_io, gcs_addr)
    return gcs_addr, raylet_addr


def _find_local_raylet(io: rpc.EventLoopThread, gcs_addr) -> tuple[str, int]:
    cfg = get_config()

    async def find():
        conn = await rpc.connect(*gcs_addr, timeout=cfg.rpc_connect_timeout_s)
        try:
            deadline = time.monotonic() + cfg.rpc_connect_timeout_s
            while time.monotonic() < deadline:
                cluster = await conn.call("get_cluster", {})
                if cluster:
                    return tuple(cluster[0]["address"])
                import asyncio

                await asyncio.sleep(0.05)
            raise TimeoutError("no raylet registered with the GCS")
        finally:
            await conn.close()

    return io.run(find())


def shutdown() -> None:
    global _core, _io, _owned_cluster
    if _core is not None and _io is not None:
        try:
            _io.run(_core.close(), timeout=10)
        except Exception:
            log.debug("core close failed during shutdown", exc_info=True)
    _core = None
    if _owned_cluster is not None:
        try:
            _owned_cluster.shutdown()
        except Exception:
            log.debug("cluster shutdown failed", exc_info=True)
        _owned_cluster = None
    for p in _head_procs:
        try:
            p.terminate()
        except OSError:
            pass
    for p in _head_procs:  # reap: no zombies, and raylets finish shm cleanup
        try:
            p.wait(timeout=5)
        except (subprocess.TimeoutExpired, OSError):
            try:
                p.kill()
                p.wait(timeout=2)
            except (subprocess.TimeoutExpired, OSError):
                pass  # unkillable child: the OS reaps it at exit
    _head_procs.clear()
    if _io is not None:
        _io.stop()
        _io = None


# ---------------------------------------------------------------- data plane
def put(value: Any) -> ObjectRef:
    return get_core().put_value(value)


def get(refs, timeout: float | None = None):
    core = get_core()
    single = isinstance(refs, ObjectRef)
    ref_list = [refs] if single else list(refs)
    for r in ref_list:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"ray_tpu_torch.get takes ObjectRefs, got {type(r)}")
    start = time.monotonic()
    # fast-path refs resolve straight off the shm reply rings, in this
    # thread, without a loop round-trip (see core/fastpath.py)
    fast = core.fast_prepass(ref_list, timeout)
    # completion fast lane: anything already local (ready memory-store
    # entries, sealed local shm results) resolves on this thread too —
    # the loop round-trip is only paid for genuinely remote/pending refs
    if len(fast) < len(ref_list):
        fast.update(core.get_local_prepass(
            [r for r in ref_list if r.id not in fast]))
    # promise refs (the serve router's retry-loop refs) resolve on this
    # thread off their threading.Event twin — but only when EVERY
    # pending ref is promise-backed: a mixed list must go through
    # get_async so promise waits and remote pulls overlap (a serial
    # prepass here would degrade mixed-list latency from max toward sum)
    pending = [r for r in ref_list if r.id not in fast]
    if pending and all(
            getattr(core.memory_store.get(r.id), "t_ready", None) is not None
            for r in pending):
        remaining = (None if timeout is None
                     else max(0.0, timeout - (time.monotonic() - start)))
        fast.update(core.promise_prepass(pending, remaining))
    slow_refs = ([r for r in ref_list if r.id not in fast]
                 if fast else ref_list)
    slow_values = []
    if slow_refs:
        remaining = (None if timeout is None
                     else max(0.0, timeout - (time.monotonic() - start)))
        slow_values = core._run_sync(
            core.get_async(slow_refs, remaining), timeout=None)
    if not fast:
        return slow_values[0] if single else slow_values
    it = iter(slow_values)
    values = []
    for r in ref_list:
        hit = fast.get(r.id)
        if hit is None:
            values.append(next(it))
        elif hit[0] == "v":
            values.append(serialization.unpack(hit[1]))
        elif hit[0] == "V":
            values.append(hit[1])
        else:
            raise hit[1]
    return values[0] if single else values


async def _async_get(ref: ObjectRef):
    import asyncio

    core = get_core()
    if _in_core_loop(core):
        values = await core.get_async([ref], None)
        return values[0]
    # foreign event loop (driver asyncio code, a user loop in a worker
    # thread): the core client's wait primitives are affine to the core
    # loop — run the get THERE and await the bridged future here, else
    # completion wakeups land on a loop that is not running this task
    # and the await never resolves
    fut = asyncio.run_coroutine_threadsafe(core.get_async([ref], None),
                                           core.loop)
    values = await asyncio.wrap_future(fut)
    return values[0]


def _in_core_loop(core) -> bool:
    import asyncio

    try:
        return asyncio.get_running_loop() is core.loop
    except RuntimeError:
        return False


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: float | None = None,
    fetch_local: bool = True,
):
    core = get_core()
    refs = list(refs)
    if num_returns > len(refs):
        raise ValueError("num_returns > len(refs)")
    # completion fast lane: ready refs are counted on this thread, and a
    # shortfall made up purely of fast-lane in-flight refs waits on the
    # reply-stream condition variable (ring completions wake it) — the
    # loop path is only for refs it alone can resolve (borrowed, RPC)
    res = core.fast_wait_prepass(refs, num_returns, timeout)
    if res is not None:
        return res
    return core._run_sync(core.wait_async(refs, num_returns, timeout, fetch_local))


# ------------------------------------------------------------------- tasks
class SubmitTemplate:
    """Frozen per-handle submission state (ref: the SchedulingKey /
    lease-cache pairing in normal_task_submitter.h — the reference
    resolves a task's scheduling identity once and reuses it for every
    steady-state push).

    Everything a ``.remote()`` call used to re-derive per call — the
    resources dict, the normalized scheduling strategy, the placement
    target, the registered function id and the ring scheduling key — is
    resolved ONCE here, at the first ``.remote()`` of a handle.

    Invalidation story (each falls back to the slow RPC path, which stays
    the source of truth):
      * ``.options()`` fork → a NEW RemoteFunction → its own template;
      * runtime_env / core change → ``env_token``/``core`` mismatch on the
        next call rebuilds the template;
      * worker death mid-flight → the fast lane breaks and in-flight ring
        records replay over RPC (core_client._fast_break_lane); the
        template itself stays valid.
    """

    __slots__ = ("core", "env_token", "func_id", "resources", "sched_key",
                 "num_returns", "max_retries", "placement_group",
                 "bundle_index", "scheduling_node", "scheduling_strategy",
                 "name", "runtime_env", "fast_ok")


class RemoteFunction:
    """Handle produced by @remote on a function (ref: remote_function.py:41)."""

    def __init__(self, fn, **default_opts):
        self._fn = fn
        self._opts = default_opts
        self._tmpl: SubmitTemplate | None = None
        functools.update_wrapper(self, fn)

    def __getstate__(self):
        # the template pins the driver's CoreClient: never ship it with a
        # handle that travels to a worker (it rebuilds there on first use)
        state = self.__dict__.copy()
        state["_tmpl"] = None
        return state

    def options(self, **opts) -> "RemoteFunction":
        merged = {**self._opts, **opts}
        return RemoteFunction(self._fn, **merged)

    def remote(self, *args, **kwargs):
        core = get_core()
        tmpl = self._tmpl
        if (tmpl is None or tmpl.core is not core
                or tmpl.env_token is not core.default_runtime_env):
            tmpl = self._tmpl = self._build_template(core)
        return core.submit_template(tmpl, self._fn, args, kwargs)

    def _build_template(self, core) -> SubmitTemplate:
        o = self._opts
        resources = dict(o.get("resources") or {})
        resources["CPU"] = float(o.get("num_cpus", 1.0))
        if o.get("num_gpus"):
            resources[_GPU] = float(o["num_gpus"])
        from ray_tpu_torch.util import scheduling_strategies

        pg = o.get("placement_group")
        strategy = o.get("scheduling_strategy")
        bundle_index = o.get("placement_group_bundle_index", -1)
        if isinstance(strategy, scheduling_strategies.
                      PlacementGroupSchedulingStrategy):
            pg = strategy.placement_group
            bundle_index = strategy.placement_group_bundle_index
        t = SubmitTemplate()
        t.core = core
        t.env_token = core.default_runtime_env
        t.resources = resources
        t.num_returns = o.get("num_returns", 1)
        t.max_retries = o.get("max_retries")
        t.placement_group = pg.id if isinstance(pg, PlacementGroup) else pg
        t.bundle_index = bundle_index
        t.scheduling_node = o.get("_scheduling_node")
        t.scheduling_strategy = scheduling_strategies.normalize(strategy)
        t.name = o.get("name")
        t.runtime_env = o.get("runtime_env")
        t.func_id = None
        t.sched_key = None
        # a custom max_retries does NOT disqualify the fast path: the
        # driver-side lineage tuple carries the budget, and break-lane
        # recovery resubmits with it (chaos kill schedules exposed the
        # earlier config-default reset)
        t.fast_ok = (
            t.num_returns == 1 and t.placement_group is None
            and t.scheduling_node is None and t.runtime_env is None
            and t.scheduling_strategy is None and t.name is None)
        if t.fast_ok:
            # register now (once per template) so steady-state calls skip
            # the per-call registration probe entirely
            t.func_id = core._register_function(self._fn)
            t.fast_ok = bool(getattr(self._fn, "__rt_fast_ok__", False))
            if t.fast_ok:
                t.sched_key = (t.func_id,
                               tuple(sorted(resources.items())),
                               None, -1, None, None)
        return t

    def __call__(self, *a, **k):
        raise TypeError(
            "remote functions cannot be called directly; use .remote() "
            "or call the original function"
        )


class ActorClass:
    """Handle produced by @remote on a class (ref: actor.py:708)."""

    def __init__(self, cls, **default_opts):
        self._cls = cls
        self._opts = default_opts

    def options(self, **opts) -> "ActorClass":
        return ActorClass(self._cls, **{**self._opts, **opts})

    def remote(self, *args, **kwargs) -> ActorHandle:
        from ray_tpu_torch.util import scheduling_strategies

        o = self._opts
        pg = o.get("placement_group")
        strategy = o.get("scheduling_strategy")
        bundle_index = o.get("placement_group_bundle_index", -1)
        if isinstance(strategy, scheduling_strategies.
                      PlacementGroupSchedulingStrategy):
            pg = strategy.placement_group
            bundle_index = strategy.placement_group_bundle_index
        return get_core().create_actor(
            self._cls,
            args,
            kwargs,
            num_cpus=float(o.get("num_cpus", 1.0)),
            resources=_actor_resources(o),
            name=o.get("name"),
            max_restarts=int(o.get("max_restarts", 0)),
            max_concurrency=int(o.get("max_concurrency", 1)),
            placement_group=pg.id if isinstance(pg, PlacementGroup) else pg,
            bundle_index=bundle_index,
            get_if_exists=bool(o.get("get_if_exists", False)),
            lifetime=o.get("lifetime"),
            runtime_env=o.get("runtime_env"),
            concurrency_groups=o.get("concurrency_groups"),
            scheduling_strategy=scheduling_strategies.normalize(strategy),
        )


def method(*, concurrency_group: str | None = None,
           num_returns: int | None = None):
    """Annotate an actor method (ref: ray.method): assign it to a named
    concurrency group declared in @remote(concurrency_groups={...}) and/or
    fix its num_returns."""

    def deco(fn):
        fn.__rt_method_opts__ = {
            "concurrency_group": concurrency_group,
            "num_returns": num_returns,
        }
        return fn

    return deco


def _actor_resources(o: dict) -> dict:
    resources = dict(o.get("resources") or {})
    if o.get("num_gpus"):
        resources[_GPU] = float(o["num_gpus"])
    return resources


def remote(*args, **options):
    """@ray_tpu_torch.remote decorator for functions and classes.

    ``in_specs``/``out_specs`` (spec tuples) switch the handle onto the
    sharded object plane: one task per shard, routed to the node holding
    it, with resharding on spec disagreement (see
    ray_tpu_torch/sharded/submit.py)."""

    def wrap(obj):
        if "in_specs" in options or "out_specs" in options:
            if isinstance(obj, type):
                raise TypeError(
                    "in_specs/out_specs apply to functions; shard actor "
                    "inputs by passing ShardedObjectRefs to methods")
            from ray_tpu_torch.sharded.submit import ShardedFunction

            return ShardedFunction(obj, options)
        if isinstance(obj, type):
            return ActorClass(obj, **options)
        return RemoteFunction(obj, **options)

    if len(args) == 1 and not options and callable(args[0]):
        return wrap(args[0])
    return wrap


# ---------------------------------------------------------- sharded plane
def put_sharded(value, **kw):
    """Store a sharded array as per-host shm shards behind ONE manifest
    (see ray_tpu_torch/sharded/plane.py). Never serializes the global
    array."""
    from ray_tpu_torch.sharded import plane

    return plane.put_sharded(value, **kw)


def get_sharded(sref, **kw):
    """The value of a ShardedObjectRef: the global tensor stitched on a
    device (``mesh=MeshSpec``), or this rank's ``DTensor`` (``mesh=``
    a ``DeviceMesh``)."""
    from ray_tpu_torch.sharded import plane

    return plane.get_sharded(sref, **kw)


def reshard(sref, spec, **kw):
    """Redistribute a ShardedObjectRef to a new spec (no driver
    gather-scatter)."""
    from ray_tpu_torch.sharded.reshard import reshard as _reshard

    return _reshard(sref, spec, **kw)


class CppFunction:
    """Cross-language handle for a task implemented in a C++ worker binary
    (ref: cpp/ worker API + cross_language call surface). The function is
    resolved worker-side from the binary's RT_REMOTE registry by name."""

    def __init__(self, name: str, *, num_returns: int = 1,
                 resources: dict | None = None):
        self._name = name
        self._num_returns = num_returns
        self._resources = resources

    def options(self, *, num_returns: int | None = None,
                resources: dict | None = None) -> "CppFunction":
        return CppFunction(
            self._name,
            num_returns=self._num_returns if num_returns is None else num_returns,
            resources=self._resources if resources is None else resources,
        )

    def remote(self, *args):
        return get_core().submit_task(
            ("cpp", self._name), args, {},
            num_returns=self._num_returns,
            resources=self._resources,
            max_retries=0,  # native tasks: no automatic re-execution yet
        )


def cpp_function(name: str, **options) -> CppFunction:
    """Handle to a C++ task registered as ``name`` via RT_REMOTE in the
    cluster's C++ worker binary (configured with RT_CPP_WORKER)."""
    return CppFunction(name, **options)


def cancel(ref: ObjectRef, *, force: bool = False) -> None:
    """Cancel a task (ref: ray.cancel): queued tasks complete with
    TaskCancelledError; with force=True an executing task's worker is
    killed. Actor tasks cannot be cancelled (matches the reference's
    default actor-task semantics)."""
    get_core().cancel_task(ref, force=force)


class RuntimeContext:
    """(ref: ray.runtime_context.RuntimeContext)"""

    def __init__(self, core):
        self._core = core

    @property
    def job_id(self):
        return self._core.job_id

    @property
    def node_id(self):
        return self._core.node_id

    @property
    def worker_id(self):
        return self._core.worker_id

    @property
    def gcs_address(self):
        return getattr(self._core, "gcs_address", None)

    def get_actor_id(self):
        from ray_tpu_torch.core import worker as _worker_mod  # circular-safe

        w = getattr(_worker_mod, "_current_worker", None)
        return w.actor_id if w is not None else None

    def get(self) -> dict:
        return {
            "job_id": self.job_id,
            "node_id": self.node_id,
            "worker_id": self.worker_id,
            "actor_id": self.get_actor_id(),
            "gcs_address": self.gcs_address,
        }


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(get_core())


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    get_core().kill_actor(actor.actor_id, no_restart=no_restart)


def get_actor(name: str) -> ActorHandle:
    handle = get_core().get_actor_by_name(name)
    if handle is None:
        raise ValueError(f"no actor named {name!r}")
    return handle


# --------------------------------------------------------- placement groups
class PlacementGroup:
    """(ref: python/ray/util/placement_group.py:42)"""

    def __init__(self, pg_id: PlacementGroupID, bundles: list[dict]):
        self.id = pg_id
        self.bundles = bundles

    def ready(self, timeout: float = 30.0) -> bool:
        """True once every bundle is committed. Observes the PG state
        machine (PENDING → CREATED → RESCHEDULING → REMOVED): PENDING
        and RESCHEDULING keep waiting — the GCS is creating or repairing
        the group after a node death — so a call issued mid-repair
        returns True when the repair commits rather than flapping False."""
        return get_core().wait_placement_group_ready(self.id, timeout)

    def state(self) -> dict | None:
        """Latest GCS view: ``{state, bundle_nodes, bundles, strategy,
        reschedule_cause, reschedules}`` — ``state`` is one of PENDING /
        CREATED / RESCHEDULING / REMOVED; ``reschedule_cause`` names the
        node loss behind the most recent repair."""
        return get_core().get_placement_group_state(self.id)

    @property
    def bundle_specs(self):
        return self.bundles


def placement_group(
    bundles: list[dict[str, float]], strategy: str = "PACK", name: str = ""
) -> PlacementGroup:
    core = get_core()
    pg_id = PlacementGroupID.generate()
    core._run_sync(
        core.gcs.call(
            "create_placement_group",
            {"pg_id": pg_id, "bundles": bundles, "strategy": strategy, "name": name},
        )
    )
    return PlacementGroup(pg_id, bundles)


def remove_placement_group(pg: PlacementGroup) -> None:
    core = get_core()
    core._run_sync(core.gcs.call("remove_placement_group", {"pg_id": pg.id}))


# ------------------------------------------------------------------ cluster
def nodes() -> list[dict]:
    core = get_core()
    return core._run_sync(core.gcs.call("get_cluster", {}))


def cluster_resources() -> dict[str, float]:
    total: dict[str, float] = {}
    for n in nodes():
        for k, v in n["resources_total"].items():
            total[k] = total.get(k, 0.0) + v
    return total


def available_resources() -> dict[str, float]:
    total: dict[str, float] = {}
    for n in nodes():
        for k, v in n["resources_available"].items():
            total[k] = total.get(k, 0.0) + v
    return total
