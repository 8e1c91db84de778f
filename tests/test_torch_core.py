"""The port's task/actor runtime (``ray_tpu_torch.core``) on the CPU.

One module-scoped ``ray_tpu_torch.init(num_cpus=4, num_gpus=2)``: the
"cards" are resources only, so a lease pins ids through
``CUDA_VISIBLE_DEVICES`` as it would on a GPU host. torch runs one thread
in this process and in the workers, so the module does not starve other
xdist workers' timing-bound tests.

- a parametrised port of a subset of ``tests/test_core_api.py`` (tasks,
  actors, put/get/wait, errors, kill, named actors, placement groups);
- card leases: whole cards pinned, fractions unpinned, as JAX's chip leases;
- tensors through ``put``/``get``, task arguments and returns, and a CUDA
  tensor that a process without CUDA must refuse to read;
- a worker that loads neither ``jax`` nor ``ray_tpu``;
- ``collective.create_collective_group`` over the port's actors.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse
from ray_tpu_torch import config
from ray_tpu_torch.core.ref import ActorError, TaskError
from ray_tpu_torch.utils import serialization

# slowest case ~7 s alone (test_cards_come_back_when_the_worker_exits); set-up
# and tear-down (the runtime's start and shutdown) a few seconds
_module_limit, _test_limit = time_limits(module_s=60, test_s=40)


@pytest.fixture(scope="module")
def rt():
    torch.set_num_threads(1)
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # the workers inherit it
    ray_tpu_torch.shutdown()  # a runtime another module left in this process
    cfg = config.get_config()
    # an idle leased worker goes back after 1 s, not 10: each case's
    # functions lease workers of their own, and 4 CPUs and 2 cards held
    # idle would make the next case wait out the default
    config.set_config(dataclasses.replace(cfg, worker_lease_timeout_s=1.0))
    ray_tpu_torch.init(num_cpus=4, num_gpus=2)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()
    config.set_config(cfg)
    if saved is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = saved


# ------------------------------------------------------ tests/test_core_api.py
def _put_get(rt):
    assert rt.get(rt.put({"x": 1})) == {"x": 1}


def _put_get_large_numpy(rt):
    arr = np.random.default_rng(0).standard_normal(1_000_000)  # 8 MB: through shm
    np.testing.assert_array_equal(rt.get(rt.put(arr)), arr)


def _simple_task(rt):
    @rt.remote
    def add(a, b):
        return a + b

    assert rt.get(add.remote(1, 2)) == 3


def _task_with_ref_arg(rt):
    @rt.remote
    def double(x):
        return x * 2

    assert rt.get(double.remote(rt.put(21))) == 42


def _task_chain(rt):
    @rt.remote
    def inc(x):
        return x + 1

    ref = inc.remote(0)
    for _ in range(5):
        ref = inc.remote(ref)
    assert rt.get(ref) == 6


def _many_parallel_tasks(rt):
    @rt.remote
    def square(i):
        return i * i

    assert rt.get([square.remote(i) for i in range(30)]) == [i * i for i in range(30)]


def _task_large_return(rt):
    @rt.remote
    def big():
        return np.ones(500_000)  # 4 MB

    assert rt.get(big.remote()).sum() == 500_000


def _task_exception_propagates(rt):
    @rt.remote
    def boom():
        raise ValueError("kaboom")

    with pytest.raises(TaskError, match="kaboom"):
        rt.get(boom.remote())


def _num_returns(rt):
    @rt.remote(num_returns=2)
    def two():
        return 1, 2

    r1, r2 = two.remote()
    assert (rt.get(r1), rt.get(r2)) == (1, 2)


def _nested_tasks(rt):
    @rt.remote
    def inner(x):
        return x + 1

    @rt.remote
    def outer(x):
        import ray_tpu_torch as rtw

        return rtw.get(inner.remote(x)) + 10

    assert rt.get(outer.remote(0)) == 11


def _wait(rt):
    @rt.remote
    def fast():
        return "fast"

    @rt.remote
    def slow():
        time.sleep(2.0)
        return "slow"

    rt.get([fast.remote(), fast.remote()], timeout=60)  # two warm workers
    f, s = fast.remote(), slow.remote()
    ready, pending = rt.wait([f, s], num_returns=1, timeout=10)
    assert (ready, pending) == ([f], [s])
    ready, _ = rt.wait([f, s], num_returns=2, timeout=10)
    assert len(ready) == 2


def _actor_basics(rt):
    @rt.remote
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def inc(self, by=1):
            self.n += by
            return self.n

    c = Counter.remote(10)
    assert rt.get(c.inc.remote()) == 11
    assert rt.get(c.inc.remote(5)) == 16
    rt.kill(c)  # an actor holds its CPU: four cases' actors would fill the node


def _actor_ordering(rt):
    @rt.remote
    class Accumulator:
        def __init__(self):
            self.items = []

        def add(self, i):
            self.items.append(i)

        def items_list(self):
            return self.items

    a = Accumulator.remote()
    for i in range(20):
        a.add.remote(i)
    assert rt.get(a.items_list.remote()) == list(range(20))
    rt.kill(a)


def _async_actor(rt):
    @rt.remote
    class AsyncWorker:
        async def work(self, x):
            import asyncio

            await asyncio.sleep(0.01)
            return x * 2

    w = AsyncWorker.remote()
    assert rt.get(w.work.remote(21)) == 42
    rt.kill(w)


def _named_actor(rt):
    @rt.remote
    class Registry:
        def ping(self):
            return "pong"

    keep = Registry.options(name="the-registry").remote()
    assert rt.get(rt.get_actor("the-registry").ping.remote()) == "pong"
    rt.kill(keep)


def _actor_exception(rt):
    @rt.remote
    class Bad:
        def fail(self):
            raise RuntimeError("actor-boom")

    b = Bad.remote()
    with pytest.raises(TaskError, match="actor-boom"):
        rt.get(b.fail.remote())
    rt.kill(b)


def _kill_actor(rt):
    @rt.remote
    class Victim:
        def ping(self):
            return "ok"

    v = Victim.remote()
    assert rt.get(v.ping.remote()) == "ok"
    rt.kill(v)
    time.sleep(0.5)
    with pytest.raises(ActorError):
        rt.get(v.ping.remote(), timeout=10)


def _actor_handle_passed_to_task(rt):
    @rt.remote
    class Holder:
        def get_v(self):
            return 7

    @rt.remote
    def reads_actor(h):
        import ray_tpu_torch as rtw

        return rtw.get(h.get_v.remote())

    h = Holder.remote()
    assert rt.get(reads_actor.remote(h)) == 7
    rt.kill(h)


def _cluster_resources(rt):
    total = rt.cluster_resources()
    assert total["CPU"] == 4.0 and total["GPU"] == 2.0


def _placement_group(rt):
    """Two bundles of one card each; an actor in each sees its own card,
    also once the GCS's view of the node shows both cards reserved (the
    bundles' own ledgers decide where their actors fit)."""
    pg = rt.placement_group([{"CPU": 1, "GPU": 1}, {"CPU": 1, "GPU": 1}], strategy="PACK")
    assert pg.ready(timeout=30)
    deadline = time.monotonic() + 30
    while rt.available_resources().get("GPU", 0.0) != 0.0 and time.monotonic() < deadline:
        time.sleep(0.1)
    assert rt.available_resources().get("GPU", 0.0) == 0.0

    @rt.remote
    class Card:
        def visible(self):
            return os.environ.get("CUDA_VISIBLE_DEVICES")

    actors = [Card.options(num_cpus=1, resources={"GPU": 1}, placement_group=pg,
                           placement_group_bundle_index=i).remote() for i in range(2)]
    assert sorted(rt.get([a.visible.remote() for a in actors])) == ["0", "1"]
    for a in actors:
        rt.kill(a)
    rt.remove_placement_group(pg)


CORE_API = {f.__name__[1:]: f for f in (
    _put_get, _put_get_large_numpy, _simple_task, _task_with_ref_arg, _task_chain,
    _many_parallel_tasks, _task_large_return, _task_exception_propagates, _num_returns,
    _nested_tasks, _wait, _actor_basics, _actor_ordering, _async_actor, _named_actor,
    _actor_exception, _kill_actor, _actor_handle_passed_to_task, _cluster_resources,
    _placement_group)}


@pytest.mark.parametrize("case", sorted(CORE_API))
def test_core_api(rt, case):
    CORE_API[case](rt)


# ------------------------------------------------------------------ card leases
@ray_tpu_torch.remote(num_gpus=1)
def _whole_card():
    time.sleep(1.0)  # both tasks hold their lease at once
    return os.environ.get("CUDA_VISIBLE_DEVICES")


@ray_tpu_torch.remote(num_gpus=2)
def _both_cards():
    return os.environ.get("CUDA_VISIBLE_DEVICES")


@ray_tpu_torch.remote(num_gpus=0.5)
def _half_card():
    return os.environ.get("CUDA_VISIBLE_DEVICES")


@ray_tpu_torch.remote(num_gpus=1)
class _OneCard:
    def visible(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")


def test_whole_cards_are_pinned_apart(rt):
    """Two holders of one card each at once (actors: a worker each, alive
    together) see different cards; a num_gpus=1 task sees one of them."""
    holders = [_OneCard.remote(), _OneCard.remote()]
    assert sorted(rt.get([h.visible.remote() for h in holders], timeout=60)) == ["0", "1"]
    for h in holders:
        rt.kill(h)
    assert rt.get(_whole_card.remote(), timeout=60) in ("0", "1")


def test_cards_come_back_when_the_worker_exits(rt):
    """A pinned worker ends with its lease; its cards return once it has
    exited, and a lease of both cards waits for them rather than pin fewer:
    here it is asked for while two one-card leases are held, and granted
    when they go back (idle), before their workers have exited, to a
    worker that is warm in the pool (the echoes leave some there)."""
    for _ in range(2):
        rt.get([_whole_card.remote(), _whole_card.remote(), _echo.remote(0), _echo.remote(1)],
               timeout=60)
        # in the order the cards came back
        assert sorted(rt.get(_both_cards.remote(), timeout=60).split(",")) == ["0", "1"]


def test_a_share_of_a_card_pins_none(rt):
    """A fractional request pins no card: the worker sees every card this
    process sees (its CUDA_VISIBLE_DEVICES, here unset or inherited)."""
    assert rt.get(_half_card.remote(), timeout=60) == os.environ.get("CUDA_VISIBLE_DEVICES")


@ray_tpu_torch.remote
class _Sized:
    def __init__(self, x):
        self.n = len(x)

    def size(self):
        return self.n


def test_actor_creation_args_outlive_their_refs(rt, monkeypatch):
    """A ref given to an actor's constructor stays pinned until the actor
    is created, however long its worker takes to start: here the driver
    drops the only ref at once, and the grace that covers refs in flight
    is 0 s."""
    from ray_tpu_torch.core.core_client import CoreClient

    monkeypatch.setattr(CoreClient, "BORROW_GRACE_S", 0.0)
    actor = _Sized.remote(rt.put(np.ones(1 << 20)))  # 8 MB: in the shm arena
    assert rt.get(actor.size.remote(), timeout=60) == 1 << 20
    rt.kill(actor)


# ---------------------------------------------------------------------- tensors
def _tensor(dtype):
    a = np.random.default_rng(7).standard_normal((33, 17)) * 100
    return torch.from_numpy(a).to(dtype)


@ray_tpu_torch.remote
def _echo(x):
    return x


@ray_tpu_torch.remote
def _describe(x):
    return str(x.dtype), tuple(x.shape), x.float().sum().item()


@ray_tpu_torch.remote
def _make(dtype_name):
    import torch as t

    return _tensor(getattr(t, dtype_name))


@pytest.mark.parametrize("path", ["put_get", "task_arg", "task_return"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int64, torch.bfloat16],
                         ids=["float32", "int64", "bfloat16"])
def test_tensor_round_trip(rt, dtype, path):
    want = _tensor(dtype)
    if path == "put_get":
        got = rt.get(rt.put(want))
    elif path == "task_arg":
        name, shape, total = rt.get(_describe.remote(want), timeout=60)
        assert (name, shape) == (str(dtype), tuple(want.shape))
        assert total == want.float().sum().item()
        got = rt.get(_echo.remote(want), timeout=60)
    else:
        got = rt.get(_make.remote(str(dtype).removeprefix("torch.")), timeout=60)
    assert got.dtype == dtype and got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got, want)


def test_tensor_get_is_a_copy(rt):
    """``get`` of a CPU tensor copies out of the arena: writing the result
    leaves the stored object as it was."""
    ref = rt.put(torch.zeros(300_000))
    first = rt.get(ref)
    first += 1
    assert rt.get(ref).sum().item() == 0.0


class _CudaTagged:
    """Pickles as a CUDA tensor would: its bytes, restored on a card."""

    def __init__(self, t):
        self.t = t

    def __reduce__(self):
        _, args = serialization._reduce_tensor(self.t)
        return (serialization._restore_cuda_tensor, args)


@ray_tpu_torch.remote
def _read(x):
    return x


def test_cuda_tensor_read_without_cuda_raises(rt):
    """A CUDA tensor is restored on the reader's card or the read raises:
    never a CPU tensor. Neither this process nor a worker has CUDA."""
    assert not torch.cuda.is_available()
    payload = _CudaTagged(torch.arange(6.0).reshape(2, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serialization.unpack(serialization.pack(payload))
    ref = rt.put(payload)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.get(ref)
    with pytest.raises(TaskError, match="no CUDA device"):
        rt.get(_read.remote(ref), timeout=60)


# ------------------------------------------------------------------ the worker
@ray_tpu_torch.remote
def _foreign_modules():
    import sys

    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu")})


def test_worker_loads_no_jax_and_no_ray_tpu(rt):
    assert rt.get(_foreign_modules.remote(), timeout=60) == []


# ------------------------------------------------------------- collective group
@ray_tpu_torch.remote
class _Member:
    def __init__(self, rdzv):
        self.rdzv = rdzv

    def _setup_collective_group(self, world_size, rank, backend, group_name):
        from ray_tpu_torch import collective

        torch.set_num_threads(1)
        collective.init_collective_group(world_size, rank, backend, group_name,
                                         init_method=f"file://{self.rdzv}")
        return True

    def allreduce(self, x, group_name):
        from ray_tpu_torch import collective

        return collective.allreduce(x, group_name)


def test_create_collective_group_on_actors(rt, tmp_path):
    from ray_tpu_torch import collective

    members = [_Member.remote(str(tmp_path / "rdzv")) for _ in range(2)]
    collective.create_collective_group(members, 2, [0, 1], backend="gloo", group_name="g")
    out = rt.get([m.allreduce.remote(np.full(3, r + 1.0), "g") for r, m in enumerate(members)],
                 timeout=60)
    for got in out:
        np.testing.assert_array_equal(got, np.full(3, 3.0))
    for m in members:
        rt.kill(m)


@ray_tpu_torch.remote
class _Pid:
    def pid(self):
        return os.getpid()


def test_lane_rings_leave_no_shm_names(rt):
    """A driver's task lanes and a worker's actor lane unlink their ring
    names once both ends have mapped them, so a worker that is killed
    (never shut down) leaves no ``/dev/shm/rtt_fp_*`` behind."""

    @rt.remote
    def caller(actor):
        return os.getpid(), [rt.get(actor.pid.remote()) for _ in range(20)][-1]

    actor = _Pid.remote()
    pids = {os.getpid()}
    for _ in range(3):
        pids.update(rt.get(caller.remote(actor), timeout=60))
    pids.update(rt.get([actor.pid.remote() for _ in range(20)], timeout=60))

    def left():
        return [n for n in os.listdir("/dev/shm")
                if n.startswith("rtt_fp_") and int(n.split("_")[2]) in pids]

    # a lane being attached right now holds its name for a moment; a leaked
    # one holds it for good
    deadline = time.monotonic() + 5
    while left() and time.monotonic() < deadline:
        time.sleep(0.1)
    rt.kill(actor)
    assert not left(), left()


@ray_tpu_torch.remote(num_cpus=0.5)
class _Holder:
    def __init__(self):
        self.tree = None

    def make(self, i):
        return {"w": np.full((64, 64), float(i), np.float32), "i": i}

    def take(self, tree):
        self.tree = tree
        return float(tree["w"].sum()), tree["i"]


def test_actor_result_passed_on_as_an_argument(rt):
    """One actor's result given to another actor's call as a ref, and the
    same result fetched by the driver and passed by value, as rllib's
    weight syncs pass it: both deliver the tree. Prints each hand-off's ms
    (the ref's waits in the runtime: ROADMAP Queue 3, 5); asserts no time."""
    import statistics

    src, dst = _Holder.remote(), _Holder.remote()
    rt.get([src.make.remote(0), dst.take.remote(rt.get(src.make.remote(0)))], timeout=60)
    by_ref, by_value = [], []
    for i in range(1, 4):
        t0 = time.perf_counter()
        assert rt.get(dst.take.remote(src.make.remote(i)), timeout=60) == (64 * 64 * i, i)
        t1 = time.perf_counter()
        tree = rt.get(src.make.remote(i), timeout=60)
        assert rt.get(dst.take.remote(tree), timeout=60) == (64 * 64 * i, i)
        by_ref.append((t1 - t0) * 1e3)
        by_value.append((time.perf_counter() - t1) * 1e3)
    print(f"actor result as an argument: by ref {statistics.median(by_ref):.2f} ms, "
          f"fetched and passed by value {statistics.median(by_value):.2f} ms (medians of 3)")
    rt.kill(src)
    rt.kill(dst)


def test_handle_drop_inside_a_refcount_section_does_not_deadlock(rt):
    """A garbage-collection pass inside one of the core's refcount
    sections can run an ActorHandle's __del__, which drops the handle's
    count under the same lock on the same thread: the lock must let it in
    (a plain Lock hung a test worker on exactly this)."""
    import threading

    from ray_tpu_torch.utils.ids import ActorID

    core = rt.get_core()
    done = threading.Event()

    def section():
        with core._rc_lock:  # e.g. on_owned_ref_created, when the GC fires
            core.note_actor_handle_dropped(ActorID.generate())
        done.set()

    t = threading.Thread(target=section, daemon=True)
    t.start()
    t.join(10)
    assert done.is_set()


def test_lease_granted_after_its_owner_left_is_taken_back(tmp_path):
    """A lease whose owner disconnects while its worker is being popped
    or spawned (after the raylet's disconnect reaping ran) is taken back
    at once: its CPU returns and no lease names the closed connection. A
    lease kept would hold the worker and the CPU for good (a TorchTrainer's
    placement group then waited on CPUs leased to a killed actor)."""
    from ray_tpu_torch.core.cluster import Cluster
    from ray_tpu_torch.utils import rpc

    io = rpc.EventLoopThread()
    cluster = Cluster(io=io)
    try:
        cluster.add_node(num_cpus=2.0)
        raylet = cluster.raylets[0]

        class Owner:  # a requester's connection, as the raylet sees it
            _closed = False

        owner = Owner()
        pop_worker = raylet._pop_worker

        async def pop_then_owner_leaves(language):
            w = await pop_worker(language)
            owner._closed = True
            raylet._on_client_disconnect(owner)
            return w

        raylet._pop_worker = pop_then_owner_leaves

        async def lease():
            assert raylet._try_allocate({"CPU": 1.0}, None)
            with pytest.raises(rpc.RpcError, match="disconnected"):
                await raylet._grant_lease(owner, {"owner_bound": True, "language": "python"},
                                          {"CPU": 1.0}, None)

        io.run(lease(), timeout=60)
        assert not [l for l in raylet.leases.values() if l.owner_conn is owner]
        assert raylet.ledger.available.get("CPU") == 2.0
    finally:
        cluster.shutdown()
        io.stop()
