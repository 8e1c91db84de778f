"""Compiled graphs of the port (``ray_tpu_torch.dag``) on its runtime, on
the CPU: every case of the JAX package's ``tests/test_dag.py`` (authoring,
channels, static schedules, fan-out/in, multi-output, execute_async, the
collective node over gloo, a pipeline across two nodes of a ``Cluster``),
and a two-stage pipeline of ``LlamaConfig.tiny()`` stages against JAX's
``llama_forward``.

JAX's two timing cases assert wall-clock ratios, which move with the load
of the machine. Their counterparts here assert the mechanism each ratio
comes from, and print the ratio: a compiled graph submits no task per
iteration, and in overlap mode a stage's reads of iteration i+1 complete
before its compute of iteration i ends (never in sequential mode), from
the timestamps each loop records. The card's ratios are measured by
``chip_smoke.py``'s ``dag_pipeline`` phase.

One runtime serves the module; its workers run one intra-op thread.
"""

import asyncio
import dataclasses
import gc
import os
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.dag import InputNode, MultiOutputNode, allreduce_bind

from _torch_time_limit import time_limits

# a worker starts in ~2 s; the collective and cross-node cases ~20 s each
_module_limit, _test_limit = time_limits(module_s=240, test_s=120)


@pytest.fixture(scope="module")
def rt():
    from ray_tpu_torch import config

    ray_tpu_torch.shutdown()  # a runtime another module left in this process
    cfg = config.get_config()
    config.set_config(dataclasses.replace(cfg, worker_lease_timeout_s=1.0))
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # the workers inherit it
    # a closed channel keeps its cell: the module's graphs hold ~40 of 8 MiB
    ray_tpu_torch.init(num_cpus=32, object_store_memory=1 << 30)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()
    config.set_config(cfg)
    if threads is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = threads


@pytest.fixture(autouse=True)
def collect():
    """A test's actors go with its last handle; a handle sits in a cycle
    (its cached methods), so collect it here, not at some later test's
    allocation."""
    yield
    gc.collect()


@ray_tpu_torch.remote(num_cpus=0.5)
class Doubler:
    def double(self, x):
        return x * 2

    def add(self, x, y):
        return x + y

    def plus_const(self, x, c):
        return x + c


def test_single_actor_chain(rt):
    a = Doubler.remote()
    with InputNode() as inp:
        mid = a.double.bind(inp)
        dag = a.double.bind(mid)  # same-actor edge: no channel, local pass
    compiled = dag.experimental_compile()
    try:
        for i in range(10):
            assert compiled.execute(i).get() == i * 4
    finally:
        compiled.teardown()


def test_three_actor_pipeline_100_iters(rt):
    a, b, c = Doubler.remote(), Doubler.remote(), Doubler.remote()
    with InputNode() as inp:
        dag = c.double.bind(b.double.bind(a.double.bind(inp)))
    compiled = dag.experimental_compile()
    try:
        for i in range(100):
            assert compiled.execute(i).get() == i * 8
    finally:
        compiled.teardown()
    assert sorted(r["iterations"] for r in compiled.loop_results.values()) == [100] * 3


def test_fan_out_fan_in(rt):
    a, b, c = Doubler.remote(), Doubler.remote(), Doubler.remote()
    with InputNode() as inp:
        x = a.double.bind(inp)          # input read by a
        y = b.plus_const.bind(inp, 10)  # ... and b (num_readers=2)
        dag = c.add.bind(x, y)
    compiled = dag.experimental_compile()
    try:
        for i in range(20):
            assert compiled.execute(i).get() == 2 * i + i + 10
    finally:
        compiled.teardown()


def test_multi_output(rt):
    a, b = Doubler.remote(), Doubler.remote()
    with InputNode() as inp:
        dag = MultiOutputNode([a.double.bind(inp), b.plus_const.bind(inp, 5)])
    compiled = dag.experimental_compile()
    try:
        assert compiled.execute(7).get() == [14, 12]
    finally:
        compiled.teardown()


def test_numpy_payloads(rt):
    import torch

    a = Doubler.remote()
    with InputNode() as inp:
        dag = a.double.bind(inp)
    compiled = dag.experimental_compile()
    try:
        arr = np.arange(100_000, dtype=np.float32)
        np.testing.assert_array_equal(compiled.execute(arr).get(), arr * 2)
        # a CPU tensor crosses as a tensor, dtype and shape kept
        t = torch.arange(12, dtype=torch.bfloat16).reshape(3, 4)
        out = compiled.execute(t).get()
        assert isinstance(out, torch.Tensor) and out.dtype == torch.bfloat16
        assert torch.equal(out, t * 2)
    finally:
        compiled.teardown()


def _count_submissions(core, monkeypatch) -> list:
    """Every task or actor call the driver's core submits from here on."""
    calls = []
    for name in ("submit_actor_task", "submit_template", "submit_task"):
        orig = getattr(core, name)

        def counted(*args, _orig=orig, _name=name, **kwargs):
            calls.append(_name)
            return _orig(*args, **kwargs)

        monkeypatch.setattr(core, name, counted)
    return calls


def test_dag_faster_than_actor_calls(rt, monkeypatch):
    """The point of compiling: once compiled, an iteration submits no task
    (JAX's case asserts the resulting speed-up, 2x, in wall clock; the
    ratio is printed here and measured on the card by chip_smoke)."""
    a, b = Doubler.remote(), Doubler.remote()
    calls = _count_submissions(rt.get_core(), monkeypatch)
    n = 50
    start = time.perf_counter()
    for i in range(n):
        out = rt.get(b.double.remote(a.double.remote(i)))
    t_calls = time.perf_counter() - start
    assert out == (n - 1) * 4 and len(calls) == 2 * n

    with InputNode() as inp:
        dag = b.double.bind(a.double.bind(inp))
    compiled = dag.experimental_compile()
    try:
        compiled.execute(0).get()  # warm
        del calls[:]
        start = time.perf_counter()
        for i in range(n):
            out = compiled.execute(i).get()
        t_dag = time.perf_counter() - start
        assert out == (n - 1) * 4
        assert calls == [], calls  # zero per-iteration submissions
    finally:
        compiled.teardown()
    print(f"\nDAG speedup: {t_calls / t_dag:.1f}x ({t_calls * 1e3 / n:.2f}ms -> "
          f"{t_dag * 1e3 / n:.2f}ms per iter)")


def test_teardown_is_clean_and_reports_iterations(rt):
    a = Doubler.remote()
    with InputNode() as inp:
        dag = a.double.bind(inp)
    compiled = dag.experimental_compile()
    for i in range(5):
        compiled.execute(i).get()
    compiled.teardown()
    assert [r["iterations"] for r in compiled.loop_results.values()] == [5]
    with pytest.raises(RuntimeError):
        compiled.execute(0)


@ray_tpu_torch.remote(num_cpus=0.5)
class Member:
    def setup(self, world, rank, group):
        from ray_tpu_torch.collective import collective as col

        # no init_method: the ranks meet through the runtime's GCS KV
        col.init_collective_group(world, rank, backend="gloo", group_name=group)
        return True

    def scale(self, x, k):
        return np.asarray([float(x) * k], dtype=np.float32)


def test_dag_collective_allreduce(rt):
    """Collective node: every group member binds its own allreduce over its
    iteration value; the gloo group synchronizes them (ref:
    dag/collective_node.py + experimental/collective/operations.py)."""
    m0, m1 = Member.remote(), Member.remote()
    group = f"dagcol_{os.getpid()}"
    assert rt.get([m0.setup.remote(2, 0, group), m1.setup.remote(2, 1, group)],
                  timeout=90) == [True, True]
    with InputNode() as inp:
        r0, r1 = allreduce_bind([m0.scale.bind(inp, 1), m1.scale.bind(inp, 10)],
                                group_name=group)
        dag = MultiOutputNode([r0, r1])
    compiled = dag.experimental_compile()
    try:
        for i in range(5):
            out0, out1 = compiled.execute(i).get(timeout=60)
            # SUM over the group: both members see x*1 + x*10
            assert float(out0[0]) == float(out1[0]) == i * 11.0
    finally:
        compiled.teardown()


@pytest.fixture()
def two_node_api(rt):
    """The port's API bound to a 2-node Cluster; node B carries the 'bee'
    resource so actors can be pinned there."""
    from ray_tpu_torch.core import api as _api
    from ray_tpu_torch.core.cluster import Cluster
    from ray_tpu_torch.core.core_client import CoreClient
    from ray_tpu_torch.utils import rpc as _rpc

    io = _rpc.EventLoopThread()
    cluster = Cluster(io=io)
    node_a = cluster.add_node(num_cpus=4.0)
    cluster.add_node(num_cpus=4.0, resources={"bee": 4.0})
    core = CoreClient(loop=io.loop)
    io.run(core.connect(cluster.gcs_address, node_a.server.address))
    old = _api._core
    _api._core = core
    yield core
    _api._core = old
    try:
        io.run(core.close(), timeout=10)
    except Exception:  # the cluster goes below either way
        pass
    cluster.shutdown()
    io.stop()


def test_cross_node_dag_pipeline(two_node_api):
    """A 3-actor pipeline spanning two Cluster nodes: channel cells are
    mirrored to reader nodes by the raylet forwarder (the
    RegisterMutableObjectReader role, ref: core_worker.proto:577)."""

    @ray_tpu_torch.remote(num_cpus=0.5)
    class D:
        def double(self, x):
            return x * 2

    a = D.remote()                                     # node A (driver's)
    b = D.options(resources={"bee": 1.0}).remote()     # node B
    c = D.options(resources={"bee": 1.0}).remote()     # node B
    # wait for placement so compile sees real node ids
    assert ray_tpu_torch.get([a.double.remote(1), b.double.remote(1), c.double.remote(1)],
                             timeout=90) == [2, 2, 2]
    with InputNode() as inp:
        x = a.double.bind(inp)   # A -> B edge crosses nodes
        y = b.double.bind(x)     # B -> B edge stays local to B
        dag = c.double.bind(y)   # B -> driver (A) leaf crosses back
    compiled = dag.experimental_compile()
    try:
        for i in range(20):
            assert compiled.execute(i).get(timeout=60) == i * 8
    finally:
        compiled.teardown()


def test_execute_async_future(rt):
    """execute_async + CompiledDAGFuture (ref: compiled_dag_node.py:2617,
    compiled_dag_ref.py:154): results await without blocking the loop,
    futures drain in execute order, and double-await raises."""
    a = Doubler.remote()
    with InputNode() as inp:
        dag = a.double.bind(inp)
    compiled = dag.experimental_compile()
    try:
        async def go():
            futs = [await compiled.execute_async(i) for i in range(6)]
            return [await f for f in futs]

        assert asyncio.run(go()) == [i * 2 for i in range(6)]

        async def double_await():
            fut = await compiled.execute_async(7)
            assert await fut == 14
            await fut  # second await must raise

        with pytest.raises(RuntimeError, match="once"):
            asyncio.run(double_await())
        # results drain in execute order
        first, second = compiled.execute(1), compiled.execute(2)
        with pytest.raises(RuntimeError, match="execute order"):
            second.get()
        assert (first.get(), second.get()) == (2, 4)
    finally:
        compiled.teardown()


@ray_tpu_torch.remote(num_cpus=0.5)
class Stage:
    def work(self, x):
        time.sleep(0.05)
        return x


def _early_reads(timeline) -> int:
    """Iterations i whose successor's reads completed before i's compute
    ended."""
    return sum(nxt[0] < cur[2] for cur, nxt in zip(timeline, timeline[1:]))


def test_overlap_beats_sequential_pipeline(rt):
    """The READ/COMPUTE/WRITE overlap schedule reads a stage's next input
    while it computes the current one; the sequential schedule reads only
    after it wrote. JAX's case asserts the overlap pipeline's wall clock
    beats the sequential one's by 3%; this one asserts the overlap itself
    from the loops' timestamps, and prints both times."""
    payload = np.zeros(1 << 20, dtype=np.uint8)
    n = 8
    early, seconds = {}, {}
    for overlap in (False, True):
        a, b = Stage.remote(), Stage.remote()
        with InputNode() as inp:
            dag = b.work.bind(a.work.bind(inp))
        compiled = dag.experimental_compile(overlap=overlap)
        try:
            start = time.perf_counter()
            refs = [compiled.execute(payload) for _ in range(2)]  # two in flight
            for _ in range(n - 2):
                refs.append(compiled.execute(payload))
                assert refs.pop(0).get().nbytes == payload.nbytes
            for r in refs:
                r.get()
            seconds[overlap] = time.perf_counter() - start
        finally:
            compiled.teardown()
        results = list(compiled.loop_results.values())
        assert len(results) == 2 and all(r["overlap"] == overlap for r in results)
        assert all(r["iterations"] == n and len(r["timeline"]) == n for r in results)
        early[overlap] = sum(_early_reads(r["timeline"]) for r in results)
    print(f"\noverlap pipeline: {seconds[False] * 1e3:.0f}ms -> {seconds[True] * 1e3:.0f}ms "
          f"for {n} iters; reads ahead of compute: {early[False]} -> {early[True]}")
    assert early[False] == 0
    assert early[True] >= 1


# --------------------------------------------------------- a Llama pipeline
@ray_tpu_torch.remote(num_cpus=0.5)
class LlamaStage:
    """One stage of a process pipeline: its part of the weights, its layers."""

    def __init__(self, part, cfg):
        self.part, self.cfg = part, cfg

    def forward(self, x):
        import torch

        from ray_tpu_torch.models.llama import llama_stage_forward

        with torch.inference_mode():
            return llama_stage_forward(self.part, x, self.cfg, attn_impl="plain")


def test_two_stage_llama_pipeline_matches_jax(rt):
    """JAX's tiny Llama carried into two stage actors (embedding and layer
    0; layer 1, norm and head) compiled into a pipeline: the logits equal
    JAX's llama_forward on the same seeded tokens to float32's 2e-5
    (relative L2), the hidden state crossing as a float32 tensor."""
    import jax
    import torch

    from ray_tpu.models import llama as jllama
    from ray_tpu_torch.models import llama as tllama

    # jitted: an eager JAX forward spends seconds compiling its ops one by one
    jforward = jax.jit(jllama.llama_forward, static_argnames=("cfg", "attn_impl"))
    jcfg, tcfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    jparams = jllama.llama_init(jax.random.PRNGKey(0), jcfg)
    params = tllama.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    stages = [LlamaStage.remote(tllama.llama_stage_params(params, tcfg, s, 2), tcfg)
              for s in range(2)]
    with InputNode() as inp:
        dag = stages[1].forward.bind(stages[0].forward.bind(inp))
    compiled = dag.experimental_compile()
    try:
        for seed in range(2):
            toks = np.random.default_rng(seed).integers(0, 256, size=(2, 64)).astype(np.int32)
            want, _ = jforward(jparams, jax.numpy.asarray(toks), cfg=jcfg, attn_impl="plain")
            got = compiled.execute(torch.tensor(toks)).get(timeout=60)
            assert isinstance(got, torch.Tensor) and got.shape == (2, 64, tcfg.vocab_size)
            want = np.asarray(want)
            rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
            assert rel <= 2e-5, rel
    finally:
        compiled.teardown()
    # the stage split is llama_forward's: the same logits in one process
    whole, _ = tllama.llama_forward(params, torch.tensor(toks), tcfg, attn_impl="plain")
    split = tllama.llama_stage_forward(
        tllama.llama_stage_params(params, tcfg, 1, 2),
        tllama.llama_stage_forward(tllama.llama_stage_params(params, tcfg, 0, 2),
                                   torch.tensor(toks), tcfg, attn_impl="plain"),
        tcfg, attn_impl="plain", last_only=True)
    torch.testing.assert_close(split[:, 0], whole[:, -1])
