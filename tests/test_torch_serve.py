"""``ray_tpu_torch.serve`` on the port's own actor runtime, on the CPU.

One module-scoped ``ray_tpu_torch.init(num_cpus=16, num_gpus=1)``: the
"card" is a resource only, so a ``num_gpus=1`` replica's lease pins its id
through ``CUDA_VISIBLE_DEVICES`` as it would on a GPU host.

- the cases of ``tests/test_serve.py`` (deploy and route, methods and
  user_config, composition, batching, autoscaling up and from zero, a
  replica's death, HTTP through aiohttp, cross-caller routing) and
  ``test_serve_grpc_multiplex.py``'s gRPC round trip, on the port;
- a replica that leases the card, shows it in ``serve.status()`` and loads
  neither ``jax`` nor ``ray_tpu``;
- greedy tokens from ``serve.run(build_llm_deployment(LlamaConfig.tiny(),
  device="cpu"))`` and from ``build_llm_engine_deployment``'s
  ``stream_deltas`` through a handle, equal to JAX's in-process
  ``LLMServer`` / ``LLMEngineServer`` on the same carried weights.
"""

import asyncio
import concurrent.futures
import dataclasses
import json
import os
import time
import urllib.request

import numpy as np
import pytest
import torch

import ray_tpu_torch
from _torch_time_limit import time_limits
from ray_tpu_torch import config, serve

# slowest case ~7 s alone (test_llm_deployment_greedy_matches_jax, a replica's
# start and JAX's server); set-up and tear-down a few seconds
_module_limit, _test_limit = time_limits(module_s=60, test_s=40)


@pytest.fixture(scope="module")
def rt():
    torch.set_num_threads(1)
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # the workers inherit it
    ray_tpu_torch.shutdown()  # a runtime another module left in this process
    cfg = config.get_config()
    config.set_config(dataclasses.replace(cfg, worker_lease_timeout_s=1.0))
    ray_tpu_torch.init(num_cpus=16, num_gpus=1)
    yield ray_tpu_torch
    serve.shutdown()
    ray_tpu_torch.shutdown()
    config.set_config(cfg)
    if saved is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = saved


@pytest.fixture(autouse=True)
def _cleanup_apps(request):
    yield
    if "rt" in request.fixturenames:
        # tear down everything between tests so replica sets don't leak
        for app in list(serve.status()):
            serve.delete(app)


# --------------------------------------------------- tests/test_serve.py
def test_basic_deploy_and_route(rt):
    @serve.deployment(num_replicas=2)
    class Echo:
        def __call__(self, x):
            return (os.getpid(), x * 2)

    handle = serve.run(Echo.bind(), name="echo")
    results = rt.get([handle.remote(i) for i in range(100)], timeout=60)
    assert [v for _, v in results] == [i * 2 for i in range(100)]
    # 100 requests over 2 replicas: pow-2 routing must touch both
    assert len({pid for pid, _ in results}) == 2


def test_method_calls_and_user_config(rt):
    @serve.deployment(user_config={"scale": 10})
    class Scaler:
        def __init__(self):
            self.scale = 1

        def reconfigure(self, cfg):
            self.scale = cfg["scale"]

        def apply(self, x):
            return x * self.scale

    handle = serve.run(Scaler.bind(), name="scaler")
    assert rt.get(handle.apply.remote(4), timeout=30) == 40


def test_composition_nested_handles(rt):
    @serve.deployment
    class Adder:
        def __init__(self, offset):
            self.offset = offset

        def __call__(self, x):
            return x + self.offset

    @serve.deployment
    class Ingress:
        def __init__(self, adder):
            self.adder = adder

        async def __call__(self, x):
            return await self.adder.remote(x) * 2

    handle = serve.run(Ingress.bind(Adder.bind(100)), name="graph")
    assert rt.get(handle.remote(1), timeout=60) == 202


def test_batching_coalesces(rt):
    @serve.deployment(max_ongoing_requests=32)
    class Batched:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.05)
        async def handler(self, xs: list):
            self.batch_sizes.append(len(xs))
            return [x + 1 for x in xs]

        async def __call__(self, x):
            return await self.handler(x)

        def seen_batches(self):
            return self.batch_sizes

    handle = serve.run(Batched.bind(), name="batched")
    refs = [handle.remote(i) for i in range(16)]
    assert sorted(rt.get(refs, timeout=60)) == [i + 1 for i in range(16)]
    sizes = rt.get(handle.seen_batches.remote(), timeout=30)
    assert sum(sizes) == 16
    assert max(sizes) > 1, f"no coalescing happened: {sizes}"


def test_autoscale_up_under_load(rt):
    @serve.deployment(
        max_ongoing_requests=4,
        autoscaling_config={"min_replicas": 1, "max_replicas": 3,
                            "target_ongoing_requests": 1.0, "upscale_delay_s": 0.3,
                            "downscale_delay_s": 60.0, "metrics_interval_s": 0.1},
    )
    class Slow:
        def __call__(self, x):
            time.sleep(0.4)
            return x

    handle = serve.run(Slow.bind(), name="autoscale")
    assert serve.status()["autoscale"]["Slow"]["target_replicas"] == 1
    with concurrent.futures.ThreadPoolExecutor(max_workers=12) as pool:
        futs = [pool.submit(lambda i=i: rt.get(handle.remote(i), timeout=120))
                for i in range(48)]
        done = [f.result() for f in futs]
    assert sorted(done) == list(range(48))
    st = serve.status()["autoscale"]["Slow"]
    assert st["target_replicas"] > 1, f"no upscale happened: {st}"


def test_scale_from_zero(rt):
    @serve.deployment(
        autoscaling_config={"min_replicas": 0, "max_replicas": 2,
                            "target_ongoing_requests": 2.0, "upscale_delay_s": 0.2,
                            "downscale_delay_s": 0.3, "metrics_interval_s": 0.1},
    )
    class Idle:
        def __call__(self, x):
            return x + 1

    handle = serve.run(Idle.bind(), name="zero")
    assert rt.get(handle.remote(1), timeout=30) == 2
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        st = serve.status()["zero"]["Idle"]
        if st["target_replicas"] == 0 and not st["replicas"]:
            break
        time.sleep(0.2)
    else:
        pytest.fail(f"never scaled to zero: {serve.status()}")
    assert rt.get(handle.remote(41), timeout=60) == 42


def test_replica_failure_recovers(rt):
    @serve.deployment(num_replicas=2)
    class Fragile:
        def die(self):
            os._exit(1)

        def __call__(self, x):
            return x

    handle = serve.run(Fragile.bind(), name="fragile")
    try:
        rt.get(handle.die.remote(), timeout=10)
    except Exception:
        pass
    deadline = time.monotonic() + 60
    ok = 0
    while time.monotonic() < deadline and ok < 20:
        try:
            assert rt.get(handle.remote(ok), timeout=15) == ok
            ok += 1
        except Exception:
            time.sleep(0.2)
    assert ok == 20
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        reps = serve.status()["fragile"]["Fragile"]["replicas"]
        if len(reps) == 2 and all(r["healthy"] for r in reps):
            break
        time.sleep(0.2)
    else:
        pytest.fail(f"replica set never healed: {serve.status()}")


def test_http_proxy(rt):
    pytest.importorskip("aiohttp")

    @serve.deployment
    class Api:
        def __call__(self, body):
            return {"doubled": body["x"] * 2}

    serve.run(Api.bind(), name="api")
    host, port = serve.start_http_proxy()
    req = urllib.request.Request(f"http://{host}:{port}/api/Api",
                                 data=json.dumps({"x": 21}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert json.loads(resp.read())["result"] == {"doubled": 42}
    with urllib.request.urlopen(f"http://{host}:{port}/-/healthz", timeout=10) as resp:
        assert json.loads(resp.read())["status"] == "ok"
    with urllib.request.urlopen(f"http://{host}:{port}/-/routes", timeout=10) as resp:
        assert "Api" in json.loads(resp.read()).get("api", [])


def test_grpc_proxy(rt):
    pytest.importorskip("grpc")
    from ray_tpu_torch.serve.grpc_proxy import GrpcIngressClient

    @serve.deployment
    class Echo:
        def __call__(self, x):
            return {"echo": x}

        def shout(self, x):
            return str(x).upper()

    serve.run(Echo.bind(), name="grpcapp")
    host, port = serve.start_grpc_proxy()
    client = GrpcIngressClient(host, port)
    try:
        assert client.healthz()
        assert "grpcapp" in client.list_applications()
        assert client.call("Echo", {"a": 1}, app="grpcapp") == {"echo": {"a": 1}}
        assert client.call("Echo", "hi", app="grpcapp", method="shout") == "HI"
    finally:
        client.close()


def test_cross_caller_routing_sees_remote_load(rt):
    """The router sees load OTHER callers put on a replica: replica 1 is
    loaded directly, so routed requests prefer replica 2."""
    from ray_tpu_torch.serve.handle import _router_for

    class Slow:
        def __init__(self):
            self.hits = 0

        def work(self, dt):
            time.sleep(dt)
            self.hits += 1
            return self.hits

        def count(self):
            return self.hits

    serve.run(serve.deployment(Slow, name="Slow", num_replicas=2, max_ongoing_requests=16,
                               ray_actor_options={"num_cpus": 0.1}).bind(), name="xc")
    handle = serve.get_deployment_handle("Slow", "xc")
    rt.get(handle.work.remote(0.01), timeout=120)
    router = _router_for("xc", "Slow")
    deadline = time.monotonic() + 30
    while len(router.replicas) < 2 and time.monotonic() < deadline:
        time.sleep(0.1)
    assert len(router.replicas) == 2
    loaded = rt.get_actor(router.replicas[0]["actor_name"])
    bg = [loaded.handle_request.remote("work", (2.0,), {}) for _ in range(8)]
    time.sleep(1.0)  # let the probe loop observe the load
    rt.get([handle.work.remote(0.05) for _ in range(6)], timeout=120)
    other = rt.get_actor(router.replicas[1]["actor_name"])
    other_hits = rt.get(other.handle_request.remote("count", (), {}), timeout=60)
    rt.get(bg, timeout=120)
    assert other_hits >= 5, f"routed work not diverted: {other_hits}/6"


# ------------------------------------------------------------ card leases
def test_gpu_replica_leases_the_card(rt):
    """A ``num_gpus=1`` replica is pinned to card "0", shows RUNNING with
    ``GPU`` 1 in ``serve.status()``, and its worker has loaded neither
    ``jax`` nor ``ray_tpu``."""

    @serve.deployment(ray_actor_options={"num_gpus": 1})
    class OnCard:
        def __call__(self, _):
            import sys

            return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                    sorted(m for m in ("jax", "ray_tpu") if m in sys.modules))

    handle = serve.run(OnCard.bind(), name="card")
    assert rt.get(handle.remote(0), timeout=60) == ("0", [])
    (rep,) = serve.status()["card"]["OnCard"]["replicas"]
    assert rep["state"] == "RUNNING" and rep["resources"]["GPU"] == 1.0


# ------------------------------------------------------------------- LLM
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], list(range(30, 50)), [21, 22], [9, 8, 7, 6],
           [3, 1, 4, 1, 5], [2, 7, 1, 8], [11, 12, 13]]
MAX_NEW = 8


@pytest.fixture(scope="module")
def models():
    import jax

    from ray_tpu.models import llama as jllama
    from ray_tpu_torch.models import llama as tllama

    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.llama_init(jax.random.PRNGKey(0), jcfg)
    tcfg = tllama.LlamaConfig.tiny()
    params = tllama.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, params


def _engine_kw():
    return dict(max_batch=4, page_size=8, n_pages=64, max_seq_len=64)


def _jax_tokens(server, requests):
    async def go():
        try:
            return await asyncio.wait_for(
                asyncio.gather(*[server(r) for r in requests]), timeout=60)
        finally:
            if hasattr(server, "engine"):
                await server.engine.stop()

    return [o["completion_tokens"] for o in asyncio.run(go())]


def test_llm_deployment_greedy_matches_jax(rt, models):
    """8 concurrent requests through a handle to a replica that runs
    ``LLMServer`` on the CPU: the same greedy tokens as JAX's in-process
    ``LLMServer`` on the same weights."""
    from ray_tpu.llm import serving as jserving
    from ray_tpu_torch.llm import build_llm_deployment

    jcfg, jparams, tcfg, params = models
    reqs = [{"prompt_tokens": p, "max_tokens": MAX_NEW} for p in PROMPTS]
    want = _jax_tokens(jserving.LLMServer(jcfg, jparams, max_batch_size=8), reqs)
    handle = serve.run(build_llm_deployment(tcfg, params=params, max_batch_size=8,
                                            device="cpu"), name="llm")
    got = rt.get([handle.remote(r) for r in reqs], timeout=120)
    assert [g["completion_tokens"] for g in got] == want
    assert max(g["usage"]["batch_size"] for g in got) > 1  # coalesced


def test_llm_engine_deployment_streams_as_jax(rt, models):
    """``stream_deltas`` through a handle gives JAX's engine tokens, one
    delta per decode block, then a terminal ``done`` delta."""
    from ray_tpu.llm import serving as jserving
    from ray_tpu_torch.llm import build_llm_engine_deployment

    jcfg, jparams, tcfg, params = models
    req = {"prompt_tokens": [1, 2, 3], "max_tokens": 24}
    (want,) = _jax_tokens(jserving.LLMEngineServer(jcfg, jparams, **_engine_kw()), [req])
    serve.run(build_llm_engine_deployment(tcfg, params=params, device="cpu", **_engine_kw()),
              name="llm_engine")
    handle = serve.get_deployment_handle("LLMEngineServer", "llm_engine")
    deltas = list(handle.stream_deltas.stream_chunks(dict(req)))
    assert deltas[-1].get("done") is True
    assert [t for d in deltas for t in d["tokens"]] == want
    assert len(deltas) - 1 < 24  # block coalescing
    assert rt.get(handle.remote(dict(req)), timeout=60)["completion_tokens"] == want


def test_llm_replica_without_a_card_raises(rt, models):
    """A replica asked to run on the card (the default) in a process with
    no CUDA device fails to start; it never runs on the CPU."""
    from ray_tpu_torch.llm import LLMServer

    _, _, tcfg, _ = models
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMServer(tcfg)
