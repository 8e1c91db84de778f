"""The port's serving layer against the JAX package's, on the CPU:
``LLMServer`` (one ``serve.batch`` queue, one ``generate`` call per
temperature), ``LLMEngineServer`` (``__call__``, ``stream``,
``stream_deltas``, cancellation, backpressure) and the port's copies of
``serve.batch`` and ``deployment``. Weights are the JAX tiny init carried
across; float32. Both packages' servers are built in process: no test
starts the ray_tpu runtime, and each async case runs under a 60 s limit."""

import asyncio
import time

import jax
import numpy as np
import pytest

from ray_tpu.llm import generation as jgeneration
from ray_tpu.llm import serving as jserving
from ray_tpu.llm.engine import EngineFull as JEngineFull
from ray_tpu.models import llama as jllama
from ray_tpu.serve.exceptions import BackPressureError as JBackPressureError
from ray_tpu_torch.llm import generation as tgeneration
from ray_tpu_torch.llm import serving as tserving
from ray_tpu_torch.llm.engine import EngineFull
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.serve import Application, batch, deployment
from ray_tpu_torch.serve.exceptions import BackPressureError

PS = 8
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], list(range(30, 50)), [21, 22]]
MAX_NEW = 8


def run(coro):
    async def bounded():
        return await asyncio.wait_for(coro, timeout=60)

    return asyncio.run(bounded())


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.llama_init(jax.random.PRNGKey(0), jcfg)
    tcfg = tllama.LlamaConfig.tiny()
    params = tllama.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                      device="cpu")
    return jcfg, jparams, tcfg, params


def _engine_kw():
    return dict(max_batch=2, page_size=PS, n_pages=64, max_seq_len=64)


@pytest.fixture(scope="module")
def jax_engine_tokens(models):
    """JAX's LLMEngineServer.__call__ completions for PROMPTS."""
    jcfg, jparams, _, _ = models

    async def go():
        srv = jserving.LLMEngineServer(jcfg, jparams, **_engine_kw())
        try:
            outs = await asyncio.gather(*[
                srv({"prompt_tokens": p, "max_tokens": MAX_NEW}) for p in PROMPTS])
        finally:
            await srv.engine.stop()
        return [o["completion_tokens"] for o in outs]

    return run(go())


# ------------------------------------------------------------- LLMServer
# (prompt, max_tokens, temperature): two temperatures, ragged max_tokens
REQUESTS = [(PROMPTS[0], 8, 0.0), (PROMPTS[1], 5, 0.7), (PROMPTS[2], 8, 0.0),
            (PROMPTS[3], 3, 0.7), ([9, 8, 7, 6], 6, 0.0)]


def _serve_llm_server(srv, module, monkeypatch):
    calls = []
    real = module.generate

    def counting(params, cfg, prompts, **kw):
        calls.append((len(prompts), kw["temperature"]))
        return real(params, cfg, prompts, **kw)

    monkeypatch.setattr(module, "generate", counting)

    async def go():
        return await asyncio.gather(*[
            srv({"prompt_tokens": p, "max_tokens": n, "temperature": t})
            for p, n, t in REQUESTS])

    return run(go()), calls


def test_llm_server_matches_jax(models, monkeypatch):
    """The same greedy completions as JAX's LLMServer, cut to each
    request's max_tokens; one batch of all five requests and one generate
    call per distinct temperature, in both packages."""
    jcfg, jparams, tcfg, params = models
    jout, jcalls = _serve_llm_server(jserving.LLMServer(jcfg, jparams), jgeneration,
                                     monkeypatch)
    tout, tcalls = _serve_llm_server(tserving.LLMServer(tcfg, params), tgeneration,
                                     monkeypatch)
    assert tcalls == jcalls == [(3, 0.0), (2, 0.7)]
    for (p, n, t), jo, to in zip(REQUESTS, jout, tout):
        assert len(to["completion_tokens"]) == n
        assert all(0 <= x < tcfg.vocab_size for x in to["completion_tokens"])
        if t == 0.0:
            assert to["completion_tokens"] == jo["completion_tokens"]
        assert to["usage"]["batch_size"] == jo["usage"]["batch_size"] == len(REQUESTS)
        assert to["usage"]["prompt_tokens"] == len(p)
        assert to["usage"]["completion_tokens"] == n
        assert to["usage"]["latency_s"] > 0


def test_llm_server_flushes_full_batch_and_chunks(models, monkeypatch):
    """max_batch_size 2: four concurrent greedy requests go out as two
    full batches of 2 at once, never waiting for the 30 s timer."""
    _, _, tcfg, params = models
    srv = tserving.LLMServer(tcfg, params, max_batch_size=2,
                             batch_wait_timeout_s=30.0)
    calls = []
    real = tgeneration.generate
    monkeypatch.setattr(tgeneration, "generate",
                        lambda p, c, prompts, **kw: calls.append(len(prompts))
                        or real(p, c, prompts, **kw))

    async def go():
        t0 = time.monotonic()
        full = await asyncio.gather(*[srv({"prompt_tokens": p, "max_tokens": 2})
                                      for p in PROMPTS])
        return full, srv._batched._batch_queues[0].controller.stats(), time.monotonic() - t0

    outs, stats, wall = run(go())
    assert wall < 10
    assert calls == [2, 2]
    assert [o["usage"]["batch_size"] for o in outs] == [2, 2, 2, 2]
    assert stats["batches"] == 2 and stats["avg_batch"] == 2.0


# -------------------------------------------------------- LLMEngineServer
def test_engine_server_paths_match_jax(models, jax_engine_tokens):
    """__call__, stream and stream_deltas give JAX's LLMEngineServer
    tokens; stream_deltas ends with one terminal usage delta."""
    _, _, tcfg, params = models

    async def go():
        srv = tserving.LLMEngineServer(tcfg, params, **_engine_kw())

        async def via_stream(p):
            return [t async for t in srv.stream({"prompt_tokens": p,
                                                 "max_tokens": MAX_NEW})]

        async def via_deltas(p):
            return [d async for d in srv.stream_deltas({"prompt_tokens": p,
                                                        "max_tokens": MAX_NEW})]

        try:
            called = await asyncio.gather(*[
                srv({"prompt_tokens": p, "max_tokens": MAX_NEW}) for p in PROMPTS])
            streamed = await asyncio.gather(*[via_stream(p) for p in PROMPTS])
            deltas = await asyncio.gather(*[via_deltas(p) for p in PROMPTS])
        finally:
            await srv.engine.stop()
        return called, streamed, deltas, srv.engine_stats()

    called, streamed, deltas, stats = run(go())
    assert [c["completion_tokens"] for c in called] == jax_engine_tokens
    assert [c["usage"]["completion_tokens"] for c in called] == [MAX_NEW] * len(PROMPTS)
    assert streamed == jax_engine_tokens
    for p, ds, want in zip(PROMPTS, deltas, jax_engine_tokens):
        *blocks, last = ds
        assert blocks and all(d["tokens"] and set(d) == {"tokens"} for d in blocks)
        assert sum((d["tokens"] for d in blocks), []) == want
        assert last["tokens"] == [] and last["done"] is True
        assert last["usage"]["prompt_tokens"] == len(p)
        assert last["usage"]["completion_tokens"] == MAX_NEW
    assert stats["tokens_out"] == 3 * MAX_NEW * len(PROMPTS)
    assert stats["free_pages"] == 63 and stats["waiting"] == 0


@pytest.mark.parametrize("path", ["stream", "stream_deltas"])
def test_closing_a_stream_gives_the_pages_back(models, path):
    """A consumer that closes the stream after its first item cancels the
    request: the slot and every page come back long before 48 tokens."""
    _, _, tcfg, params = models

    async def go():
        srv = tserving.LLMEngineServer(tcfg, params, eos_id=tcfg.vocab_size,
                                       **_engine_kw())
        try:
            agen = getattr(srv, path)({"prompt_tokens": PROMPTS[2], "max_tokens": 40})
            first = await agen.__anext__()
            held = 63 - len(srv.engine.free_pages)
            await agen.aclose()
            for _ in range(600):
                if len(srv.engine.free_pages) == 63 and srv.engine.slot_req == [None, None]:
                    break
                await asyncio.sleep(0.01)
            return first, held, len(srv.engine.free_pages), srv.engine.tokens_out
        finally:
            await srv.engine.stop()

    first, held, free, tokens_out = run(go())
    assert first  # a token, or a non-empty delta
    assert held == -(-(len(PROMPTS[2]) + 40) // PS)
    assert free == 63
    assert tokens_out < 40


class _FullEngine:
    waiting = [None] * 3

    def submit(self, *a, **kw):
        raise EngineFull("queue at capacity")

    async def start(self):
        pass

    def cancel(self, rid):
        pass


class _JFullEngine(_FullEngine):
    def submit(self, *a, **kw):
        raise JEngineFull("queue at capacity")


def _stub_server(cls, engine):
    srv = cls.__new__(cls)
    srv.default_max_tokens = 4
    srv.engine = engine
    return srv


def test_engine_full_becomes_backpressure():
    """EngineFull -> BackPressureError(retry_after_s=min(2, 0.02 (1 +
    waiting))), the JAX server's value, on every request path."""
    jsrv = _stub_server(jserving.LLMEngineServer, _JFullEngine())
    with pytest.raises(JBackPressureError) as jei:
        jsrv._submit({"prompt_tokens": [1, 2, 3]})
    srv = _stub_server(tserving.LLMEngineServer, _FullEngine())
    req = {"prompt_tokens": [1, 2, 3]}
    with pytest.raises(BackPressureError) as ei:
        srv._submit(req)
    assert ei.value.retry_after_s == pytest.approx(jei.value.retry_after_s) \
        == pytest.approx(0.08)
    assert getattr(BackPressureError, "_rt_error_passthrough", False)

    async def drain(agen):
        return [x async for x in agen]

    with pytest.raises(BackPressureError):
        run(srv(req))
    for path in ("stream", "stream_deltas"):
        with pytest.raises(BackPressureError):
            run(drain(getattr(srv, path)(req)))


@pytest.mark.parametrize("prompt", [[], [256], [-1, 3]])
def test_bad_prompt_stays_value_error(models, prompt):
    """An empty prompt or an out-of-vocab id is the caller's error: a
    ValueError, never the BackPressureError that callers retry."""
    _, _, tcfg, params = models
    srv = tserving.LLMEngineServer(tcfg, params, **_engine_kw())
    with pytest.raises(ValueError) as ei:
        srv._submit({"prompt_tokens": prompt})
    assert not isinstance(ei.value, BackPressureError)


# ---------------------------------------------------- serve.batch, build
def test_batch_decorator_on_a_free_function():
    """The port's serve.batch coalesces a free function's concurrent calls
    and fails every caller of a batch whose result count is wrong."""
    sizes = []

    @batch(max_batch_size=4, batch_wait_timeout_s=0.01)
    async def double(xs):
        sizes.append(len(xs))
        return [2 * x for x in xs]

    @batch(max_batch_size=4, batch_wait_timeout_s=0.01)
    async def short(xs):
        return xs[:-1]

    async def go():
        got = await asyncio.gather(*[double(i) for i in range(6)])
        bad = await asyncio.gather(*[short(i) for i in range(2)], return_exceptions=True)
        return got, bad

    got, bad = run(go())
    assert got == [0, 2, 4, 6, 8, 10] and sizes == [4, 2]
    assert all(isinstance(b, ValueError) for b in bad)
    with pytest.raises(TypeError):
        batch(lambda xs: xs)


def test_build_functions_bind_the_servers(models):
    """build_llm_deployment / build_llm_engine_deployment give bound
    Applications (num_gpus in the actor options) whose class builds in
    process; deployment().options() re-validates."""
    _, _, tcfg, params = models
    app = tserving.build_llm_deployment(tcfg, params=params, max_batch_size=4,
                                        num_gpus=1)
    assert isinstance(app, Application) and app.deployment.name == "LLMServer"
    assert app.deployment.config.ray_actor_options == {"num_gpus": 1}
    assert app.deployment.config.max_ongoing_requests == 8
    srv = app.deployment._callable(*app.init_args, **app.init_kwargs)
    assert isinstance(srv, tserving.LLMServer) and srv.params is params
    eapp = tserving.build_llm_engine_deployment(tcfg, params=params, **_engine_kw())
    assert eapp.deployment.config.ray_actor_options == {}
    esrv = eapp.deployment._callable(*eapp.init_args, **eapp.init_kwargs)
    assert esrv.engine.PS == PS and esrv.engine.params is params
    with pytest.raises(ValueError):
        deployment(tserving.LLMServer).options(max_request_retries=-1)


def test_servers_init_weights_on_the_requested_device(models):
    """Without params both servers draw weights from seed 0 with
    llama_init on the device asked for; the same draws as a direct call."""
    import torch

    _, _, tcfg, _ = models
    a = tserving.LLMServer(tcfg, device="cpu").params
    b = tserving.LLMEngineServer(tcfg, device="cpu", **_engine_kw()).engine.params
    want = tllama.llama_init(torch.Generator().manual_seed(0), tcfg, "cpu")
    for x in (a, b):
        assert torch.equal(x["layers_1"]["wq"]["kernel"], want["layers_1"]["wq"]["kernel"])
