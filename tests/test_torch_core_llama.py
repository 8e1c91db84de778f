"""A Llama loss computed in an actor of the port's runtime, against JAX.

The tiny Llama is initialised by JAX and carried across with
``params_from_numpy``; the weights travel through the port's object store
(``put``, then the ref as the actor's argument) into a port actor that runs
on the CPU. Its ``llama_loss`` must equal JAX's ``llama_loss`` on the same
numpy tokens within 1e-5 (float32), and the port's in-process loss exactly:
the same code on the same bytes, one torch thread in both processes.
"""

import os

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.models import llama as jllama
from ray_tpu_torch.models import llama as tllama

from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse

# slowest test 16.5 s, no module set-up (the port's modules alone under -n 6);
# the limits are several times that, so one that fires names a stalled test
_module_limit, _test_limit = time_limits(module_s=120, test_s=120)


ATOL = 1e-5

_jloss = jax.jit(jllama.llama_loss, static_argnames=("cfg",))


@pytest.fixture(scope="module")
def rt():
    torch.set_num_threads(1)
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # the workers inherit it
    ray_tpu_torch.shutdown()  # a runtime another module left in this process
    ray_tpu_torch.init(num_cpus=2)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()
    if saved is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = saved


@ray_tpu_torch.remote
class _LossActor:
    def __init__(self, params):
        torch.set_num_threads(1)
        self.params = params
        self.cfg = tllama.LlamaConfig.tiny()

    def loss(self, tokens):
        return float(tllama.llama_loss(self.params, {"tokens": torch.from_numpy(tokens)},
                                       self.cfg))

    def param_dtypes(self):
        return sorted({str(t.dtype) for t in _leaves(self.params)})


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_actor_loss_matches_jax_and_in_process(rt):
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.llama_init(jax.random.PRNGKey(0), jcfg)
    tcfg = tllama.LlamaConfig.tiny()
    params = tllama.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(2, 33)).astype(np.int32)

    actor = _LossActor.remote(rt.put(params))
    got = rt.get(actor.loss.remote(toks), timeout=120)
    want = float(_jloss(jparams, {"tokens": jax.numpy.asarray(toks)}, cfg=jcfg))
    in_process = float(tllama.llama_loss(params, {"tokens": torch.from_numpy(toks)}, tcfg))
    assert rt.get(actor.param_dtypes.remote(), timeout=60) == ["torch.float32"]
    assert abs(got - want) <= ATOL, (got, want)
    assert got == in_process
    rt.kill(actor)
