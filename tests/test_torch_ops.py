"""Parity of the port's ops with the JAX package's, on the CPU in float32.

Inputs come from a numpy seed and go through both; atol 1e-5 (float32
elementwise and small reductions in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import basic as jbasic
from ray_tpu.ops.attention import attention as jattention
from ray_tpu.parallel.ring_attention import reference_attention as jreference
from ray_tpu_torch.ops import basic as tbasic
from ray_tpu_torch.ops.attention import attention as tattention
from ray_tpu_torch.parallel.ring_attention import reference_attention as treference

from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse

# slowest test 1.1 s, no module set-up (the port's modules alone under -n 6);
# the limits are several times that, so one that fires names a stalled test
_module_limit, _test_limit = time_limits(module_s=120, test_s=60)


ATOL = 1e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, scale = _rand(rng, 2, 5, 64), _rand(rng, 64)
    _close(tbasic.rms_norm(torch.tensor(x), torch.tensor(scale)),
           jbasic.rms_norm(jnp.asarray(x), jnp.asarray(scale)))


def test_rms_norm_bf16_scales_in_f32_before_cast():
    rng = np.random.default_rng(1)
    x, scale = _rand(rng, 3, 64), _rand(rng, 64)
    got = tbasic.rms_norm(torch.tensor(x).bfloat16(), torch.tensor(scale).bfloat16())
    want = jbasic.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_rope_freqs():
    tc, ts = tbasic.rope_freqs(16, 64, 500000.0)
    jc, js = jbasic.rope_freqs(16, 64, 500000.0)
    _close(tc, jc)
    _close(ts, js)


@pytest.mark.parametrize("with_positions", [False, True])
def test_rope(with_positions):
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 6, 4, 16)
    tc, ts = tbasic.rope_freqs(16, 32)
    jc, js = jbasic.rope_freqs(16, 32)
    pos = rng.integers(0, 32, size=(2, 6))
    tp = torch.tensor(pos) if with_positions else None
    jp = jnp.asarray(pos) if with_positions else None
    _close(tbasic.rope(torch.tensor(x), tc, ts, tp), jbasic.rope(jnp.asarray(x), jc, js, jp))


def test_swiglu():
    rng = np.random.default_rng(3)
    x, wg, wu, wd = _rand(rng, 2, 3, 16), _rand(rng, 16, 32), _rand(rng, 16, 32), _rand(rng, 32, 16)
    _close(tbasic.swiglu(*map(torch.tensor, (x, wg, wu, wd))),
           jbasic.swiglu(*map(jnp.asarray, (x, wg, wu, wd))), atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention(causal):
    rng = np.random.default_rng(4)
    q, k, v = (_rand(rng, 2, 8, 4, 16) for _ in range(3))
    _close(treference(*map(torch.tensor, (q, k, v)), causal=causal),
           jreference(*map(jnp.asarray, (q, k, v)), causal=causal))


@pytest.mark.parametrize("impl", ["plain", "auto"])
def test_attention_gqa(impl):
    """GQA repeats each kv head over its group (repeat_interleave, as
    jnp.repeat does); on a CPU tensor ``auto`` picks plain."""
    rng = np.random.default_rng(5)
    q = _rand(rng, 2, 8, 4, 16)
    k, v = _rand(rng, 2, 8, 2, 16), _rand(rng, 2, 8, 2, 16)
    _close(tattention(*map(torch.tensor, (q, k, v)), impl=impl),
           jattention(*map(jnp.asarray, (q, k, v)), impl="plain"))


def test_auto_dispatch_gate():
    from ray_tpu_torch.ops.attention import _default_local_impl

    assert _default_local_impl(torch.zeros(1, 1024, 1, 64)) == "plain"  # CPU tensor
    assert _default_local_impl(torch.zeros(1, 1024, 1, 64, device="meta")) == "plain"


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_impls_raise(impl):
    """ring and ulysses are ported now: with no mesh they run as a world of
    one rank and give JAX's exact attention (GQA heads repeated first); the
    multi-rank parity is tests/test_torch_parallel.py. An unknown impl
    still raises."""
    rng = np.random.default_rng(9)
    q, k, v = _rand(rng, 2, 16, 4, 8), _rand(rng, 2, 16, 2, 8), _rand(rng, 2, 16, 2, 8)
    want = jreference(jnp.asarray(q), jnp.repeat(jnp.asarray(k), 2, axis=2),
                      jnp.repeat(jnp.asarray(v), 2, axis=2), causal=True)
    _close(tattention(torch.tensor(q), torch.tensor(k), torch.tensor(v), impl=impl), want)
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="unknown"):
        tattention(x, x, x, impl=impl + "_typo")
