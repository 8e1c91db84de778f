"""The flash backward's plain version and the port's gradient formula
against the JAX package's Pallas backward kernels, on the CPU.

The JAX kernels run in Pallas interpret mode, as tests/test_flash_attention.py
runs them; the port's CPU path is its custom ops with their plain versions.
Inputs come from numpy seeds. atol 5e-5, rtol 5e-4: the JAX package's own
backward bounds (tests/test_flash_attention.py:47-50). The CUDA kernels
themselves are held against the same plain version on the card by
chip_smoke.py; the rounding of their bf16 tensor-core path (p and ds cast to
bf16 before the products that use them) is emulated here and held against
JAX within the bf16 bound."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import attention as jattention
from ray_tpu.ops.flash_attention import _flash_backward, _flash_forward
from ray_tpu.ops.flash_attention import flash_attention as jflash
from ray_tpu_torch import kernels
from ray_tpu_torch.ops.attention import attention as tattention
from ray_tpu_torch.ops.flash_attention import (
    _causal_mask,
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_plain,
    flash_attention_delta,
    launch_bwd_dkv,
    launch_bwd_dq,
)

ATOL, RTOL = 5e-5, 5e-4

from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse

# slowest test 5.2 s, no module set-up (the port's modules alone under -n 6);
# the limits are several times that, so one that fires names a stalled test
_module_limit, _test_limit = time_limits(module_s=120, test_s=60)

SHAPES = [(64, 64), (64, 128), (128, 64)]


def _arrays(seed, B=2, T=64, Tk=64, H=2, D=64, Hk=None):
    rng = np.random.default_rng(seed)
    Hk = H if Hk is None else Hk
    return (rng.standard_normal((B, T, H, D)).astype(np.float32),
            rng.standard_normal((B, Tk, Hk, D)).astype(np.float32),
            rng.standard_normal((B, Tk, Hk, D)).astype(np.float32),
            rng.standard_normal((B, T, H, D)).astype(np.float32))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,Tk", SHAPES)
def test_plain_backward_matches_jax_kernels(causal, T, Tk):
    q, k, v, do = _arrays(0, T=T, Tk=Tk)
    B, _, H, D = q.shape
    scale = 1.0 / math.sqrt(D)

    def bhtd(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, x.shape[1], D)

    def bthd(x):
        return np.asarray(x).reshape(B, H, x.shape[1], D).transpose(0, 2, 1, 3)

    qb, kb, vb, dob = map(bhtd, (q, k, v, do))
    ob, lse = _flash_forward(qb, kb, vb, causal=causal, sm_scale=scale, block_q=32,
                             block_k=32, interpret=True)
    want = _flash_backward(qb, kb, vb, ob, lse, dob, causal=causal, sm_scale=scale,
                           block_q=32, block_k=32, interpret=True)
    got = flash_attention_backward_plain(
        *map(torch.tensor, (q, k, v, bthd(ob))), torch.tensor(np.asarray(lse)[:, :, 0]),
        torch.tensor(do), causal=causal, sm_scale=scale)
    for g, w in zip(got, want):
        _close(g, bthd(w))
    # the public wrapper on a CPU tensor is the same plain version
    again = flash_attention_backward(
        *map(torch.tensor, (q, k, v, bthd(ob))), torch.tensor(np.asarray(lse)[:, :, 0]),
        torch.tensor(do), causal=causal)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def _nonlinear(o):
    return (o * o.cos()).sum()  # nonlinear so dO varies per element


def _jnonlinear(o):
    return jnp.sum(o * jnp.cos(o))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,Tk", SHAPES)
def test_grads_match_jax_grad(causal, T, Tk):
    q, k, v, _ = _arrays(1, T=T, Tk=Tk)
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    _nonlinear(flash_attention(*ts, causal=causal)).backward()

    def loss(q, k, v):
        return _jnonlinear(jflash(q, k, v, causal=causal, block_q=32, block_k=32,
                                  interpret=True))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for t, w in zip(ts, want):
        _close(t.grad, w)


@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_gqa_grads_through_attention(impl):
    # k/v carry 2 heads for q's 4: repeat_interleave's backward sums the
    # repeated heads back, as jnp.repeat's transpose does
    q, k, v, _ = _arrays(2, T=64, Tk=64, H=4, Hk=2)
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    _nonlinear(tattention(*ts, causal=True, impl=impl)).backward()

    def loss(q, k, v):
        return _jnonlinear(jattention(q, k, v, causal=True, impl=impl))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for t, w in zip(ts, want):
        assert t.grad.shape == w.shape
        _close(t.grad, w)


def test_only_q_requires_grad():
    q, k, v, _ = _arrays(3)
    tq = torch.tensor(q, requires_grad=True)
    _nonlinear(flash_attention(tq, torch.tensor(k), torch.tensor(v))).backward()

    def loss(q):
        return _jnonlinear(jflash(q, jnp.asarray(k), jnp.asarray(v), block_q=32,
                                  block_k=32, interpret=True))

    _close(tq.grad, jax.grad(loss)(jnp.asarray(q)))


def test_custom_ops_pass_opcheck():
    # the schemas (no mutated inputs, no aliased outputs: the remat policy
    # needs functional ops) and the forward's autograd registration
    q, k, v, do = (torch.tensor(x) for x in _arrays(4, B=1, T=32, Tk=32))
    out, lse = torch.ops.ray_tpu_torch.flash_attention_fwd(q, k, v, True, 0.125)
    q.requires_grad_(True)
    torch.library.opcheck(torch.ops.ray_tpu_torch.flash_attention_fwd.default,
                          (q, k, v, True, 0.125),
                          test_utils=("test_schema", "test_autograd_registration"))
    torch.library.opcheck(torch.ops.ray_tpu_torch.flash_attention_bwd.default,
                          (q.detach(), k, v, out, lse, do, True, 0.125),
                          test_utils=("test_schema",))


def test_cpu_backward_counts_no_launch():
    before = dict(kernels.LAUNCHES)
    ts = [torch.tensor(x, requires_grad=True) for x in _arrays(5)[:3]]
    _nonlinear(flash_attention(*ts)).backward()
    assert all(torch.isfinite(t.grad).all() for t in ts)
    assert dict(kernels.LAUNCHES) == before


@pytest.mark.parametrize("launch", [launch_bwd_dq, launch_bwd_dkv])
def test_kernel_launchers_refuse_cpu_tensors(launch):
    q, k, v, do = (torch.tensor(x) for x in _arrays(6, B=1, T=32, Tk=32))
    lse = delta = torch.zeros(2, 32)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        launch(q, k, v, do, lse, delta, causal=True, sm_scale=0.125)
    assert dict(kernels.LAUNCHES) == before


def _bf16_kernel_arithmetic(q, k, v, out, lse, do, *, causal, sm_scale):
    """The arithmetic of the bf16 backward kernels (csrc/flash_attention_bwd_
    {dq,dkv}.cu), emulated in plain PyTorch for this test: bf16 q/k/v/dO and
    saved out, float32 products and sums, p = exp(s scale - lse) and
    ds = p (dp - delta) scale in float32, then p and ds rounded to bf16
    before dv = pᵀ dO, dq = ds k and dk = dsᵀ q; outputs in bf16."""
    B, T, H, _ = q.shape
    Tk = k.shape[1]
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * sm_scale
    p = torch.exp(s - lse.reshape(B, H, T, 1))
    if causal:
        p = torch.where(_causal_mask(T, Tk, q.device), p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = flash_attention_delta(out, do).reshape(B, H, T, 1)
    ds = p * (dp - delta) * sm_scale
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    dq = torch.einsum("bhqk,bkhd->bqhd", dsb, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", dsb, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", pb, dof)
    return tuple(x.bfloat16() for x in (dq, dk, dv))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
def test_bf16_kernel_rounding_within_bf16_bound_of_jax(causal, D):
    # bf16 inputs; JAX runs its Pallas backward on their float32 upcasts
    B, T, H = 1, 128, 2
    scale = 1.0 / math.sqrt(D)
    q, k, v, do = (torch.tensor(x).bfloat16() for x in _arrays(7, B=B, T=T, Tk=T, H=H, D=D))

    def bhtd(x):
        return jnp.asarray(x.float().numpy()).transpose(0, 2, 1, 3).reshape(B * H, T, D)

    def bthd(x):
        return torch.tensor(np.asarray(x)).reshape(B, H, T, D).permute(0, 2, 1, 3)

    qb, kb, vb, dob = map(bhtd, (q, k, v, do))
    ob, lse = _flash_forward(qb, kb, vb, causal=causal, sm_scale=scale, block_q=32,
                             block_k=32, interpret=True)
    want = _flash_backward(qb, kb, vb, ob, lse, dob, causal=causal, sm_scale=scale,
                           block_q=32, block_k=32, interpret=True)
    out = bthd(ob).bfloat16()  # the forward kernel's output is in q's dtype
    got = _bf16_kernel_arithmetic(q, k, v, out, torch.tensor(np.asarray(lse)[:, :, 0]), do,
                                  causal=causal, sm_scale=scale)
    for g, w in zip(got, want):
        w = bthd(w)
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert bool(((g.float() - w).abs() <= 5e-2 + 5e-2 * w.abs()).all())
    # the rounding is real: the emulated pair differs from the float32 plain
    # version on the same inputs, within the same bound
    plain = flash_attention_backward_plain(q.float(), k.float(), v.float(), out.float(),
                                           torch.tensor(np.asarray(lse)[:, :, 0]),
                                           do.float(), causal=causal, sm_scale=scale)
    assert not all(torch.equal(g.float(), p.bfloat16().float()) for g, p in zip(got, plain))
