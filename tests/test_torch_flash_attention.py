"""The flash forward's plain version against the JAX Pallas kernel.

On a CPU tensor the port's ``flash_attention`` runs
``flash_attention_plain``; the JAX kernel runs in Pallas interpret mode,
as tests/test_flash_attention.py runs it. atol 2e-5, the JAX kernel's own
float32 bound. The CUDA kernel itself is held against the same plain
version on the card by chip_smoke.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.flash_attention import _flash_forward
from ray_tpu.ops.flash_attention import flash_attention as jflash
from ray_tpu_torch import kernels
from ray_tpu_torch.ops.flash_attention import (
    KERNEL,
    flash_attention,
    flash_attention_forward,
)

ATOL = 2e-5


def _qkv(seed, B=2, T=128, Tk=None, H=4, D=64):
    rng = np.random.default_rng(seed)
    Tk = T if Tk is None else Tk
    return (rng.standard_normal((B, T, H, D)).astype(np.float32),
            rng.standard_normal((B, Tk, H, D)).astype(np.float32),
            rng.standard_normal((B, Tk, H, D)).astype(np.float32))


def _both(qkv, causal, block_q, block_k):
    got = flash_attention(*map(torch.tensor, qkv), causal=causal,
                          block_q=block_q, block_k=block_k)
    want = jflash(*map(jnp.asarray, qkv), causal=causal, block_q=block_q,
                  block_k=block_k, interpret=True)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_jax_kernel(causal):
    got, want = _both(_qkv(0), causal, 64, 64)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_block_q_ne_block_k():
    got, want = _both(_qkv(1), True, 64, 32)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,Tk", [(64, 128), (128, 64)])
def test_t_ne_tk_top_left_causal(causal, T, Tk):
    got, want = _both(_qkv(2, T=T, Tk=Tk), causal, 32, 32)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_slim_lse_matches_kernel_lse_column(causal):
    q, k, v = _qkv(3, T=64, Tk=128)
    B, T, H, D = q.shape

    def bhtd(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, x.shape[1], D)

    _, jlse = _flash_forward(bhtd(q), bhtd(k), bhtd(v), causal=causal,
                             sm_scale=1.0 / math.sqrt(D), block_q=32,
                             block_k=64, interpret=True)
    _, lse = flash_attention_forward(*map(torch.tensor, (q, k, v)), causal=causal)
    assert lse.shape == (B * H, T) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, 0], atol=ATOL, rtol=0)


def test_cpu_runs_plain_and_counts_no_launch():
    before = kernels.LAUNCHES[KERNEL]
    flash_attention(*map(torch.tensor, _qkv(4, T=32)))
    assert kernels.LAUNCHES[KERNEL] == before


def test_requires_grad_gets_finite_grads_and_counts_no_launch():
    before = dict(kernels.LAUNCHES)
    q, k, v = map(torch.tensor, _qkv(5, T=32))
    q.requires_grad_(True)
    out = flash_attention(q, k, v)
    out.square().sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    assert dict(kernels.LAUNCHES) == before


def test_explicit_blocks_must_divide():
    with pytest.raises(ValueError, match="must divide"):
        flash_attention(*map(torch.tensor, _qkv(6, T=96)), block_q=64)


def test_unequal_heads_raise():
    q, k, v = map(torch.tensor, _qkv(7, T=32))
    with pytest.raises(ValueError, match="GQA"):
        flash_attention(q, k[:, :, :2], v[:, :, :2])
