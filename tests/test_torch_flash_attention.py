"""The flash forward's plain version against the JAX Pallas kernel.

On a CPU tensor the port's ``flash_attention`` runs
``flash_attention_plain``; the JAX kernel runs in Pallas interpret mode,
as tests/test_flash_attention.py runs it. atol 2e-5, the JAX kernel's own
float32 bound. The CUDA kernel itself is held against the same plain
version on the card by chip_smoke.py; the rounding of its bf16 tensor-core
body (p cast to bf16 before P·V) is emulated here and held against JAX
within the JAX package's bf16 bound, 5e-2 + 5e-2·|ref|."""

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
    _causal_mask,
    _launch_fwd,
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
    before = kernels.launches()[KERNEL]
    flash_attention(*map(torch.tensor, _qkv(4, T=32)))
    assert kernels.launches()[KERNEL] == before


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


def test_kernel_launcher_refuses_cpu_tensors():
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        _launch_fwd(*map(torch.tensor, _qkv(8, T=32)), True, 0.125)
    assert dict(kernels.LAUNCHES) == before


def _bf16_kernel_arithmetic(q, k, v, *, causal, sm_scale, block_k=64):
    """The arithmetic of the bf16 forward kernel (csrc/flash_attention_fwd.cu
    ``flash_fwd_tc_kernel``), emulated in plain PyTorch for this test: bf16
    q/k/v; float32 S = Q Kᵀ and online softmax over key tiles of
    ``block_k``; p rounded to bf16 before P·V, l summed over the unrounded
    p; out rounded to bf16 once; lse = m + log(l) as [B*H, T] float32."""
    B, T, H, D = q.shape
    Tk = k.shape[1]
    qf, kf, vf = (x.float() for x in (q, k, v))
    m = torch.full((B, H, T, 1), -math.inf)
    l = torch.zeros((B, H, T, 1))
    acc = torch.zeros((B, H, T, D))
    for k0 in range(0, Tk, block_k):
        kt, vt = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kt) * sm_scale
        if causal:  # every row keeps key 0, so m is finite from the first tile
            s = s.masked_fill(~_causal_mask(T, Tk, q.device)[:, k0:k0 + block_k],
                              -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)  # exactly 0 where masked
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhqk,bkhd->bhqd", p.bfloat16().float(), vt)
        m = m_new
    l = l.clamp_min(1e-30)
    out = (acc / l).permute(0, 2, 1, 3).bfloat16()
    return out, (m + torch.log(l))[..., 0].reshape(B * H, T)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,Tk", [(128, 128), (64, 192), (192, 64)])
def test_bf16_kernel_rounding_within_bf16_bound_of_jax(causal, T, Tk):
    # bf16 inputs; JAX runs its Pallas forward on their float32 upcasts
    B, H, D = 1, 2, 128
    scale = 1.0 / math.sqrt(D)
    q, k, v = (torch.tensor(x).bfloat16() for x in _qkv(9, B=B, T=T, Tk=Tk, H=H, D=D))

    def bhtd(x):
        return jnp.asarray(x.float().numpy()).transpose(0, 2, 1, 3).reshape(
            B * H, x.shape[1], D)

    jout, jlse = _flash_forward(*map(bhtd, (q, k, v)), causal=causal, sm_scale=scale,
                                block_q=64, block_k=64, interpret=True)
    want = torch.tensor(np.asarray(jout)).reshape(B, H, T, D).permute(0, 2, 1, 3)
    got, lse = _bf16_kernel_arithmetic(q, k, v, causal=causal, sm_scale=scale)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert bool(((got.float() - want).abs() <= 5e-2 + 5e-2 * want.abs()).all())
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, 0], atol=1e-3, rtol=0)
    # the rounding is real: the emulated kernel differs from the float32
    # plain version on the same inputs rounded once, within the same bound
    plain, _ = flash_attention_forward(q.float(), k.float(), v.float(), causal=causal)
    assert not torch.equal(got, plain.bfloat16())
