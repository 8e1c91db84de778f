"""Flagship model: Llama-family decoder-only transformer in PyTorch.

Counterpart of ``ray_tpu/models/llama.py`` (dense path: forward, loss and
``make_train_step``). Parameters are the same nested dict as the JAX pytree
(``params["layers_{i}"]["wq"]["kernel"]``, ...), kernels stored
[d_in, d_out] so every projection is ``x @ w``; the embedding and
``lm_head`` are separate, not tied. Attention dispatches through
``ops.attention`` exactly as the JAX forward does. With ``cfg.remat`` each
block runs under JAX's selective-remat policy (``ops/remat.py``).

Not in this slice (ROADMAP, PyTorch/CUDA port): MoE layers and the
pipelined and tensor-parallel variants.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.basic import rms_norm, rope, rope_freqs, swiglu
from ray_tpu_torch.ops.remat import checkpoint_name, save_only_these_names
from ray_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    # MoE: 0 experts = dense; else every `moe_every`-th layer is MoE
    n_experts: int = 0
    moe_every: int = 2
    capacity_factor: float = 1.25
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        return cls(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                   n_kv_heads=2, d_ff=128, max_seq_len=128, dtype="float32", **kw)

    @classmethod
    def llama2_7b(cls) -> "LlamaConfig":
        return cls(vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
                   n_kv_heads=32, d_ff=11008, max_seq_len=4096)

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls(vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, d_ff=14336, max_seq_len=8192,
                   rope_theta=500000.0)


def _check_dense(cfg: LlamaConfig) -> None:
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "MoE layers wait for a later slice (ROADMAP, PyTorch/CUDA port: "
            "MoE and the parallel variants)")


def _normal(generator, shape, std, dtype, device):
    # drawn in float32 and cast, as the JAX init scales a float32 normal
    return (torch.randn(shape, generator=generator, device=device) * std).to(dtype)


def _dense(generator, d_in, d_out, dtype, device):
    scale = (2.0 / (d_in + d_out)) ** 0.5
    return {"kernel": _normal(generator, (d_in, d_out), scale, dtype, device)}


def llama_init(generator: torch.Generator, cfg: LlamaConfig, device=None) -> dict:
    """Random weights with the JAX init's scales, drawn from ``generator``
    (which must live on ``device``; ``None`` means cuda). The draws differ
    from ``jax.random``'s: carry JAX weights over with ``params_from_numpy``."""
    _check_dense(cfg)
    device = resolve_device(device)
    dtype = cfg.torch_dtype
    hd = cfg.head_dim
    params: dict = {"tok": {"embedding": _normal(
        generator, (cfg.vocab_size, cfg.d_model), 0.02, dtype, device)}}
    for i in range(cfg.n_layers):
        params[f"layers_{i}"] = {
            "attn_norm": {"scale": torch.ones(cfg.d_model, dtype=dtype, device=device)},
            "wq": _dense(generator, cfg.d_model, cfg.n_heads * hd, dtype, device),
            "wk": _dense(generator, cfg.d_model, cfg.n_kv_heads * hd, dtype, device),
            "wv": _dense(generator, cfg.d_model, cfg.n_kv_heads * hd, dtype, device),
            "wo": _dense(generator, cfg.n_heads * hd, cfg.d_model, dtype, device),
            "ffn_norm": {"scale": torch.ones(cfg.d_model, dtype=dtype, device=device)},
            "w_gate": _dense(generator, cfg.d_model, cfg.d_ff, dtype, device),
            "w_up": _dense(generator, cfg.d_model, cfg.d_ff, dtype, device),
            "w_down": _dense(generator, cfg.d_ff, cfg.d_model, dtype, device),
        }
    params["norm"] = {"scale": torch.ones(cfg.d_model, dtype=dtype, device=device)}
    params["lm_head"] = _dense(generator, cfg.d_model, cfg.vocab_size, dtype, device)
    return params


def params_from_numpy(tree: dict, cfg: LlamaConfig, *, device=None,
                      dtype: torch.dtype | None = None) -> dict:
    """The port's parameters from a JAX Llama pytree already converted to
    numpy (``jax.tree.map(np.asarray, params)``): the same keys, kernels
    kept [d_in, d_out], cast to ``dtype`` (default: ``cfg.dtype``)."""
    _check_dense(cfg)
    device = resolve_device(device)
    dtype = dtype or cfg.torch_dtype

    def conv(node):
        if isinstance(node, dict):
            return {key: conv(val) for key, val in node.items()}
        arr = np.asarray(node)
        # numpy has no bfloat16: go through float32
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
            device=device, dtype=dtype)

    want = {"tok", "norm", "lm_head", *(f"layers_{i}" for i in range(cfg.n_layers))}
    if set(tree) != want:
        raise ValueError(f"pytree keys {sorted(tree)} do not match cfg "
                         f"({cfg.n_layers} dense layers)")
    return conv(tree)


def _block(layer, x, cos, sin, cfg: LlamaConfig, attn_impl):
    B, T, D = x.shape
    hd = cfg.head_dim
    h = rms_norm(x, layer["attn_norm"]["scale"])
    q = (h @ layer["wq"]["kernel"]).reshape(B, T, cfg.n_heads, hd)
    k = (h @ layer["wk"]["kernel"]).reshape(B, T, cfg.n_kv_heads, hd)
    v = (h @ layer["wv"]["kernel"]).reshape(B, T, cfg.n_kv_heads, hd)
    # named for the remat policy: the flash backward consumes q/k/v, and
    # the saved attention output spares the O(T^2) forward's recompute
    q = checkpoint_name(rope(q, cos, sin), "attn_qkv")
    k = checkpoint_name(rope(k, cos, sin), "attn_qkv")
    v = checkpoint_name(v, "attn_qkv")
    att = checkpoint_name(attention(q, k, v, causal=True, impl=attn_impl), "attn_out")
    x = x + att.reshape(B, T, cfg.n_heads * hd) @ layer["wo"]["kernel"]
    h = rms_norm(x, layer["ffn_norm"]["scale"])
    return x + swiglu(h, layer["w_gate"]["kernel"], layer["w_up"]["kernel"],
                      layer["w_down"]["kernel"])


def _maybe_remat_block(cfg: LlamaConfig):
    """JAX's selective remat: with ``cfg.remat`` (and autograd on) each block
    runs under a non-reentrant ``checkpoint`` that saves the post-rope
    q/k/v, the attention output (with the flash forward's out and lse) and
    the FFN gate/up products, and recomputes the rest in the backward."""
    if not cfg.remat or not torch.is_grad_enabled():
        return _block
    context_fn = save_only_these_names("attn_out", "attn_qkv", "ffn_hidden")

    def block(layer, x, cos, sin, cfg, attn_impl):
        return checkpoint(_block, layer, x, cos, sin, cfg, attn_impl,
                          use_reentrant=False, context_fn=context_fn)

    return block


def _ce_loss(logits, targets):
    """Next-token cross entropy."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets[..., None].long())[..., 0].mean()


def llama_forward(params, tokens, cfg: LlamaConfig, *, mesh=None,
                  attn_impl: str = "auto", seq_axis: str | None = "sp"):
    """tokens: [B, T] integer -> (logits [B, T, V], aux loss 0.0).

    Runs on the device of ``params``; ``tokens`` are moved there."""
    _check_dense(cfg)
    if mesh is not None:
        raise NotImplementedError(
            "sharded forwards wait for the parallel slice (ROADMAP, "
            "PyTorch/CUDA port: MoE and the parallel variants)")
    emb = params["tok"]["embedding"]
    tokens = torch.as_tensor(tokens, device=emb.device).long()
    cos, sin = rope_freqs(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                          device=emb.device)
    x = emb[tokens]
    block = _maybe_remat_block(cfg)
    for i in range(cfg.n_layers):
        x = block(params[f"layers_{i}"], x, cos, sin, cfg, attn_impl)
    x = rms_norm(x, params["norm"]["scale"])
    return x @ params["lm_head"]["kernel"], 0.0


def llama_loss(params, batch, cfg: LlamaConfig, *, mesh=None, attn_impl="auto"):
    """Next-token cross entropy; batch: {"tokens": [B, T+1]}."""
    tokens = torch.as_tensor(batch["tokens"], device=params["tok"]["embedding"].device)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits, aux = llama_forward(params, inputs, cfg, mesh=mesh, attn_impl=attn_impl)
    return _ce_loss(logits, targets) + 0.01 * aux


class AdamW:
    """The optax ``adamw`` transformation on ``torch.optim.AdamW``: the
    optimizer is a library one in both packages (optax in JAX), not a
    kernel. Every hyperparameter is passed to torch explicitly, with
    optax's defaults (torch's ``weight_decay`` default is 1e-2, optax's
    1e-4). Moments are kept in the parameter dtype, as optax does with
    ``mu_dtype=None``."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        self.hyper = dict(lr=learning_rate, betas=(b1, b2), eps=eps,
                          weight_decay=weight_decay)

    def init(self, params) -> torch.optim.AdamW:
        """The optimizer state over the leaves of ``params``, which become
        leaf tensors that require grad and are updated in place."""
        leaves = list(_leaves(params))
        for t in leaves:
            t.requires_grad_(True)
        return torch.optim.AdamW(leaves, **self.hyper)

    @staticmethod
    def update(opt_state: torch.optim.AdamW) -> None:
        """Apply the gradients the backward pass left on the leaves."""
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)


def _leaves(tree):
    if isinstance(tree, dict):
        for val in tree.values():
            yield from _leaves(val)
    else:
        yield tree


def make_train_step(cfg: LlamaConfig, optimizer: AdamW, *, mesh=None,
                    attn_impl: str = "auto"):
    """Returns step(params, opt_state, batch) -> (params, opt_state, loss),
    the call shape of the JAX ``make_train_step``; ``opt_state`` is
    ``optimizer.init(params)``. The update is made in place, the
    counterpart of donating params and opt_state: the returned params and
    opt_state are the objects passed in."""
    _check_dense(cfg)
    if mesh is not None:
        raise NotImplementedError(
            "sharded training waits for the parallel slice (ROADMAP, "
            "PyTorch/CUDA port: MoE and the parallel variants)")

    def step(params, opt_state, batch):
        loss = llama_loss(params, batch, cfg, attn_impl=attn_impl)
        loss.backward()
        optimizer.update(opt_state)
        return params, opt_state, loss.detach()

    return step
