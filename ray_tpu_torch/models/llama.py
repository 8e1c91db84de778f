"""Flagship model: Llama-family decoder-only transformer in PyTorch.

Counterpart of ``ray_tpu/models/llama.py``. Parameters are the same nested
dict as the JAX pytree (``params["layers_{i}"]["wq"]["kernel"]``, ...),
kernels stored [d_in, d_out] so every projection is ``x @ w``; the
embedding and ``lm_head`` are separate, not tied. Attention dispatches
through ``ops.attention`` exactly as the JAX forward does. With
``cfg.remat`` each block runs under JAX's selective-remat policy
(``ops/remat.py``). MoE layers (every ``moe_every``-th, with ``n_experts``
> 0) run ``parallel.moe.moe_ffn_local``; as in JAX its float32 dispatch
promotes the residual stream to float32 from the first MoE layer on, so
every product goes through ``ops.basic.matmul``.

With a mesh, the forward, loss and train step run in PyTorch's local view
(one process per mesh position): the sequence is split over ``sp`` (ring
attention, rope at global positions) and the batch rows and the experts
over ``ep``. The pipelined and tensor-parallel variant is ``llama_pp_loss``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops.attention import attention, sequence_attention
from ray_tpu_torch.ops.basic import matmul, rms_norm, rope, rope_freqs, swiglu
from ray_tpu_torch.ops.remat import checkpoint_name, save_only_these_names
from ray_tpu_torch.parallel.comm import (
    axis_index,
    axis_size,
    gather,
    psum,
    replicate,
    shard,
)
from ray_tpu_torch.parallel.moe import moe_ffn_local
from ray_tpu_torch.parallel.pipeline import pipeline_apply, stack_stage_params
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

    @classmethod
    def llama3_8b_switch8(cls) -> "LlamaConfig":
        """Llama-3-8B's widths with the Switch Transformer's MoE layout
        (Fedus et al., "Switch Transformers", JMLR 2022, sections 2.1-2.2):
        8 top-1 experts in every second layer, capacity factor 1.25."""
        return dataclasses.replace(cls.llama3_8b(), n_experts=8)


def _is_moe_layer(cfg: LlamaConfig, i: int) -> bool:
    return cfg.n_experts > 0 and (i % cfg.moe_every == cfg.moe_every - 1)


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
    device = resolve_device(device)
    dtype = cfg.torch_dtype
    hd = cfg.head_dim
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    params: dict = {"tok": {"embedding": _normal(
        generator, (cfg.vocab_size, D), 0.02, dtype, device)}}
    for i in range(cfg.n_layers):
        layer = {
            "attn_norm": {"scale": torch.ones(D, dtype=dtype, device=device)},
            "wq": _dense(generator, D, cfg.n_heads * hd, dtype, device),
            "wk": _dense(generator, D, cfg.n_kv_heads * hd, dtype, device),
            "wv": _dense(generator, D, cfg.n_kv_heads * hd, dtype, device),
            "wo": _dense(generator, cfg.n_heads * hd, D, dtype, device),
            "ffn_norm": {"scale": torch.ones(D, dtype=dtype, device=device)},
        }
        if _is_moe_layer(cfg, i):
            layer["moe"] = {
                "gate": {"kernel": _normal(generator, (D, E), 0.02, dtype, device)},
                "w_up": {"kernel": _normal(generator, (E, D, Fd), 0.02, dtype, device)},
                "w_down": {"kernel": _normal(generator, (E, Fd, D), 0.02, dtype, device)},
            }
        else:
            layer["w_gate"] = _dense(generator, D, Fd, dtype, device)
            layer["w_up"] = _dense(generator, D, Fd, dtype, device)
            layer["w_down"] = _dense(generator, Fd, D, dtype, device)
        params[f"layers_{i}"] = layer
    params["norm"] = {"scale": torch.ones(D, dtype=dtype, device=device)}
    params["lm_head"] = _dense(generator, D, cfg.vocab_size, dtype, device)
    return params


def params_from_numpy(tree: dict, cfg: LlamaConfig, *, device=None,
                      dtype: torch.dtype | None = None) -> dict:
    """The port's parameters from a JAX Llama pytree already converted to
    numpy (``jax.tree.map(np.asarray, params)``): the same keys, kernels
    kept [d_in, d_out], cast to ``dtype`` (default: ``cfg.dtype``)."""
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
                         f"({cfg.n_layers} layers)")
    for i in range(cfg.n_layers):
        if ("moe" in tree[f"layers_{i}"]) != _is_moe_layer(cfg, i):
            raise ValueError(f"layers_{i} keys {sorted(tree[f'layers_{i}'])} do not match "
                             f"cfg (n_experts={cfg.n_experts}, moe_every={cfg.moe_every})")
    return conv(tree)


@dataclasses.dataclass(frozen=True)
class _Split:
    """How a sharded forward splits the tokens: batch rows (and experts)
    over ``ep``, the sequence over ``seq``; ``None`` for an axis of size 1."""

    mesh: object
    ep: str | None
    seq: str | None

    @property
    def n_tokens_shards(self) -> int:
        return axis_size(self.mesh, self.ep) * axis_size(self.mesh, self.seq)


_ITEM5 = ("waits for ROADMAP Queue 1 item 5 (whole-step dp/fsdp/tp sharding through "
          "train/); a pipeline with tp inside its stages is llama_pp_loss")


def _token_axes(mesh, seq_axis) -> _Split | None:
    """The split a forward with ``mesh`` makes, or ``None`` for none."""
    if mesh is None:
        return None
    for ax in ("dp", "fsdp", "tp", "pp"):
        if axis_size(mesh, ax) > 1:
            raise NotImplementedError(f"a Llama forward sharded over {ax!r} {_ITEM5}")
    ep = "ep" if axis_size(mesh, "ep") > 1 else None
    seq = seq_axis if axis_size(mesh, seq_axis) > 1 else None
    return _Split(mesh, ep, seq) if ep or seq else None


def _local_params(params, split: _Split):
    """This rank's view of the global ``params``: experts sharded over ep,
    everything else replicated over the token-splitting axes (so each
    gradient is summed over the ranks whose tokens it saw)."""
    mesh = split.mesh

    def rep(node):
        if isinstance(node, dict):
            return {k: rep(v) for k, v in node.items()}
        return replicate(replicate(node, mesh, split.ep), mesh, split.seq)

    def experts(node):  # [E, ...] -> this rank's [E/ep, ...]
        return {"kernel": replicate(shard(node["kernel"], 0, mesh, split.ep), mesh, split.seq)}

    out = {}
    for name, node in params.items():
        if name.startswith("layers_") and "moe" in node:
            moe = node["moe"]
            out[name] = {**rep({k: v for k, v in node.items() if k != "moe"}),
                         "moe": {"gate": rep(moe["gate"]), "w_up": experts(moe["w_up"]),
                                 "w_down": experts(moe["w_down"])}}
        else:
            out[name] = rep(node)
    return out


def _block(layer, x, cos, sin, cfg: LlamaConfig, attn_impl, split: _Split | None = None):
    B, T, D = x.shape
    hd = cfg.head_dim
    h = rms_norm(x, layer["attn_norm"]["scale"])
    q = matmul(h, layer["wq"]["kernel"]).reshape(B, T, cfg.n_heads, hd)
    k = matmul(h, layer["wk"]["kernel"]).reshape(B, T, cfg.n_kv_heads, hd)
    v = matmul(h, layer["wv"]["kernel"]).reshape(B, T, cfg.n_kv_heads, hd)
    # named for the remat policy: the flash backward consumes q/k/v, and
    # the saved attention output spares the O(T^2) forward's recompute
    q = checkpoint_name(rope(q, cos, sin), "attn_qkv")
    k = checkpoint_name(rope(k, cos, sin), "attn_qkv")
    v = checkpoint_name(v, "attn_qkv")
    if split is not None and split.seq:
        att = sequence_attention(q, k, v, mesh=split.mesh, seq_axis=split.seq,
                                 impl=attn_impl)
    else:
        att = attention(q, k, v, causal=True, impl=attn_impl)
    att = checkpoint_name(att, "attn_out")
    x = x + matmul(att.reshape(B, T, cfg.n_heads * hd), layer["wo"]["kernel"])
    h = rms_norm(x, layer["ffn_norm"]["scale"])
    if "moe" not in layer:
        return x + swiglu(h, layer["w_gate"]["kernel"], layer["w_up"]["kernel"],
                          layer["w_down"]["kernel"]), 0.0
    moe = layer["moe"]
    split = split or _Split(None, None, None)
    n = B * T * split.n_tokens_shards  # the capacity of the whole batch
    out, aux = moe_ffn_local(h, moe["gate"]["kernel"], moe["w_up"]["kernel"],
                             moe["w_down"]["kernel"],
                             capacity=max(1, int(cfg.capacity_factor * n / cfg.n_experts)),
                             mesh=split.mesh, ep_axis=split.ep, seq_axis=split.seq)
    return x + out, aux  # a float32 out promotes the residual stream, as in JAX


def _maybe_remat_block(cfg: LlamaConfig):
    """JAX's selective remat: with ``cfg.remat`` (and autograd on) each block
    runs under a non-reentrant ``checkpoint`` that saves the post-rope
    q/k/v, the attention output (with the flash forward's out and lse) and
    the FFN gate/up products, and recomputes the rest (the MoE FFN whole)
    in the backward."""
    if not cfg.remat or not torch.is_grad_enabled():
        return _block
    context_fn = save_only_these_names("attn_out", "attn_qkv", "ffn_hidden")

    def block(*args):
        return checkpoint(_block, *args, use_reentrant=False, context_fn=context_fn)

    return block


def _ce_loss(logits, targets):
    """Next-token cross entropy."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets[..., None].long())[..., 0].mean()


def _local_tokens(tokens, split: _Split):
    return shard(shard(tokens, 0, split.mesh, split.ep), 1, split.mesh, split.seq)


def _forward(params, tokens, cfg: LlamaConfig, split: _Split | None, attn_impl):
    """(logits of this rank's tokens, the aux loss summed over layers)."""
    emb = params["tok"]["embedding"]
    tokens = torch.as_tensor(tokens, device=emb.device).long()
    cos, sin = rope_freqs(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                          device=emb.device)
    if split is not None:
        tokens = _local_tokens(tokens, split)
        params = _local_params(params, split)
        start = axis_index(split.mesh, split.seq) * tokens.shape[1]  # rope at global positions
        cos, sin = cos[start:], sin[start:]
    x = params["tok"]["embedding"][tokens]
    aux_total = 0.0
    block = _maybe_remat_block(cfg)
    for i in range(cfg.n_layers):
        x, aux = block(params[f"layers_{i}"], x, cos, sin, cfg, attn_impl, split)
        aux_total = aux_total + aux
    x = rms_norm(x, params["norm"]["scale"])
    return matmul(x, params["lm_head"]["kernel"]), aux_total


def llama_forward(params, tokens, cfg: LlamaConfig, *, mesh=None,
                  attn_impl: str = "auto", seq_axis: str | None = "sp"):
    """tokens: [B, T] integer -> (logits [B, T, V], aux loss; 0.0 with no
    MoE layer).

    Runs on the device of ``params``; ``tokens`` are moved there. With a
    mesh, every rank passes the same params and tokens, works on its share
    (the sequence split over ``seq_axis``, batch rows and experts over
    ``ep``) and returns the whole logits."""
    split = _token_axes(mesh, seq_axis)
    logits, aux = _forward(params, tokens, cfg, split, attn_impl)
    if split is not None:
        logits = gather(gather(logits, 1, mesh, split.seq), 0, mesh, split.ep)
    return logits, aux


def llama_loss(params, batch, cfg: LlamaConfig, *, mesh=None, attn_impl="auto"):
    """Next-token cross entropy; batch: {"tokens": [B, T+1]}."""
    tokens = torch.as_tensor(batch["tokens"], device=params["tok"]["embedding"].device)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    split = _token_axes(mesh, "sp")
    logits, aux = _forward(params, inputs, cfg, split, attn_impl)
    if split is None:
        return _ce_loss(logits, targets) + 0.01 * aux
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, _local_tokens(targets, split)[..., None].long()).sum()
    nll = psum(psum(nll, mesh, split.ep), mesh, split.seq)
    return nll / targets.numel() + 0.01 * aux


# ------------------------------------------------------- pipelined variant
def _check_pp(cfg: LlamaConfig, n_stages: int) -> None:
    if cfg.n_experts:
        raise ValueError("pipelined llama requires dense layers (n_experts=0)")
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers not divisible by {n_stages} stages")


def stack_pp_params(params: dict, cfg: LlamaConfig, n_stages: int) -> dict:
    """A ``llama_init`` tree restacked as ``llama_pp_init`` lays it out:
    ``stages`` leaves carry a leading [n_stages, layers_per_stage] axis;
    embedding, norm and head stay in ``dense``."""
    _check_pp(cfg, n_stages)
    dense = dict(params)
    per = cfg.n_layers // n_stages
    layers = [dense.pop(f"layers_{i}") for i in range(cfg.n_layers)]
    stages = [stack_stage_params(layers[s * per:(s + 1) * per]) for s in range(n_stages)]
    return {"dense": dense, "stages": stack_stage_params(stages)}


def llama_pp_init(generator: torch.Generator, cfg: LlamaConfig, n_stages: int,
                  device=None) -> dict:
    """Init with transformer layers stacked for pipeline parallelism (see
    ``stack_pp_params``). Dense layers only."""
    _check_pp(cfg, n_stages)
    return stack_pp_params(llama_init(generator, cfg, device), cfg, n_stages)


def _block_tp(layer, x, cos, sin, cfg: LlamaConfig, mesh, tp_axis: str):
    """Megatron-style tensor-parallel block on one rank of ``tp_axis``, which
    holds a weight slice: q/k/v and gate/up column-parallel (heads / ff
    split over ranks), wo and w_down row-parallel with a sum to rejoin the
    residual stream."""
    B, T, D = x.shape
    hd = cfg.head_dim
    tp = axis_size(mesh, tp_axis)
    h = replicate(rms_norm(x, layer["attn_norm"]["scale"]), mesh, tp_axis)
    q = matmul(h, layer["wq"]["kernel"]).reshape(B, T, cfg.n_heads // tp, hd)
    k = matmul(h, layer["wk"]["kernel"]).reshape(B, T, cfg.n_kv_heads // tp, hd)
    v = matmul(h, layer["wv"]["kernel"]).reshape(B, T, cfg.n_kv_heads // tp, hd)
    q = rope(q, cos, sin)
    k = rope(k, cos, sin)
    att = attention(q, k, v, causal=True, impl="plain")
    x = x + psum(matmul(att.reshape(B, T, -1), layer["wo"]["kernel"]), mesh, tp_axis)
    h = replicate(rms_norm(x, layer["ffn_norm"]["scale"]), mesh, tp_axis)
    ffn = matmul(F.silu(matmul(h, layer["w_gate"]["kernel"]))
                 * matmul(h, layer["w_up"]["kernel"]), layer["w_down"]["kernel"])
    return x + psum(ffn, mesh, tp_axis)


def pp_stage_param_specs(stacked_params, *, pp_axis: str = "pp",
                         tp_axis: str | None = None):
    """Spec tuples for pipeline stage weights: leading stage axis on pp;
    with ``tp_axis``, attention/ffn weights additionally split
    Megatron-style (column for wq/wk/wv/w_gate/w_up, row for wo/w_down)."""
    col = {"wq", "wk", "wv", "w_gate", "w_up"}
    row = {"wo", "w_down"}

    def spec(names, leaf):
        if tp_axis:
            if any(n in col for n in names):
                return (pp_axis, *([None] * (leaf.ndim - 2)), tp_axis)
            if any(n in row for n in names):
                return (pp_axis, *([None] * (leaf.ndim - 3)), tp_axis, None)
        return (pp_axis,)

    def walk(node, names):
        if isinstance(node, dict):
            return {k: walk(v, names + (k,)) for k, v in node.items()}
        return spec(names, node)

    return walk(stacked_params, ())


def llama_pp_loss(params, batch, cfg: LlamaConfig, mesh, *, n_microbatches: int,
                  attn_impl: str = "plain", batch_axis: str | None = "dp",
                  tp_axis: str | None = None):
    """Next-token CE through a GPipe pipeline over the mesh's pp axis
    (``parallel/pipeline.py``). With ``tp_axis`` each stage also runs
    Megatron tensor parallelism over that axis — dp x tp x pp in one call.
    Every rank passes the same params and batch and gets the same loss."""
    dense = params["dense"]
    emb = dense["tok"]["embedding"]
    tokens = torch.as_tensor(batch["tokens"], device=emb.device).long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    x = emb[inputs]
    cos, sin = rope_freqs(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, device=emb.device)

    def layers(stage_params):
        per = next(iter(_leaves(stage_params))).shape[0]
        for i in range(per):
            yield _map_tree(lambda p: p[i], stage_params)

    if tp_axis is not None:
        def tp_block(layer, h):
            if cfg.remat and torch.is_grad_enabled():
                return checkpoint(_block_tp, layer, h, cos, sin, cfg, mesh, tp_axis,
                                  use_reentrant=False)
            return _block_tp(layer, h, cos, sin, cfg, mesh, tp_axis)

        def stage_fn(stage_params, h):
            for layer in layers(stage_params):
                h = tp_block(layer, h)
            return h

        param_specs = pp_stage_param_specs(params["stages"], tp_axis=tp_axis)
    else:
        def stage_fn(stage_params, h):
            block = _maybe_remat_block(cfg)
            for layer in layers(stage_params):
                h, _ = block(layer, h, cos, sin, cfg, attn_impl)
            return h

        param_specs = None

    x = pipeline_apply(stage_fn, params["stages"], x, mesh,
                       n_microbatches=n_microbatches, batch_axis=batch_axis,
                       param_specs=param_specs)
    x = rms_norm(x, dense["norm"]["scale"])
    return _ce_loss(matmul(x, dense["lm_head"]["kernel"]), targets)


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


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def make_train_step(cfg: LlamaConfig, optimizer: AdamW, *, mesh=None,
                    attn_impl: str = "auto"):
    """Returns step(params, opt_state, batch) -> (params, opt_state, loss),
    the call shape of the JAX ``make_train_step``; ``opt_state`` is
    ``optimizer.init(params)``. The update is made in place, the
    counterpart of donating params and opt_state: the returned params and
    opt_state are the objects passed in. With a mesh (sp, ep) every rank
    passes the same params and batch and gets whole gradients, so every
    rank makes the same update."""
    _token_axes(mesh, "sp")  # refuses the axes that wait for Queue 1 item 5

    def step(params, opt_state, batch):
        loss = llama_loss(params, batch, cfg, mesh=mesh, attn_impl=attn_impl)
        loss.backward()
        optimizer.update(opt_state)
        return params, opt_state, loss.detach()

    return step
