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
(one process per mesh position) and make the partitioning that JAX's jit
shardings make: batch rows over dp, fsdp and ep (``batch_spec``), the
sequence over ``sp`` (ring attention, rope at global positions), the
experts over ``ep``, and Megatron tensor parallelism over ``tp`` in every
block (each rank's heads through ``attention``, so the flash kernels run
on the local heads). A pp axis there is replicated compute; the pipeline
is ``llama_pp_loss``. Params may be whole tensors or ``shard_pytree``'s
``DTensor`` tree (``PartitionRules.llama()``): each rank then keeps its
shards, gathers an fsdp-sharded weight just before its layer (again in the
remat recompute) and gets its gradient shards back by reduce-scatter.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops.attention import attention, sequence_attention
from ray_tpu_torch.ops.basic import matmul, rms_norm, rope, rope_freqs, swiglu
from ray_tpu_torch.ops.remat import checkpoint_name, save_only_these_names
from ray_tpu_torch.parallel.comm import (
    axis_index,
    axis_size,
    gather,
    gather_sum,
    psum,
    replicate,
    shard,
)
from ray_tpu_torch.parallel.mesh import AXIS_ORDER
from ray_tpu_torch.parallel.moe import moe_ffn_local
from ray_tpu_torch.parallel.pipeline import pipeline_apply, stack_stage_params
from ray_tpu_torch.parallel.sharding import PartitionRules
from ray_tpu_torch.utils.device import resolve_device
from ray_tpu_torch.utils.serialization import is_dtensor


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
    """How a sharded forward splits the work: batch rows over ``rows``
    (dp, fsdp and ep, outermost first, as ``batch_spec`` and the experts'
    exchange split them), the sequence over ``seq`` and the heads and the
    FFN over ``tp`` (Megatron); axes of size 1 are left out."""

    mesh: object
    rows: tuple[str, ...]
    seq: str | None
    tp: str | None

    @property
    def ep(self) -> str | None:
        return "ep" if "ep" in self.rows else None

    @property
    def token_axes(self) -> tuple[str, ...]:
        """The axes whose ranks hold different tokens."""
        return self.rows + ((self.seq,) if self.seq else ())

    @property
    def n_tokens_shards(self) -> int:
        return math.prod(axis_size(self.mesh, ax) for ax in self.token_axes)


def _split_for(mesh, seq_axis, cfg: LlamaConfig) -> _Split | None:
    """The split a forward with ``mesh`` makes, or ``None`` when it splits
    nothing (no mesh, or no axis it splits over is larger than 1): then the
    step is the plain one. A pp axis means replicated compute, as under
    JAX's jit (the pipeline is ``llama_pp_loss``)."""
    if mesh is None:
        return None
    split = _Split(mesh, tuple(ax for ax in ("dp", "fsdp", "ep") if axis_size(mesh, ax) > 1),
                   seq_axis if axis_size(mesh, seq_axis) > 1 else None,
                   "tp" if axis_size(mesh, "tp") > 1 else None)
    if not split.token_axes and split.tp is None:
        return None
    tp = axis_size(mesh, split.tp)
    dense = cfg.n_layers > sum(_is_moe_layer(cfg, i) for i in range(cfg.n_layers))
    for what, n in (("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads),
                    ("d_ff", cfg.d_ff if dense else 0)):
        if n % tp:
            raise ValueError(f"tensor parallelism over {tp} ranks needs {what} % {tp} == 0; "
                             f"the config has {what}={n} ({cfg})")
    return split


# Megatron's layout of the computation under tp: q/k/v and gate/up split by
# columns, wo and w_down by rows; experts over ep. Everything else is
# computed whole (the embedding, lm_head, norms and the router), and a
# weight stored sharded otherwise is gathered before use.
_COMPUTE = PartitionRules([
    (r"moe/(w_up|w_down)/kernel$", ("ep",)),
    (r"(wq|wk|wv|w_gate|w_up)/kernel$", (None, "tp")),
    (r"(wo|w_down)/kernel$", ("tp", None)),
])


def _stored(t, mesh) -> tuple:
    """How a param leaf is stored, as (axis, dim) pairs: () for a whole
    tensor; a ``DTensor`` (from ``shard_pytree``) must sit on ``mesh``."""
    if not is_dtensor(t):
        return ()
    if mesh is None:
        raise ValueError("shard_pytree params need the mesh they were placed on (mesh=...)")
    return _placement_dims(t.device_mesh, tuple(t.placements), t.shape, mesh)


@functools.lru_cache(maxsize=4096)
def _placement_dims(dmesh, placements: tuple, shape, mesh) -> tuple:
    """(axis, dim) for each axis a ``DTensor`` on ``dmesh`` is sharded over
    (worked out once per placement, shape and mesh: every step passes the
    same ones)."""
    if (dmesh.mesh_dim_names != mesh.mesh_dim_names
            or tuple(dmesh.shape) != tuple(mesh.shape)):
        raise ValueError("DTensor params must be placed on the step's mesh")
    stored = []
    for name, p in zip(mesh.mesh_dim_names, placements):
        if p.is_shard():
            if shape[p.dim] % axis_size(mesh, name):
                raise ValueError(f"dim {p.dim} of a {tuple(shape)} weight does not split "
                                 f"evenly over axis {name!r}")
            stored.append((name, p.dim))
        elif not p.is_replicate():
            raise ValueError(f"unsupported placement {p}")
    return tuple(stored)


@functools.lru_cache(maxsize=4096)
def _leaf_steps(path: str, ndim: int, stored: tuple, split: _Split) -> tuple:
    """The collectives, in order, that turn this rank's stored piece of the
    leaf at ``path`` (sharded as ``stored``, (axis, dim) pairs) into the
    tensor it computes with (sharded as ``_COMPUTE`` says). Autograd
    returns the gradient of the stored piece: summed over the token axes
    the piece is replicated on, reduce-scattered over a token axis it was
    gathered from (fsdp), chunked over another (tp) and gathered over an
    axis it was sliced for. Worked out once per leaf and split."""
    stored = dict(stored)
    want = {ax: d for d, ax in enumerate(_COMPUTE.spec_for(path, ndim)) if ax}
    mesh = split.mesh
    steps = [functools.partial(replicate, mesh=mesh, name=ax) for ax in split.token_axes
             if ax not in stored and ax not in want]
    for ax in reversed(AXIS_ORDER):  # inner axes first, for two axes on one dim
        if ax in stored and want.get(ax) != stored[ax]:
            steps.append(functools.partial(gather_sum if ax in split.token_axes else gather,
                                           dim=stored[ax], mesh=mesh, name=ax))
    for ax in AXIS_ORDER:
        if ax in want and stored.get(ax) != want[ax]:
            steps.append(functools.partial(shard, dim=want[ax], mesh=mesh, name=ax))
    return tuple(steps)


def _unwrap(params, mesh, split: _Split | None, prefix: str = ""):
    """(this rank's tensors, per leaf the ``_leaf_steps`` that make the
    tensor it computes with; ``None`` without ``split``) for ``params``:
    whole tensors as they are, a ``DTensor`` as its local shard
    (``_shard_leaf``), which gets the gradient."""
    if isinstance(params, dict):
        pairs = {k: _unwrap(v, mesh, split, f"{prefix}/{k}") for k, v in params.items()}
        return ({k: v[0] for k, v in pairs.items()},
                None if split is None else {k: v[1] for k, v in pairs.items()})
    stored = _stored(params, mesh)
    steps = None if split is None else _leaf_steps(prefix, params.ndim, stored, split)
    return _shard_leaf(params), steps


def _apply(tree, steps):
    """``tree`` with each leaf passed through its ``steps``."""
    if isinstance(tree, dict):
        return {k: _apply(v, steps[k]) for k, v in tree.items()}
    for step in steps:
        tree = step(tree)
    return tree


def _block(layer, x, cos, sin, cfg: LlamaConfig, attn_impl, split: _Split | None = None,
           steps=None):
    """One decoder block on this rank's tokens. With ``steps``, ``layer``
    holds the stored pieces, gathered or sliced here by their
    ``_leaf_steps``, inside the remat region, so the recompute gathers
    again; without, ``layer`` holds what this rank computes with (under tp,
    its Megatron slices)."""
    if steps is not None:
        layer = _apply(layer, steps)
    mesh, tp = (split.mesh, split.tp) if split is not None else (None, None)
    n_tp = axis_size(mesh, tp)
    B, T, D = x.shape
    hd = cfg.head_dim
    # Megatron: the normed input is replicated over tp (its gradient summed)
    # and each rank's heads and FFN columns give partial sums, psum'd back
    h = replicate(rms_norm(x, layer["attn_norm"]["scale"]), mesh, tp)
    q = matmul(h, layer["wq"]["kernel"]).reshape(B, T, cfg.n_heads // n_tp, hd)
    k = matmul(h, layer["wk"]["kernel"]).reshape(B, T, cfg.n_kv_heads // n_tp, hd)
    v = matmul(h, layer["wv"]["kernel"]).reshape(B, T, cfg.n_kv_heads // n_tp, hd)
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
    x = x + psum(matmul(att.reshape(B, T, -1), layer["wo"]["kernel"]), mesh, tp)
    h = rms_norm(x, layer["ffn_norm"]["scale"])
    if "moe" not in layer:
        return x + psum(swiglu(replicate(h, mesh, tp), layer["w_gate"]["kernel"],
                               layer["w_up"]["kernel"], layer["w_down"]["kernel"]),
                        mesh, tp), 0.0
    # the experts run whole on every tp rank, on the same tokens
    moe = layer["moe"]
    split = split or _Split(None, (), None, None)
    n = B * T * split.n_tokens_shards  # the capacity of the whole batch
    out, aux = moe_ffn_local(h, moe["gate"]["kernel"], moe["w_up"]["kernel"],
                             moe["w_down"]["kernel"],
                             capacity=max(1, int(cfg.capacity_factor * n / cfg.n_experts)),
                             mesh=split.mesh, ep_axis=split.ep, seq_axis=split.seq,
                             row_axes=tuple(ax for ax in split.rows if ax != "ep"))
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
    for ax in split.rows:
        tokens = shard(tokens, 0, split.mesh, ax)
    return shard(tokens, 1, split.mesh, split.seq)


def _forward(params, tokens, cfg: LlamaConfig, mesh, split: _Split | None, attn_impl):
    """(logits of this rank's tokens, the aux loss summed over layers)."""
    emb = params["tok"]["embedding"]
    tokens = torch.as_tensor(tokens, device=emb.device).long()
    cos, sin = rope_freqs(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                          device=emb.device)
    params, steps = _unwrap(params, mesh, split)
    if split is not None:
        tokens = _local_tokens(tokens, split)
        start = axis_index(split.mesh, split.seq) * tokens.shape[1]  # rope at global positions
        cos, sin = cos[start:], sin[start:]
        top = _apply({k: params[k] for k in ("tok", "norm", "lm_head")}, steps)
    else:
        top = params
    x = top["tok"]["embedding"][tokens]
    aux_total = 0.0
    block = _maybe_remat_block(cfg)
    for i in range(cfg.n_layers):
        name = f"layers_{i}"
        x, aux = block(params[name], x, cos, sin, cfg, attn_impl, split,
                       steps and steps[name])
        aux_total = aux_total + aux
    x = rms_norm(x, top["norm"]["scale"])
    return matmul(x, top["lm_head"]["kernel"]), aux_total


def llama_forward(params, tokens, cfg: LlamaConfig, *, mesh=None,
                  attn_impl: str = "auto", seq_axis: str | None = "sp"):
    """tokens: [B, T] integer -> (logits [B, T, V], aux loss; 0.0 with no
    MoE layer).

    Runs on the device of ``params``; ``tokens`` are moved there. With a
    mesh, every rank passes the same tokens and gets the whole logits; it
    works on its share: batch rows over dp, fsdp and ep (experts over ep),
    the sequence over ``seq_axis``, heads and FFN columns over tp. The
    params are whole tensors, the same on every rank, or the ``DTensor``
    tree of ``shard_pytree(params, PartitionRules.llama(), mesh)``, whose
    fsdp-sharded weights are gathered just before use."""
    split = _split_for(mesh, seq_axis, cfg)
    logits, aux = _forward(params, tokens, cfg, mesh, split, attn_impl)
    if split is not None:
        logits = gather(logits, 1, mesh, split.seq)
        for ax in reversed(split.rows):
            logits = gather(logits, 0, mesh, ax)
    return logits, aux


def llama_loss(params, batch, cfg: LlamaConfig, *, mesh=None, attn_impl="auto"):
    """Next-token cross entropy; batch: {"tokens": [B, T+1]}. With a mesh,
    the NLL is summed over every token-splitting axis and divided by the
    global token count."""
    tokens = torch.as_tensor(batch["tokens"], device=params["tok"]["embedding"].device)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    split = _split_for(mesh, "sp", cfg)
    logits, aux = _forward(params, inputs, cfg, mesh, split, attn_impl)
    if split is None:
        return _ce_loss(logits, targets) + 0.01 * aux
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, _local_tokens(targets, split)[..., None].long()).sum()
    for ax in split.token_axes:
        nll = psum(nll, mesh, ax)
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

    # with tp, each stage holds its Megatron slices (``param_specs``) and
    # runs plain attention on its heads, as JAX's pipeline does
    split = None if tp_axis is None else _Split(mesh, (), None, tp_axis)
    impl = attn_impl if tp_axis is None else "plain"

    def stage_fn(stage_params, h):
        block = _maybe_remat_block(cfg)
        for layer in layers(stage_params):
            h, _ = block(layer, h, cos, sin, cfg, impl, split)
        return h

    param_specs = (None if tp_axis is None
                   else pp_stage_param_specs(params["stages"], tp_axis=tp_axis))

    x = pipeline_apply(stage_fn, params["stages"], x, mesh,
                       n_microbatches=n_microbatches, batch_axis=batch_axis,
                       param_specs=param_specs)
    x = rms_norm(x, dense["norm"]["scale"])
    return _ce_loss(matmul(x, dense["lm_head"]["kernel"]), targets)


# --------------------------------------------- stages of a process pipeline
def llama_stage_params(params: dict, cfg: LlamaConfig, stage: int, n_stages: int) -> dict:
    """Stage ``stage``'s part of a ``llama_init`` tree when ``n_stages``
    processes each run an equal run of layers (a compiled graph's stages,
    ``ray_tpu_torch.dag``): the first stage adds the embedding, the last
    the final norm and the head. The tensors are the tree's own."""
    _check_pp(cfg, n_stages)
    per = cfg.n_layers // n_stages
    part = {f"layers_{i}": params[f"layers_{i}"] for i in range(stage * per, (stage + 1) * per)}
    if stage == 0:
        part["tok"] = params["tok"]
    if stage == n_stages - 1:
        part["norm"], part["lm_head"] = params["norm"], params["lm_head"]
    return part


def llama_stage_forward(stage_params: dict, x, cfg: LlamaConfig, *, attn_impl: str = "auto",
                        last_only: bool = False):
    """``llama_forward`` over one stage's part (``llama_stage_params``):
    ``x`` is the tokens [B, T] when the part holds the embedding, else the
    previous stage's hidden state [B, T, D]. Returns the hidden state, or
    the logits when the part ends the model: [B, T, V], or [B, 1, V] at the
    last position with ``last_only`` (the norm is per position, so these
    equal the whole logits' last row). Rope runs at positions 0..T-1, as in
    ``llama_forward``. Dense layers only."""
    if cfg.n_experts:
        raise ValueError("a llama stage requires dense layers (n_experts=0)")
    layers = sorted((int(k.split("_")[1]) for k in stage_params if k.startswith("layers_")))
    some = next(iter(stage_params[f"layers_{layers[0]}"]["wq"].values()))
    if "tok" in stage_params:
        x = stage_params["tok"]["embedding"][torch.as_tensor(x, device=some.device).long()]
    cos, sin = rope_freqs(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, device=some.device)
    for i in layers:
        x, _ = _block(stage_params[f"layers_{i}"], x, cos, sin, cfg, attn_impl)
    if "lm_head" not in stage_params:
        return x
    if last_only:
        x = x[:, -1:]
    return matmul(rms_norm(x, stage_params["norm"]["scale"]), stage_params["lm_head"]["kernel"])


def _shard_leaf(t):
    """The tensor autograd and the optimizer see for a param: a ``DTensor``'s
    local shard itself (its storage, so in-place updates show in the
    ``DTensor``), any other tensor as it is. Updating the shards as plain
    tensors keeps ``DTensor``'s per-op sharding propagation, which is slow
    over a six-axis mesh, out of the optimizer step."""
    return t._local_tensor if is_dtensor(t) else t


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
        leaf tensors that require grad and are updated in place (for a
        ``DTensor``, its local shard)."""
        leaves = [_shard_leaf(t) for t in _leaves(params)]
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
    opt_state are the objects passed in. With a mesh every rank passes
    the same batch and the same params: whole tensors (each rank gets whole
    gradients and makes the same update) or ``shard_pytree``'s DTensors
    (each rank updates its local shards)."""
    _split_for(mesh, "sp", cfg)  # a config that does not split over tp raises here

    def step(params, opt_state, batch):
        loss = llama_loss(params, batch, cfg, mesh=mesh, attn_impl=attn_impl)
        loss.backward()
        optimizer.update(opt_state)
        return params, opt_state, loss.detach()

    return step
