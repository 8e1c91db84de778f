"""Selective rematerialisation: names on tensors and a policy that saves them.

Counterpart of ``jax.ad_checkpoint.checkpoint_name`` and
``jax.checkpoint_policies.save_only_these_names``, on PyTorch's selective
activation checkpointing (``torch.utils.checkpoint`` with ``context_fn``).

``checkpoint_name(x, name)`` is an identity custom op. A custom op may not
return its input, so under autograd it returns a copy (its cost is in
PERF.md); with grad disabled nothing can be saved and it returns ``x``.
The policy saves the outputs of ``checkpoint_name`` ops with the chosen
names and of the flash forward op (JAX names the flash residuals
``"attn_out"`` inside its ``custom_vjp``), and recomputes everything else.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from ray_tpu_torch.ops.flash_attention import FLASH_FWD_OP


@torch.library.custom_op("ray_tpu_torch::checkpoint_name", mutates_args=())
def _name_op(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


_name_op.register_autograd(lambda ctx, grad: (grad, None),
                           setup_context=lambda ctx, inputs, output: None)

NAME_OP = torch.ops.ray_tpu_torch.checkpoint_name.default


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` under ``name``, for a remat policy to save."""
    if not torch.is_grad_enabled():
        return x
    return _name_op(x, name)


def save_only_these_names(*names: str):
    """A ``context_fn`` for ``torch.utils.checkpoint.checkpoint``: saves the
    named tensors and the flash forward's outputs, recomputes the rest."""
    keep = frozenset(names)

    def policy(ctx, op, *args, **kwargs):
        if op is FLASH_FWD_OP or (op is NAME_OP and args[1] in keep):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)
