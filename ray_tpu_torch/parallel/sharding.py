"""Partition-spec recipes: map pytree paths to mesh axes.

Counterpart of ``ray_tpu/parallel/sharding.py``, with the same rules table.
A spec is a per-dimension tuple whose entries are a mesh axis name, ``None``
or a tuple of axis names (JAX's ``PartitionSpec`` as a plain tuple);
``shard_pytree`` turns each into ``DTensor`` placements over a
``DeviceMesh`` (``MeshSpec.build``).
"""
from __future__ import annotations

import re

from ray_tpu_torch.parallel.mesh import MeshSpec


class PartitionRules:
    def __init__(self, rules: list[tuple[str, tuple]]):
        """rules: [(path_regex, spec_tuple)] — first match wins; spec axis
        entries are mesh axis names, None, or tuples of axis names."""
        self._rules = [(re.compile(pat), spec) for pat, spec in rules]

    def spec_for(self, path: str, ndim: int) -> tuple:
        for pat, spec in self._rules:
            if pat.search(path):
                # unmentioned trailing dims replicate; ("fsdp",) is "fsdp", as in JAX
                return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                             for e in tuple(spec)[:ndim])
        return ()  # replicated by default

    @classmethod
    def data_parallel(cls) -> "PartitionRules":
        return cls([])  # params replicated; batch sharded on dp at the step

    @classmethod
    def fsdp(cls) -> "PartitionRules":
        """ZeRO-equivalent: shard the largest axis of every weight on fsdp."""
        return cls([(r"(kernel|embedding|scale|w[0-9]?)$", ("fsdp",))])

    @classmethod
    def llama(cls) -> "PartitionRules":
        """2D TP x FSDP sharding for transformer blocks (Megatron-style
        column/row split expressed as specs)."""
        return cls(
            [
                # MoE expert weights: expert axis on ep, then row/col TP
                # (must precede the generic w_up/w_down rules below)
                (r"moe/gate/kernel$", ("fsdp",)),            # [d, E]
                (r"moe/w_up/kernel$", ("ep", "fsdp", "tp")),   # [E, d, ff]
                (r"moe/w_down/kernel$", ("ep", "tp", "fsdp")),  # [E, ff, d]
                (r"embedding$", (("fsdp",), "tp")),          # [vocab, d] -> vocab on fsdp, d on tp
                (r"(wq|wk|wv|w_gate|w_up)/kernel$", ("fsdp", "tp")),   # column parallel
                (r"(wo|w_down)/kernel$", ("tp", "fsdp")),    # row parallel
                (r"lm_head/kernel$", ("fsdp", "tp")),
                (r"(norm|ln|rms)", ()),                      # replicated norms
            ]
        )


def _map_with_path(fn, tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def specs_for_pytree(tree, rules: PartitionRules):
    """A spec tree matching ``tree``'s (nested dict) structure."""
    return _map_with_path(lambda path, leaf: rules.spec_for(path, getattr(leaf, "ndim", 0)),
                          tree)


def placements(spec: tuple, mesh) -> list:
    """``DTensor`` placements of ``spec`` on ``mesh``: ``Shard(i)`` on every
    mesh axis named by entry i, ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, entry in enumerate(spec)
                if entry == name or (isinstance(entry, tuple) and name in entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def shard_pytree(tree, rules: PartitionRules, mesh):
    """``distribute_tensor`` every leaf with its rule's placements."""
    from torch.distributed.tensor import distribute_tensor

    specs = specs_for_pytree(tree, rules)

    def put(path, leaf):
        node = specs
        for key in path.split("/"):
            node = node[key]
        return distribute_tensor(leaf, mesh, placements(node, mesh))

    return _map_with_path(put, tree)


def batch_spec(mesh_spec: MeshSpec) -> tuple:
    """Canonical input-batch sharding: batch over (dp, fsdp), sequence over sp."""
    return (("dp", "fsdp"), "sp")
