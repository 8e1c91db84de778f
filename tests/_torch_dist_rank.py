"""One rank of a gloo world that runs the port's parallel layer for the tests.

    RANK=r WORLD_SIZE=n python tests/_torch_dist_rank.py <dir>

Not a test module (pytest does not collect it) and it imports only torch,
numpy and ray_tpu_torch. It joins the group through the file ``<dir>/rdzv``,
reads the cases from ``<dir>/cases.json`` and their inputs from
``<dir>/inputs.npz`` (keys ``"<case>/<name>"``), runs every case in order,
and writes ``<dir>/out_<rank>.npz`` (same key scheme) and
``<dir>/errors_<rank>.json`` (case -> traceback). Every rank runs every case,
so the collectives line up; ``tests/test_torch_parallel.py`` compares each
rank's outputs with the JAX package's.
"""
import faulthandler
import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.ops.attention import attention  # noqa: E402
from ray_tpu_torch.parallel.mesh import MeshSpec  # noqa: E402
from ray_tpu_torch.parallel.moe import moe_ffn  # noqa: E402
from ray_tpu_torch.parallel.pipeline import pipeline_apply  # noqa: E402
from ray_tpu_torch.parallel.ring_attention import ring_attention  # noqa: E402
from ray_tpu_torch.parallel.sharding import PartitionRules, shard_pytree  # noqa: E402
from ray_tpu_torch.parallel.ulysses import ulysses_attention  # noqa: E402


def unflatten(arrays: dict, prefix: str) -> dict:
    """{"<prefix>/a/b": arr} -> {"a": {"b": arr}}."""
    tree: dict = {}
    for key, arr in arrays.items():
        if not key.startswith(prefix + "/"):
            continue
        node, parts = tree, key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def flatten(tree, prefix: str = "") -> dict:
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def _grads(loss, named: dict) -> dict:
    got = torch.autograd.grad(loss, list(named.values()))
    return {f"grad/{k}": g for k, g in zip(named, got)}


def case_attention(inp, mesh, kw):
    q, k, v = (torch.tensor(inp[n], requires_grad=True) for n in ("q", "k", "v"))
    entry = kw["entry"]
    if entry == "ring_attention":
        out = ring_attention(q, k, v, mesh, causal=kw["causal"])
    elif entry == "ulysses_attention":
        out = ulysses_attention(q, k, v, mesh, causal=kw["causal"])
    else:
        out = attention(q, k, v, causal=kw["causal"], mesh=mesh, seq_axis="sp",
                        impl=kw["impl"])
    loss = (out * torch.tensor(inp["w"])).sum()
    return {"out": out, **_grads(loss, {"q": q, "k": k, "v": v})}


def case_pipeline(inp, mesh, kw):
    stacked = {"w": torch.tensor(inp["w"], requires_grad=True),
               "b": torch.tensor(inp["b"], requires_grad=True)}
    x = torch.tensor(inp["x"], requires_grad=True)

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    out = pipeline_apply(stage_fn, stacked, x, mesh, n_microbatches=kw["M"],
                         batch_axis=kw.get("batch_axis"))
    loss = (out ** 2).sum()
    return {"out": out, **_grads(loss, {"w": stacked["w"], "b": stacked["b"], "x": x})}


def case_moe(inp, mesh, kw):
    named = {n: torch.tensor(inp[n], requires_grad=True) for n in ("x", "gate", "w_up", "w_down")}
    out, aux = moe_ffn(*named.values(), capacity_factor=kw["cf"], mesh=mesh)
    loss = (out * torch.tensor(inp["w"])).sum() + aux
    return {"out": out, "aux": aux, **_grads(loss, named)}


def _cfg(kw):
    return tllama.LlamaConfig(**kw["cfg"])


def case_pp_loss(inp, mesh, kw):
    cfg = _cfg(kw)
    flat = tllama.params_from_numpy(unflatten(inp, "p"), cfg, device="cpu")
    params = tllama.stack_pp_params(flat, cfg, kw["stages"])
    leaves = flatten(params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = tllama.llama_pp_loss(params, {"tokens": torch.tensor(inp["tokens"])}, cfg, mesh,
                                n_microbatches=kw["M"], tp_axis=kw.get("tp_axis"))
    got = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    out = {"loss": loss}
    per = cfg.n_layers // kw["stages"]
    for key, g in got.items():  # back to the flat llama_init layout
        part, rest = key.split("/", 1)
        if part == "dense":
            out[f"grad/{rest}"] = g
        else:
            for i in range(cfg.n_layers):
                out[f"grad/layers_{i}/{rest}"] = g[i // per, i % per]
    return out


def case_llama(inp, mesh, kw):
    """MoE llama_forward, llama_loss and its gradients, then one
    make_train_step step, all with the mesh."""
    cfg = _cfg(kw)
    params = tllama.params_from_numpy(unflatten(inp, "p"), cfg, device="cpu")
    tokens = torch.tensor(inp["tokens"])
    with torch.no_grad():
        logits, aux = tllama.llama_forward(params, tokens[:, :-1], cfg, mesh=mesh)
    leaves = flatten(params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = tllama.llama_loss(params, {"tokens": tokens}, cfg, mesh=mesh)
    out = {"logits": logits, "aux": aux, "loss": loss, **_grads(loss, leaves)}
    opt = tllama.AdamW(**kw["hyper"])
    step = tllama.make_train_step(cfg, opt, mesh=mesh)
    params, _, step_loss = step(params, opt.init(params), {"tokens": tokens})
    out["step_loss"] = step_loss
    out.update({f"step/{k}": v for k, v in flatten(params).items()})
    return out


def case_mesh(inp, mesh, kw):
    out = {"shape": np.array(mesh.shape),
           "coord": np.array([mesh.get_local_rank(n) for n in mesh.mesh_dim_names])}
    try:
        MeshSpec(dp=2 * dist.get_world_size()).build("cpu")
    except ValueError as e:
        out["too_big"] = np.array(str(e))
    rules = PartitionRules.llama()
    tree = {"wq": {"kernel": torch.tensor(inp["wq"])}, "norm": {"scale": torch.ones(8)}}
    sharded = shard_pytree(tree, rules, mesh)
    leaf = sharded["wq"]["kernel"]
    out["wq_local"] = leaf.to_local()
    out["wq_full"] = leaf.full_tensor()
    out["wq_placements"] = np.array([str(p) for p in leaf.placements])
    out["norm_placements"] = np.array([str(p) for p in sharded["norm"]["scale"].placements])
    return out


def case_pp_forward(inp, mesh, kw):
    """llama_forward with a pp axis: replicated compute, as under JAX's jit."""
    cfg = _cfg(kw)
    params = tllama.params_from_numpy(unflatten(inp, "p"), cfg, device="cpu")
    with torch.no_grad():
        logits, aux = tllama.llama_forward(params, torch.tensor(inp["tokens"]), cfg, mesh=mesh)
    return {"logits": logits, "aux": aux}


def case_step(inp, mesh, kw):
    """llama_forward with the mesh (with ``forward``) and one make_train_step
    step (with ``step``), from whole params or (with ``dtensor``) from
    shard_pytree's DTensors."""
    from torch.distributed.tensor import DTensor

    cfg = _cfg(kw)
    params = tllama.params_from_numpy(unflatten(inp, "p"), cfg, device="cpu")
    tokens = torch.tensor(inp["tokens"])
    if kw["dtensor"]:
        params = shard_pytree(params, PartitionRules.llama(), mesh)
    out = {}
    if kw["forward"]:
        with torch.no_grad():
            out["logits"], out["aux"] = tllama.llama_forward(params, tokens[:, :-1], cfg,
                                                             mesh=mesh)
    if not kw["step"]:
        return out
    opt = tllama.AdamW(**kw["hyper"])
    step = tllama.make_train_step(cfg, opt, mesh=mesh)
    params, _, out["loss"] = step(params, opt.init(params), {"tokens": tokens})
    for key, leaf in flatten(params).items():
        if kw["dtensor"] != isinstance(leaf, DTensor):
            raise AssertionError(f"{key} came back as {type(leaf).__name__}")
        out[f"step/{key}"] = leaf.full_tensor() if kw["dtensor"] else leaf
    return out


CASES = {"attention": case_attention, "pipeline": case_pipeline, "moe": case_moe,
         "pp_loss": case_pp_loss, "llama": case_llama, "mesh": case_mesh,
         "pp_forward": case_pp_forward, "step": case_step}


def main() -> int:
    work = sys.argv[1]
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    faulthandler.dump_traceback_later(80, exit=True)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work}/rdzv", rank=rank,
                            world_size=world)
    with open(os.path.join(work, "cases.json")) as f:
        cases = json.load(f)
    with np.load(os.path.join(work, "inputs.npz")) as npz:
        arrays = dict(npz)
    outputs, errors = {}, {}
    for case in cases:
        name = case["name"]
        inp = {k[len(name) + 1:]: v for k, v in arrays.items() if k.startswith(name + "/")}
        try:
            mesh = MeshSpec(**case["mesh"]).build("cpu")
            for key, val in CASES[case["fn"]](inp, mesh, case.get("kw", {})).items():
                if isinstance(val, torch.Tensor):
                    val = val.detach().numpy()
                outputs[f"{name}/{key}"] = np.asarray(val)
        except Exception:  # reported per case; the other ranks raise alike
            errors[name] = traceback.format_exc()
    np.savez(os.path.join(work, f"out_{rank}.npz"), **outputs)
    with open(os.path.join(work, f"errors_{rank}.json"), "w") as f:
        json.dump(errors, f)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
