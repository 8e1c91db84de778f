"""The port's parallel layer against the JAX package's, on the CPU.

JAX runs in the pytest process on the conftest's 8-device CPU mesh (4-device
meshes here). The port runs in a world of 4 fresh interpreters
(``tests/_torch_dist_rank.py``) on a gloo group with file rendezvous: the
pytest process never starts a process group, never forks, and binds no
port. All cases share one launch, made by the first worker to need it and
read by the others (a lock in the session's shared temp directory); the
parent kills every rank when one fails or the 90 s clock runs out.

Tolerances are JAX's own (``tests/test_parallel.py``): outputs 2e-5,
gradients 2e-4, losses rtol 1e-5; the Llama logits 1e-4 and one AdamW step
1e-4 (``tests/test_torch_train.py``). Every rank must return the global
result."""

import fcntl
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.ops.attention import attention as jattention
from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec
from ray_tpu.parallel.moe import moe_ffn as jmoe_ffn
from ray_tpu.parallel.pipeline import pipeline_apply as jpipeline_apply
from ray_tpu.parallel.ring_attention import ring_attention as jring_attention
from ray_tpu.parallel.ulysses import ulysses_attention as julysses_attention
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import sharding as tsharding

from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse

# slowest test 3.4 s, module set-up 60.9 s (the port's modules alone under -n 6);
# the limits are several times that, so one that fires names a stalled test
_module_limit, _test_limit = time_limits(module_s=600, test_s=60)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPER = os.path.join(ROOT, "tests", "_torch_dist_rank.py")
WORLD = 4
LAUNCH_TIMEOUT = 90.0
# AdamW's first step moves a weight by lr * g / (|g| + eps): with eps 1e-8 a
# gradient of ~1e-9, whose sharded sum differs from JAX's in its last bits,
# moves by anything up to lr. eps 1e-6 bounds that sensitivity at lr / eps =
# 1e4 per unit of gradient, 1e-5 for a 1e-9 difference, under the 1e-4 bound.
HYPER = dict(learning_rate=1e-2, b1=0.9, b2=0.99, eps=1e-6, weight_decay=1e-2)
PP_CFG = dict(vocab_size=128, d_model=32, n_layers=4, n_heads=4, n_kv_heads=4, d_ff=64,
              max_seq_len=64, dtype="float32")


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _jmesh(**axes):
    return JMeshSpec(**axes).build(jax.devices()[:WORLD])


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
    return out


# ------------------------------------------------------------ the cases
# each returns (inputs, expected): dicts of numpy arrays

def _attention_case(seed, mesh, entry, causal=True, impl="auto", B=2, T=32, H=4, Hkv=None,
                    D=8):
    rng = _rng(seed)
    q = _f32(rng, B, T, H, D)
    k, v = _f32(rng, B, T, Hkv or H, D), _f32(rng, B, T, Hkv or H, D)
    w = _f32(rng, B, T, H, D)
    jm = _jmesh(**mesh)

    def fn(q, k, v):
        if entry == "ring_attention":
            return jring_attention(q, k, v, jm, causal=causal)
        if entry == "ulysses_attention":
            return julysses_attention(q, k, v, jm, causal=causal)
        return jattention(q, k, v, causal=causal, mesh=jm, seq_axis="sp", impl=impl)

    out = jax.jit(fn)(q, k, v)
    grads = jax.jit(jax.grad(lambda *a: (fn(*a) * w).sum(), argnums=(0, 1, 2)))(q, k, v)
    return ({"q": q, "k": k, "v": v, "w": w},
            {"out": out, **{f"grad/{n}": g for n, g in zip("qkv", grads)}})


def _pipeline_case(seed, mesh, M, batch_axis=None, B=16, d=8):
    rng = _rng(seed)
    n = mesh["pp"]
    w, b, x = _f32(rng, n, d, d, scale=0.3), _f32(rng, n, d, scale=0.1), _f32(rng, B, d)
    jm = _jmesh(**mesh)

    def stage_fn(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    def fn(w, b, x):
        return jpipeline_apply(stage_fn, {"w": w, "b": b}, x, jm, n_microbatches=M,
                               batch_axis=batch_axis)

    out = jax.jit(fn)(w, b, x)
    grads = jax.jit(jax.grad(lambda *a: (fn(*a) ** 2).sum(), argnums=(0, 1, 2)))(w, b, x)
    return ({"w": w, "b": b, "x": x},
            {"out": out, **{f"grad/{n}": g for n, g in zip("wbx", grads)}})


def _moe_case(seed, cf, B=2, T=8, D=16, E=4, F=32):
    rng = _rng(seed)
    inp = {"x": _f32(rng, B, T, D), "gate": _f32(rng, D, E, scale=0.1),
           "w_up": _f32(rng, E, D, F, scale=0.1), "w_down": _f32(rng, E, F, D, scale=0.1),
           "w": _f32(rng, B, T, D)}

    def loss(x, g, u, d):
        out, aux = jmoe_ffn(x, g, u, d, capacity_factor=cf)
        return (out * inp["w"]).sum() + aux

    args = [inp[n] for n in ("x", "gate", "w_up", "w_down")]
    out, aux = jax.jit(lambda *a: jmoe_ffn(*a, capacity_factor=cf))(*args)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*args)
    return inp, {"out": out, "aux": aux,
                 **{f"grad/{n}": g for n, g in zip(("x", "gate", "w_up", "w_down"), grads)}}


def _pp_case(seed, remat):
    cfg = jllama.LlamaConfig(**PP_CFG, remat=remat)
    params = jllama.llama_init(jax.random.PRNGKey(0), cfg)
    tokens = _rng(seed).integers(0, cfg.vocab_size, (8, 17)).astype(np.int32)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jllama.llama_loss(p, b, cfg, attn_impl="plain")))(
        params, {"tokens": jnp.asarray(tokens)})
    inputs = {"tokens": tokens, **{f"p/{k}": v for k, v in _flat(params).items()}}
    return inputs, {"loss": loss, **{f"grad/{k}": v for k, v in _flat(grads).items()}}


def _llama_case(seed, cfg, B=2):
    params = jllama.llama_init(jax.random.PRNGKey(1), cfg)
    tokens = _rng(seed).integers(0, cfg.vocab_size, (B, 33)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    logits, aux = jax.jit(lambda p, t: jllama.llama_forward(p, t, cfg))(
        params, batch["tokens"][:, :-1])
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: jllama.llama_loss(p, b, cfg)))(
        params, batch)
    opt = optax.adamw(**HYPER)
    step = jllama.make_train_step(cfg, opt, donate=False)
    stepped, _, step_loss = step(params, opt.init(params), batch)
    inputs = {"tokens": tokens, **{f"p/{k}": v for k, v in _flat(params).items()}}
    return inputs, {"logits": logits, "aux": aux, "loss": loss, "step_loss": step_loss,
                    **{f"grad/{k}": v for k, v in _flat(grads).items()},
                    **{f"step/{k}": v for k, v in _flat(stepped).items()}}


def _sharded_step_case(seed, cfg, mesh, B, forward, step):
    """JAX's jitted train step with the dryrun's shardings (with ``step``):
    params placed by ``specs_for_pytree(params, PartitionRules.llama())``,
    batch rows on (dp, fsdp); and (with ``forward``) the forward's logits
    and aux."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ray_tpu.parallel.sharding import PartitionRules as JRules, specs_for_pytree

    params = jllama.llama_init(jax.random.PRNGKey(1), cfg)
    tokens = _rng(seed).integers(0, cfg.vocab_size, (B, 33)).astype(np.int32)
    jm = _jmesh(**mesh)
    opt = optax.adamw(**HYPER)
    param_sh = jax.tree.map(lambda sp: NamedSharding(jm, sp),
                            specs_for_pytree(params, JRules.llama()))
    batch_sh = NamedSharding(jm, P(("dp", "fsdp")))

    def train_step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(
            lambda p: jllama.llama_loss(p, batch, cfg, mesh=jm, attn_impl="auto"))(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    expected = {}
    if step:
        jstep = jax.jit(train_step, in_shardings=(param_sh, None, batch_sh),
                        out_shardings=(param_sh, None, NamedSharding(jm, P())))
        placed = jax.device_put(params, param_sh)
        stepped, _, loss = jstep(placed, opt.init(placed),
                                 {"tokens": jax.device_put(jnp.asarray(tokens), batch_sh)})
        expected = {"loss": loss, **{f"step/{k}": v for k, v in _flat(stepped).items()}}
    if forward:
        expected["logits"], expected["aux"] = jax.jit(
            lambda p, t: jllama.llama_forward(p, t, cfg))(params, tokens[:, :-1])
    return {"tokens": tokens, **{f"p/{k}": v for k, v in _flat(params).items()}}, expected


def _pp_forward_case(seed, cfg):
    params = jllama.llama_init(jax.random.PRNGKey(2), cfg)
    tokens = _rng(seed).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    logits, aux = jax.jit(lambda p, t: jllama.llama_forward(p, t, cfg))(params, tokens)
    return ({"tokens": tokens, **{f"p/{k}": v for k, v in _flat(params).items()}},
            {"logits": logits, "aux": aux})


def _cfg_kw(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


MOE_CFG = jllama.LlamaConfig.tiny(n_experts=4)
MOE_DROPS_CFG = jllama.LlamaConfig.tiny(n_experts=4, capacity_factor=0.5)
DENSE_CFG = jllama.LlamaConfig.tiny()
# four kv heads, so that tp=4 splits them
TP4_CFG = jllama.LlamaConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4,
                             d_ff=128, max_seq_len=128, dtype="float32")


def _step(name, seed, cfg, mesh, B, dtensor, forward=False, step=True):
    """A whole-step sharding case: (helper fn, mesh, kwargs, maker)."""
    kw = {"cfg": _cfg_kw(cfg), "hyper": HYPER, "dtensor": dtensor, "forward": forward,
          "step": step}
    return name, ("step", mesh, kw,
                  lambda: _sharded_step_case(seed, cfg, mesh, B, forward, step))


# whole-step sharding (dp, fsdp, tp with sp and ep): whole params or
# shard_pytree's DTensors, against JAX's sharded jitted step. The MoE cases
# run at capacity factor 0.5, so the 4 experts keep at most half the tokens
# (drops are certain). The MoE step has one row a rank; two rows a rank are
# held by the forward (logits, aux): one AdamW step there moves an
# embedding element whose gradient (~1e-7) is below eps by up to
# lr / eps = 1e4 times the gradients' float32 rounding, which differs
# between the packages unsharded too.
STEP_CASES = dict([
    _step("step_dp2_tp2", 17, DENSE_CFG, {"dp": 2, "tp": 2}, B=4, dtensor=False),
    _step("step_dp2_fsdp2", 18, DENSE_CFG, {"dp": 2, "fsdp": 2}, B=8, dtensor=True),
    _step("step_fsdp2_ep2_moe", 19, MOE_DROPS_CFG, {"fsdp": 2, "ep": 2}, B=4, dtensor=True,
          forward=True),
    _step("forward_dp2_ep2_moe_rows2", 23, MOE_DROPS_CFG, {"dp": 2, "ep": 2}, B=8,
          dtensor=False, forward=True, step=False),
    _step("step_dp2_sp2", 20, DENSE_CFG, {"dp": 2, "sp": 2}, B=4, dtensor=False),
    _step("forward_tp4", 21, TP4_CFG, {"tp": 4}, B=2, dtensor=True, forward=True),
])

# name -> (rank helper function, mesh axes, helper kwargs, maker of (inputs, expected))
CASES = {
    "ring_causal": ("attention", {"sp": 4}, {"entry": "ring_attention", "causal": True},
                    lambda: _attention_case(0, {"sp": 4}, "ring_attention")),
    "ring_noncausal": ("attention", {"sp": 4}, {"entry": "ring_attention", "causal": False},
                       lambda: _attention_case(1, {"sp": 4}, "ring_attention", causal=False)),
    "ring_dp_sp": ("attention", {"dp": 2, "sp": 2}, {"entry": "ring_attention", "causal": True},
                   lambda: _attention_case(2, {"dp": 2, "sp": 2}, "ring_attention")),
    "ulysses": ("attention", {"sp": 4}, {"entry": "ulysses_attention", "causal": True},
                lambda: _attention_case(3, {"sp": 4}, "ulysses_attention", H=8)),
    "attention_auto_gqa": ("attention", {"sp": 4},
                           {"entry": "attention", "impl": "auto", "causal": True},
                           lambda: _attention_case(4, {"sp": 4}, "attention", Hkv=2)),
    "attention_ulysses_dp": ("attention", {"dp": 2, "sp": 2},
                             {"entry": "attention", "impl": "ulysses", "causal": True},
                             lambda: _attention_case(5, {"dp": 2, "sp": 2}, "attention",
                                                     impl="ulysses")),
    "pipeline_pp4": ("pipeline", {"pp": 4}, {"M": 4},
                     lambda: _pipeline_case(6, {"pp": 4}, 4)),
    "pipeline_dp_pp": ("pipeline", {"dp": 2, "pp": 2}, {"M": 2, "batch_axis": "dp"},
                       lambda: _pipeline_case(7, {"dp": 2, "pp": 2}, 2, "dp", B=8)),
    "moe_ep4": ("moe", {"ep": 4}, {"cf": 1.25}, lambda: _moe_case(8, 1.25)),
    "moe_ep4_drops": ("moe", {"ep": 4}, {"cf": 0.5}, lambda: _moe_case(9, 0.5)),
    "pp_loss_dp_pp": ("pp_loss", {"dp": 2, "pp": 2},
                      {"cfg": dict(PP_CFG, remat=False), "stages": 2, "M": 2},
                      lambda: _pp_case(10, remat=False)),
    "pp_loss_pp_tp": ("pp_loss", {"pp": 2, "tp": 2},
                      {"cfg": dict(PP_CFG, remat=True), "stages": 2, "M": 2, "tp_axis": "tp"},
                      lambda: _pp_case(11, remat=True)),
    "llama_moe_sp_ep": ("llama", {"sp": 2, "ep": 2},
                        {"cfg": _cfg_kw(MOE_CFG), "hyper": HYPER},
                        lambda: _llama_case(12, MOE_CFG)),
    # two batch rows on every rank: a token's place in its expert's queue
    # counts the earlier rows once
    "llama_moe_sp4": ("llama", {"sp": 4}, {"cfg": _cfg_kw(MOE_DROPS_CFG), "hyper": HYPER},
                      lambda: _llama_case(15, MOE_DROPS_CFG)),
    "llama_moe_sp_ep_b4": ("llama", {"sp": 2, "ep": 2},
                           {"cfg": _cfg_kw(MOE_CFG), "hyper": HYPER},
                           lambda: _llama_case(16, MOE_CFG, B=4)),
    "llama_dense_sp4": ("llama", {"sp": 4}, {"cfg": _cfg_kw(DENSE_CFG), "hyper": HYPER},
                        lambda: _llama_case(13, DENSE_CFG)),
    "mesh": ("mesh", {"fsdp": 2, "tp": 2}, {},
             lambda: ({"wq": _f32(_rng(14), 8, 8)}, {})),
    # pp in llama_forward is replicated compute, as under JAX's jit
    "pp_forward": ("pp_forward", {"pp": 4}, {"cfg": _cfg_kw(MOE_CFG)},
                   lambda: _pp_forward_case(22, MOE_CFG)),
    **STEP_CASES,
}


# ------------------------------------------------------------ the launch

def _launch(work) -> dict:
    """Write the cases, run the world, and return {"ok", "report"}."""
    inputs, expected = {}, {}
    for name, (_, _, _, build) in CASES.items():
        inp, exp = build()
        inputs.update({f"{name}/{k}": np.asarray(v) for k, v in inp.items()})
        expected.update({f"{name}/{k}": np.asarray(v) for k, v in exp.items()})
    np.savez(work / "inputs.npz", **inputs)
    np.savez(work / "expected.npz", **expected)
    with open(work / "cases.json", "w") as f:
        json.dump([{"name": n, "fn": fn, "mesh": mesh, "kw": kw}
                   for n, (fn, mesh, kw, _) in CASES.items()], f)
    env = dict(os.environ, PYTHONPATH=ROOT, WORLD_SIZE=str(WORLD), OMP_NUM_THREADS="1")
    procs, logs = [], []
    for rank in range(WORLD):
        log = open(work / f"rank_{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, HELPER, str(work)],
                                      env=dict(env, RANK=str(rank)), cwd=ROOT,
                                      stdout=log, stderr=subprocess.STDOUT))
    deadline, ok = time.monotonic() + LAUNCH_TIMEOUT, False
    try:
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes):
                break
            if all(c == 0 for c in codes):
                ok = True
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    report = "".join(f"--- rank {r} (exit {p.returncode}) ---\n"
                     + (work / f"rank_{r}.log").read_text()[-4000:]
                     for r, p in enumerate(procs))
    return {"ok": ok, "report": report}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):  # the session's dir, shared by the workers
        base = base.parent
    work = base / "torch_parallel_world"
    work.mkdir(exist_ok=True)
    with open(work / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        status = work / "status.json"
        if not status.exists():
            status.write_text(json.dumps(_launch(work)))
        result = json.loads(status.read_text())
    if not result["ok"]:
        return result, None, None, None
    with np.load(work / "expected.npz") as npz:
        expected = dict(npz)
    outs, errors = [], {}
    for rank in range(WORLD):
        with np.load(work / f"out_{rank}.npz") as npz:
            outs.append(dict(npz))
        errors.update(json.loads((work / f"errors_{rank}.json").read_text()))
    return result, expected, outs, errors


def _case(world, name):
    """[(rank outputs of ``name``)], expected of ``name``."""
    result, expected, outs, errors = world
    if not result["ok"]:
        pytest.fail(f"the {WORLD}-rank world failed:\n{result['report']}")
    if name in errors:
        pytest.fail(f"case {name} raised on a rank:\n{errors[name]}")
    pick = lambda d: {k[len(name) + 1:]: v for k, v in d.items() if k.startswith(name + "/")}
    return [pick(o) for o in outs], pick(expected)


def _close(ranks, expected, tol_out=2e-5, tol_grad=2e-4, loss_keys=()):
    assert expected
    for r, got in enumerate(ranks):
        assert set(got) == set(expected), (r, sorted(set(got) ^ set(expected)))
        for key, want in expected.items():
            if key in loss_keys:
                np.testing.assert_allclose(got[key], want, rtol=1e-5, err_msg=f"rank {r} {key}")
            else:
                tol = tol_grad if key.startswith("grad/") else tol_out
                np.testing.assert_allclose(got[key], want, atol=tol, rtol=0,
                                           err_msg=f"rank {r} {key}")


def test_world_ran_clean(world):
    result = world[0]
    assert result["ok"], result["report"]
    assert not world[3], world[3]


@pytest.mark.parametrize("name", ["ring_causal", "ring_noncausal", "ring_dp_sp", "ulysses",
                                  "attention_auto_gqa", "attention_ulysses_dp"])
def test_sequence_attention_matches_jax(world, name):
    ranks, expected = _case(world, name)
    _close(ranks, expected)


@pytest.mark.parametrize("name", ["pipeline_pp4", "pipeline_dp_pp"])
def test_pipeline_and_its_grads_match_jax(world, name):
    ranks, expected = _case(world, name)
    _close(ranks, expected)


@pytest.mark.parametrize("name", ["moe_ep4", "moe_ep4_drops"])
def test_moe_ffn_ep4_matches_unsharded_jax(world, name):
    ranks, expected = _case(world, name)
    # out 1e-5 and aux 1e-6 at float32, gradients 1e-4
    for got in ranks:
        np.testing.assert_allclose(got["aux"], expected["aux"], atol=1e-6, rtol=0)
    _close(ranks, expected, tol_out=1e-5, tol_grad=1e-4)


@pytest.mark.parametrize("name", ["pp_loss_dp_pp", "pp_loss_pp_tp"])
def test_llama_pp_loss_matches_unpipelined_jax(world, name):
    ranks, expected = _case(world, name)
    _close(ranks, expected, loss_keys=("loss",))


@pytest.mark.parametrize("name", ["llama_moe_sp_ep", "llama_moe_sp4", "llama_moe_sp_ep_b4",
                                  "llama_dense_sp4"])
def test_sharded_llama_forward_loss_and_step_match_jax(world, name):
    ranks, expected = _case(world, name)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["logits"], expected["logits"], atol=1e-4, rtol=0)
        np.testing.assert_allclose(got["aux"], expected["aux"], atol=1e-6, rtol=0)
        for key in ("loss", "step_loss"):
            np.testing.assert_allclose(got[key], expected[key], rtol=1e-5, err_msg=key)
        grads = [k for k in expected if k.startswith("grad/")]
        steps = [k for k in expected if k.startswith("step/")]
        assert grads and steps and set(got) == set(expected)
        for key in grads:
            np.testing.assert_allclose(got[key], expected[key], atol=1e-4, rtol=0,
                                       err_msg=f"rank {r} {key}")
        for key in steps:
            np.testing.assert_allclose(got[key], expected[key], atol=1e-4, rtol=0,
                                       err_msg=f"rank {r} {key}")


def test_mesh_and_shard_pytree_on_the_world(world):
    ranks, expected = _case(world, "mesh")
    wq = _f32(_rng(14), 8, 8)
    for r, got in enumerate(ranks):
        assert tuple(got["shape"]) == (1, 2, 1, 2, 1, 1)
        # row-major over AXIS_ORDER, as JAX reshapes its devices
        assert tuple(got["coord"]) == (0, r // 2, 0, r % 2, 0, 0)
        assert "needs 8 ranks" in str(got["too_big"])
        # wq/kernel: ("fsdp", "tp") -> rows over fsdp, columns over tp
        assert [str(p) for p in got["wq_placements"]] == [
            "R", "S(0)", "R", "S(1)", "R", "R"]
        assert all(str(p) == "R" for p in got["norm_placements"])
        np.testing.assert_array_equal(got["wq_full"], wq)
        np.testing.assert_array_equal(
            got["wq_local"], wq[(r // 2) * 4:(r // 2 + 1) * 4, (r % 2) * 4:(r % 2 + 1) * 4])


def test_sharded_forward_refuses_whole_step_axes(world):
    """What was refused (dp, fsdp, tp, pp) now runs: a pp axis in
    llama_forward is replicated compute, every rank with JAX's logits."""
    ranks, expected = _case(world, "pp_forward")
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["logits"], expected["logits"], atol=1e-4, rtol=0,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(got["aux"], expected["aux"], atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_whole_step_sharding_matches_jax_sharded_step(world, name):
    """Logits 1e-4 and aux 1e-6 of the forward; the loss rtol 1e-5 and every
    leaf after one AdamW step 1e-4 (HYPER's eps 1e-6), on every rank;
    DTensor params through full_tensor()."""
    ranks, expected = _case(world, name)
    for r, got in enumerate(ranks):
        assert set(got) == set(expected), (r, sorted(set(got) ^ set(expected)))
        if "logits" in expected:
            np.testing.assert_allclose(got["logits"], expected["logits"], atol=1e-4, rtol=0,
                                       err_msg=f"rank {r} logits")
            np.testing.assert_allclose(got["aux"], expected["aux"], atol=1e-6, rtol=0)
        if "loss" in expected:
            np.testing.assert_allclose(got["loss"], expected["loss"], rtol=1e-5,
                                       err_msg=f"rank {r}")
        for key in [k for k in expected if k.startswith("step/")]:
            np.testing.assert_allclose(got[key], expected[key], atol=1e-4, rtol=0,
                                       err_msg=f"rank {r} {key}")


# ------------------------------------------------ single-process checks

def test_mesh_spec_mirrors_jax():
    from ray_tpu.parallel import mesh as jmesh

    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    spec = tmesh.MeshSpec.infer(8, tp=2, sp=2)
    assert spec.dp == 2 and spec.size == 8
    assert spec.axes == jmesh.MeshSpec.infer(8, tp=2, sp=2).axes
    with pytest.raises(ValueError):
        tmesh.MeshSpec.infer(8, tp=3)
    with pytest.raises(ValueError, match="needs 1000"):
        tmesh.MeshSpec(dp=1000).build("cpu")
    # the layout JAX builds over the conftest's devices, as ranks
    jm = jmesh.get_abstract_mesh(jmesh.MeshSpec(dp=2, tp=2, sp=2))
    np.testing.assert_array_equal(tmesh.get_abstract_mesh(tmesh.MeshSpec(dp=2, tp=2, sp=2)),
                                  np.vectorize(lambda d: d.id)(jm.devices))


def test_partition_rules_match_jax():
    from ray_tpu.parallel import sharding as jsharding

    cfg = tllama.LlamaConfig.tiny(n_experts=4)
    tparams = tllama.llama_init(torch.Generator().manual_seed(0), cfg, "cpu")
    jparams = jllama.llama_init(jax.random.PRNGKey(0), jllama.LlamaConfig.tiny(n_experts=4))
    for rules in ("llama", "fsdp", "data_parallel"):
        want = _flat(jsharding.specs_for_pytree(
            jparams, getattr(jsharding.PartitionRules, rules)()))
        got = tsharding.specs_for_pytree(tparams, getattr(tsharding.PartitionRules, rules)())
        flat_got = {}

        def walk(node, prefix):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, f"{prefix}/{k}" if prefix else k)
            else:
                flat_got[prefix] = node

        walk(got, "")
        assert set(flat_got) == set(want)
        for path, spec in want.items():
            assert flat_got[path] == tuple(spec.tolist() if hasattr(spec, "tolist")
                                           else spec), (rules, path)
    assert tsharding.batch_spec(tmesh.MeshSpec()) == (("dp", "fsdp"), "sp")


def test_pp_stage_param_specs_match_jax():
    cfg = jllama.LlamaConfig(**PP_CFG)
    jpp = jllama.llama_pp_init(jax.random.PRNGKey(0), cfg, 2)
    tree = jax.tree.map(np.asarray, jpp)
    tcfg = tllama.LlamaConfig(**PP_CFG)
    flat = tllama.params_from_numpy(
        jax.tree.map(np.asarray, jllama.llama_init(jax.random.PRNGKey(0), cfg)), tcfg,
        device="cpu")
    tpp = tllama.stack_pp_params(flat, tcfg, 2)
    # the port's restacking is JAX's llama_pp_init layout, leaf for leaf
    for path, arr in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node = tpp
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node.numpy(), arr)
    for tp_axis in (None, "tp"):
        want = jllama.pp_stage_param_specs(jpp["stages"], tp_axis=tp_axis)
        got = tllama.pp_stage_param_specs(tpp["stages"], tp_axis=tp_axis)
        for path, spec in jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
            node = got
            for p in path:
                node = node[p.key]
            assert node == tuple(spec), (tp_axis, jax.tree_util.keystr(path))
    with pytest.raises(ValueError, match="dense"):
        tllama.llama_pp_init(torch.Generator(), tllama.LlamaConfig.tiny(n_experts=2), 2, "cpu")
