"""Checkpoints of the port (``ray_tpu_torch.train.checkpoint``) against the
JAX package's: the manager's top-K retention and scoring on the same
reports, JAX-written float32 checkpoints read by the port, bf16 round trips
bit for bit, and an AdamW resumed from ``to_state_dict`` bit for bit."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ray_tpu.train.checkpoint import Checkpoint as JCheckpoint
from ray_tpu.train.checkpoint import CheckpointManager as JManager
from ray_tpu_torch.models.llama import AdamW, LlamaConfig, llama_init, make_train_step
from ray_tpu_torch.train import Checkpoint, CheckpointManager
from ray_tpu_torch.utils.serialization import HostTensor, from_host, to_host

from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse

# slowest test 10.7 s, no module set-up (the port's modules alone under -n 6);
# the limits are several times that, so one that fires names a stalled test
_module_limit, _test_limit = time_limits(module_s=120, test_s=90)


REPORTS = [{"loss": 3.0, "step": 0}, {"loss": 1.0, "step": 1}, {"loss": 2.5, "step": 2},
           {"step": 3}, {"loss": 0.5, "step": 4}, {"loss": 4.0, "step": 5}]


@pytest.mark.parametrize("keep, attr, order", [(None, None, "max"), (2, None, "max"),
                                               (2, "loss", "min"), (3, "loss", "max"),
                                               (1, "step", "max")])
def test_retention_and_scoring_match_jax(tmp_path, keep, attr, order):
    jm = JManager(str(tmp_path / "jax"), num_to_keep=keep, score_attribute=attr,
                  score_order=order)
    tm = CheckpointManager(str(tmp_path / "port"), num_to_keep=keep, score_attribute=attr,
                           score_order=order)
    for i, metrics in enumerate(REPORTS):
        src = tmp_path / f"src_{i}"
        src.mkdir()
        (src / "state.pkl").write_bytes(b"x" * i)
        jm.register(JCheckpoint(str(src)), metrics)
        tm.register(Checkpoint(str(src)), metrics)
    assert [(s, m) for s, _, m in tm.checkpoints] == [(s, m) for s, _, m in jm.checkpoints]
    assert len(os.listdir(tmp_path / "port")) == len(os.listdir(tmp_path / "jax"))
    for pick in ("best", "latest"):
        got, want = getattr(tm, pick)(), getattr(jm, pick)()
        assert (open(os.path.join(got.path, "state.pkl"), "rb").read()
                == open(os.path.join(want.path, "state.pkl"), "rb").read()), pick


def test_register_moves_on_request(tmp_path):
    src = tmp_path / "staged"
    src.mkdir()
    (src / "state.pkl").write_bytes(b"abc")
    kept = CheckpointManager(str(tmp_path / "store")).register(Checkpoint(str(src)), {},
                                                              move=True)
    assert not src.exists()
    assert open(os.path.join(kept.path, "state.pkl"), "rb").read() == b"abc"


def test_float32_checkpoint_written_by_jax_reads_back(tmp_path):
    rng = np.random.default_rng(0)
    data = {"w": rng.standard_normal((3, 5)).astype(np.float32), "step": 7,
            "nested": {"b": rng.standard_normal(4).astype(np.float32)}}
    jc = JCheckpoint.from_dict(data)
    got = Checkpoint.from_directory(jc.path).to_dict()
    assert got["step"] == 7
    np.testing.assert_array_equal(got["w"], data["w"])
    np.testing.assert_array_equal(got["nested"]["b"], data["nested"]["b"])
    t = Checkpoint.from_directory(jc.path).to_state_dict("cpu")
    assert t["w"].dtype == torch.float32 and torch.equal(t["w"], torch.from_numpy(data["w"]))


def test_bf16_round_trip_bit_for_bit():
    w = torch.randn(17, 9, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    ck = Checkpoint.from_dict({"w": w, "f": torch.arange(3.0), "tag": "x"})
    host = ck.to_dict()
    assert isinstance(host["w"], HostTensor) and host["w"].dtype == "bfloat16"
    assert host["w"].bits.dtype == np.uint16
    assert isinstance(host["f"], np.ndarray) and host["tag"] == "x"
    back = from_host(host, "cpu")
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16), w.view(torch.int16))
    assert torch.equal(ck.to_state_dict("cpu")["f"], torch.arange(3.0))


def test_to_host_walks_lists_and_tuples():
    tree = {"a": [torch.ones(2), (torch.zeros(1, dtype=torch.int64), 3)]}
    host = to_host(tree)
    assert isinstance(host["a"][0], np.ndarray) and isinstance(host["a"][1], tuple)
    back = from_host(host, "cpu")
    assert torch.equal(back["a"][0], torch.ones(2)) and back["a"][1][1] == 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_resumes_bit_for_bit(dtype):
    """Two steps, a checkpoint of params and optimizer state, two more
    steps; against the same two steps from the checkpoint."""
    cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=dtype)
    batches = [{"tokens": torch.randint(0, 256, (2, 17),
                                        generator=torch.Generator().manual_seed(i))}
               for i in range(4)]
    opt = AdamW(1e-2)
    params = llama_init(torch.Generator().manual_seed(0), cfg, "cpu")
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    for b in batches[:2]:
        params, state, _ = step(params, state, b)
    ck = Checkpoint.from_state_dict({"params": params, "opt": state.state_dict(), "step": 2})
    losses = [float(step(params, state, b)[2]) for b in batches[2:]]

    saved = ck.to_state_dict("cpu")
    opt2 = AdamW(1e-2)
    params2 = saved["params"]
    state2 = opt2.init(params2)
    state2.load_state_dict(saved["opt"])
    step2 = make_train_step(cfg, opt2)
    losses2 = [float(step2(params2, state2, b)[2]) for b in batches[2:]]
    assert losses2 == losses
    for a, b in zip(state.param_groups[0]["params"], state2.param_groups[0]["params"]):
        assert torch.equal(a.detach(), b.detach())
