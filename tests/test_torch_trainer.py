"""TorchTrainer: the port's versions of JAX's four trainer tests
(``tests/test_train.py``), on the CPU with gloo worker actors.

The loops live in ``tests/_torch_train_loops.py``: a worker imports its loop
by name. ``fit`` starts the port's runtime (``ray_tpu_torch.init()``) and
runs one ``TrainWorker`` actor per rank in a placement group; the pytest
process never joins a process group itself. Every attempt runs under a
clock (``trainer.ATTEMPT_TIMEOUT_S``), every actor is killed on the way
out, and the runtime is shut down after the module.
"""

import os

import numpy as np
import pytest

import _torch_train_loops as loops
from _torch_time_limit import time_limits
from ray_tpu_torch.train import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    TorchTrainer,
)
from ray_tpu_torch.train import trainer as trainer_mod

# slowest case ~11.5 s alone (test_torch_trainer_worker_failure_restarts)
_module_limit, _test_limit = time_limits(module_s=60, test_s=60)


@pytest.fixture(autouse=True)
def clock(monkeypatch):
    monkeypatch.setattr(trainer_mod, "ATTEMPT_TIMEOUT_S", 60.0)


@pytest.fixture(autouse=True, scope="module")
def runtime():
    """The runtime ``fit`` starts lives for the module, then goes."""
    import ray_tpu_torch

    ray_tpu_torch.shutdown()  # a runtime another module left in this process
    yield
    ray_tpu_torch.shutdown()


def test_torch_trainer_dp(tmp_path):
    trainer = TorchTrainer(
        loops.dp_train_loop,
        train_loop_config={"lr": 0.1, "steps": 40},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False, collective_backend="gloo"),
        run_config=RunConfig(
            name="dp_test",
            storage_path=str(tmp_path / "ckpts"),
            checkpoint_config=CheckpointConfig(num_to_keep=2),
        ),
    )
    result = trainer.fit()
    assert result.error is None, result.error
    assert result.metrics["loss"] < 1.0
    assert result.checkpoint is not None
    state = result.checkpoint.to_dict()
    np.testing.assert_allclose(state["w"], [1, 2, 3, 4], atol=0.5)
    # top-K retention
    assert len(os.listdir(tmp_path / "ckpts")) <= 2
    # both ranks reported every checkpointed step; only rank 0's were kept
    assert sorted({m["world_rank"] for m in result.metrics_history}) == [0, 1]


def test_torch_trainer_single_worker(tmp_path):
    trainer = TorchTrainer(
        loops.answer_loop,
        train_loop_config={"x": 21},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False, collective_backend="gloo"),
        run_config=RunConfig(storage_path=str(tmp_path / "c2")),
    )
    result = trainer.fit()
    assert result.metrics["answer"] == 42


def test_torch_trainer_worker_failure_restarts(tmp_path):
    """FailureConfig path: worker 1 dies once, the group restarts and
    resumes from the last checkpoint."""
    marker = str(tmp_path / "crashed_once")
    trainer = TorchTrainer(
        loops.flaky_loop,
        train_loop_config={"marker": marker},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False, collective_backend="gloo"),
        run_config=RunConfig(
            storage_path=str(tmp_path / "c3"),
            failure_config=FailureConfig(max_failures=2),
        ),
    )
    result = trainer.fit()
    assert result.error is None, result.error
    assert os.path.exists(marker)  # crash really happened
    assert result.metrics["step"] == 5  # and training still completed
    # the restart began where rank 0's latest checkpoint left off, not at 0
    assert result.metrics["start"] > 0


def test_trainer_failure_exhausts(tmp_path):
    trainer = TorchTrainer(
        loops.always_fails,
        train_loop_config={},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False, collective_backend="gloo"),
        run_config=RunConfig(
            storage_path=str(tmp_path / "c4"),
            failure_config=FailureConfig(max_failures=1),
        ),
    )
    result = trainer.fit()
    assert result.error is not None
    assert "nope" in str(result.error)


def test_nested_loop_is_refused():
    def nested(config):
        return config

    with pytest.raises(ValueError, match="importable"):
        TorchTrainer(nested)


def test_trainer_defaults_to_the_card(tmp_path, monkeypatch):
    """As every port entry point: no ``use_gpu`` means the card, which
    raises without CUDA instead of training on the CPU; only an explicit
    ``use_gpu=False`` gives gloo workers on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for scaling in (ScalingConfig(), ScalingConfig(use_gpu=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            scaling.backend()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchTrainer(loops.answer_loop, train_loop_config={"x": 1}, scaling_config=scaling,
                         run_config=RunConfig(storage_path=str(tmp_path / "c5"))).fit()
    cpu = ScalingConfig(use_gpu=False)
    assert cpu.backend() == "gloo" and "GPU" not in cpu.worker_resources()


def test_workers_are_actors_of_the_runtime(tmp_path):
    """Each rank runs in a TrainWorker actor of the port's runtime (a worker
    process of its own), not in a process the trainer starts itself."""
    import ray_tpu_torch

    trainer = TorchTrainer(
        loops.actor_loop,
        train_loop_config={},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False, collective_backend="gloo"),
        run_config=RunConfig(storage_path=str(tmp_path / "c6")),
    )
    result = trainer.fit()
    assert result.error is None, result.error
    assert ray_tpu_torch.is_initialized()
    reports = {m["world_rank"]: m for m in result.metrics_history}
    assert sorted(reports) == [0, 1]
    assert all(m["in_actor"] and m["device"] == "cpu" for m in reports.values())
    pids = {m["pid"] for m in reports.values()}
    assert len(pids) == 2 and os.getpid() not in pids


def test_card_shares_name_one_card_each(monkeypatch):
    """Whole cards are pinned by the runtime's lease (no ids from the
    trainer); workers of a share of one card are told which card to set,
    as many to a card as the share allows."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,3")
    whole = TorchTrainer(loops.answer_loop, scaling_config=ScalingConfig(num_workers=2))
    assert whole._gpu_ids(2) is None
    half = TorchTrainer(loops.answer_loop, scaling_config=ScalingConfig(
        num_workers=4, resources_per_worker={"GPU": 0.5}, collective_backend="gloo"))
    assert half._gpu_ids(4) == [["2"], ["2"], ["3"], ["3"]]
    with pytest.raises(RuntimeError, match="need 3 cards"):
        half._gpu_ids(6)
    cpu = TorchTrainer(loops.answer_loop, scaling_config=ScalingConfig(use_gpu=False))
    assert cpu._gpu_ids(1) is None
