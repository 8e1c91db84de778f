"""The port's Tune (``ray_tpu_torch.tune``, with ``ray_tpu_torch.air``'s
callbacks) on its runtime, on the CPU, against the JAX package's
``ray_tpu.tune``.

Every case of ``tests/test_tune.py``, translated: variants and samplers,
ASHA, grid fits, early stopping, crash retry from a checkpoint, Tune over a
TorchTrainer, PBT, restore after a killed driver, TPE, logger callbacks and
the tracking integrations' import gate. JAX's ASHA and PBT cases pace their
trials with sleeps and count on the order that gives; their counterparts
here assert the mechanism from the scheduler's decisions (the weak ASHA
trials report only once the strong trials are complete, through a
driver-side callback).

Then the port against JAX: the search space and the schedulers (pure
Python, imported from both packages in process) on scripted result streams
give the same variants, TPE suggestions, ASHA, median-stopping and PBT
decisions and PBT mutations; both packages' ``Tuner`` on the same grid and
seed give the same trial configs and best result (JAX's side from
``tests/_torch_tune_jax.py`` on a JAX runtime in a subprocess). Tune over a
CPU ``TorchTrainer`` of ``LlamaConfig.tiny()`` gives each trial the losses of
a direct ``fit()``, and ``PPO.as_trainable`` and ``DQN.as_trainable`` run
through a ``Tuner``, each trial reporting what a direct build reports.

One port runtime serves the module; idle leases go back after 1 s.
"""

import dataclasses
import gc
import math
import os
import random
import types

import numpy as np
import pytest
import torch

import _torch_data_jax
import _torch_train_loops as loops
import _torch_tune_jax
import ray_tpu.tune.schedulers as jsched
import ray_tpu.tune.search as jsearch
import ray_tpu_torch
from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse
from ray_tpu_torch import tune
from ray_tpu_torch.air import LoggerCallback
from ray_tpu_torch.tune import schedulers as tsched
from ray_tpu_torch.tune import search as tsearch
from ray_tpu_torch.tune.schedulers import CONTINUE, EXPLOIT, STOP, ASHAScheduler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX Tuner's subprocess ~15 s alone, the restore case ~25 s, the RL
# trials ~30 s
_module_limit, _test_limit = time_limits(module_s=480, test_s=180)


@pytest.fixture(scope="module")
def rt():
    from ray_tpu_torch import config

    ray_tpu_torch.shutdown()  # a runtime another module left in this process
    cfg = config.get_config()
    config.set_config(dataclasses.replace(cfg, worker_lease_timeout_s=1.0))
    omp = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # the workers inherit it
    # DQN learns in its algorithm's process: here as in a trial actor
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ray_tpu_torch.init(num_cpus=16)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()
    config.set_config(cfg)
    torch.set_num_threads(threads)
    if omp is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = omp


@pytest.fixture(autouse=True)
def collect():
    """A test's trial actors go with their handles; a handle sits in a
    cycle, so collect it here, not at some later test's allocation."""
    yield
    gc.collect()


def _run_config(tmp_path, name):
    return types.SimpleNamespace(storage_path=str(tmp_path / name), name=name)


# ------------------------------------------------------------- search space
def test_generate_variants_grid_and_samples():
    space = {
        "lr": tune.grid_search([0.1, 0.2]),
        "wd": tune.uniform(0.0, 1.0),
        "net": {"depth": tune.grid_search([2, 4])},
    }
    variants = tune.generate_variants(space, num_samples=3, seed=0)
    assert len(variants) == 12  # 2 x 2 grid x 3 samples
    assert {v["lr"] for v in variants} == {0.1, 0.2}
    assert {v["net"]["depth"] for v in variants} == {2, 4}
    assert all(0.0 <= v["wd"] <= 1.0 for v in variants)
    # deterministic under a seed
    assert variants == tune.generate_variants(space, num_samples=3, seed=0)


def test_sampler_primitives():
    rng = random.Random(0)
    assert 1e-4 <= tune.loguniform(1e-4, 1e-1).sample(rng) <= 1e-1
    assert tune.randint(0, 5).sample(rng) in range(5)
    assert tune.choice(["a", "b"]).sample(rng) in ("a", "b")
    assert tune.quniform(0, 1, 0.25).sample(rng) in (0.0, 0.25, 0.5, 0.75, 1.0)


# ---------------------------------------------------------------- schedulers
def test_asha_stops_losers():
    asha = ASHAScheduler(metric="acc", mode="max", grace_period=1,
                         reduction_factor=2, max_t=8)
    # rung t=1: continue only in the top 1/rf (with one recorded value a
    # trial always continues)
    assert asha.on_result("t0", {"training_iteration": 1, "acc": 0.9}) == CONTINUE
    # 0.8 is below the median of {0.9, 0.8} -> stopped
    assert asha.on_result("t1", {"training_iteration": 1, "acc": 0.8}) == STOP
    assert asha.on_result("t2", {"training_iteration": 1, "acc": 0.1}) == STOP
    # a new best always continues
    assert asha.on_result("t3", {"training_iteration": 1, "acc": 0.95}) == CONTINUE


# ------------------------------------------------------------ e2e execution
def test_tuner_grid_fit(rt, tmp_path):
    def trainable(config):
        for step in range(3):
            tune.report({"score": config["x"] * 10 + step})
        return "ok"

    tuner = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([1, 2, 3])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    max_concurrent_trials=3),
        run_config=_run_config(tmp_path, "grid"),
    )
    results = tuner.fit()
    assert len(results) == 3
    assert not results.errors
    best = results.get_best_result()
    assert best.config["x"] == 3
    assert best.metrics["score"] == 32  # x=3, last step=2


class _RecordingASHA(ASHAScheduler):
    """ASHA that keeps every decision: (trial, iteration, value, decision)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.decisions = []

    def on_result(self, trial_id, result):
        decision = super().on_result(trial_id, result)
        self.decisions.append((trial_id, result.get(self.time_attr), result.get(self.metric),
                               decision))
        return decision


class _Gate(LoggerCallback):
    """Opens (creates ``path``) once both strong trials are complete: the
    scheduler has taken every result they reported."""

    def __init__(self, path):
        self.path = path
        self.strong = set()
        self.done = set()

    def on_trial_start(self, trial_id, config):
        if config["quality"] > 0.5:
            self.strong.add(trial_id)

    def on_trial_complete(self, trial_id, metrics):
        self.done.add(trial_id)
        if len(self.strong) == 2 and self.strong <= self.done:
            open(self.path, "w").close()


def test_tuner_asha_early_stops(rt, tmp_path):
    """Weak trials are early-stopped at their first rung, the strongest
    finishes (ASHA semantics of async_hyperband.py). The weak trials
    report only after the gate opens, so the strong results are recorded
    at every rung first, by order of events, not by sleeps."""
    gate = str(tmp_path / "gate")

    def trainable(config):
        import os as _os
        import time as _time

        if config["quality"] < 0.5:
            deadline = _time.monotonic() + 120
            while not _os.path.exists(config["gate"]):
                if _time.monotonic() > deadline:
                    raise TimeoutError("the strong trials did not finish")
                _time.sleep(0.02)
        for step in range(8):
            tune.report({"acc": config["quality"] + step * 0.001})

    asha = _RecordingASHA(metric="acc", mode="max", grace_period=2, reduction_factor=2,
                          max_t=8)
    tuner = tune.Tuner(
        trainable,
        param_space={"quality": tune.grid_search([0.1, 0.2, 0.9, 0.95]), "gate": gate},
        tune_config=tune.TuneConfig(metric="acc", mode="max", max_concurrent_trials=4,
                                    scheduler=asha, callbacks=[_Gate(gate)]),
        run_config=_run_config(tmp_path, "asha"),
    )
    results = tuner.fit()
    assert not results.errors
    by_quality = {r.config["quality"]: r for r in results}
    assert by_quality[0.95].status == "TERMINATED"
    assert len(by_quality[0.95].metrics_history) == 8
    for q in (0.1, 0.2):  # stopped at the first rung, t = grace_period
        r = by_quality[q]
        assert r.status == "STOPPED", (q, r.status, asha.decisions)
        assert [m["training_iteration"] for m in r.metrics_history] == [1, 2]
        assert [d for tid, t, _, d in asha.decisions if tid == r.trial_id] == [
            CONTINUE, STOP]
    # every STOP was a value under its rung's cutoff when it was recorded
    replay = ASHAScheduler(metric="acc", mode="max", grace_period=2, reduction_factor=2,
                           max_t=8)
    for tid, t, v, d in asha.decisions:
        assert replay.on_result(tid, {"training_iteration": t, "acc": v}) == d
    assert results.get_best_result().config["quality"] == 0.95


def test_tuner_checkpoint_and_retry(rt, tmp_path):
    """A crashing trial retries and resumes from its last checkpoint
    (ref: tune trial fault tolerance + restore path)."""
    marker = str(tmp_path / "crashed")

    def trainable(config):
        import os as _os

        from ray_tpu_torch.train.checkpoint import Checkpoint

        start = 0
        ckpt = tune.get_checkpoint()
        if ckpt:
            start = ckpt.to_dict()["step"] + 1
        for step in range(start, 6):
            if step == 3 and not _os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                _os._exit(1)
            tune.report(
                {"step": step}, checkpoint=Checkpoint.from_dict({"step": step})
            )

    tuner = tune.Tuner(
        trainable,
        param_space={"marker": marker},
        tune_config=tune.TuneConfig(metric="step", mode="max",
                                    max_failures_per_trial=1),
        run_config=_run_config(tmp_path, "retry"),
    )
    results = tuner.fit()
    assert not results.errors
    assert os.path.exists(marker)
    assert results[0].metrics["step"] == 5
    # the retry resumed at step 3 (the checkpoint of step 2), not at 0
    assert [m["step"] for m in results[0].metrics_history] == [0, 1, 2, 3, 4, 5]


def test_tune_over_train(rt, tmp_path):
    """Tuner(TorchTrainer): each trial runs a full (1-worker) training job
    from a trial actor (ref: BaseTrainer-as-Trainable, base_trainer.py:808)."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    trainer = TorchTrainer(
        loops.loss_over_lr_loop,
        train_loop_config={"lr": 1.0},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False, collective_backend="gloo"),
        run_config=RunConfig(storage_path=str(tmp_path / "t")),
    )
    tuner = tune.Tuner(
        trainer,
        param_space={"train_loop_config": {"lr": tune.grid_search([1.0, 10.0])}},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_concurrent_trials=1),
        run_config=_run_config(tmp_path, "over_train"),
    )
    results = tuner.fit()
    assert not results.errors
    assert results.get_best_result().config["train_loop_config"]["lr"] == 10.0
    # each trial's run kept its checkpoints in a directory of its own
    assert sorted(os.listdir(tmp_path / "t")) == sorted(r.trial_id for r in results)


# ----------------------------------------------------------------------- PBT
class _RecordingPBT(tune.PopulationBasedTraining):
    """PBT that keeps each EXPLOIT decision with the quantiles it saw, and
    each explore's donor config and result."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.exploits = []
        self.explored = []

    def on_result(self, trial_id, result):
        decision = super().on_result(trial_id, result)
        if decision == EXPLOIT:
            self.exploits.append((trial_id, self._quantiles()))
        return decision

    def explore(self, config):
        out = super().explore(config)
        self.explored.append((dict(config), out))
        return out


def test_pbt_exploits_bottom_quantile(rt, tmp_path):
    """PBT (ref: tune/schedulers/pbt.py): a trial in the bottom quantile
    at a perturbation point adopts a top trial's checkpoint and a mutation
    of its config, and then outgrows what its own rate could reach. Held
    on the scheduler's recorded decisions (the trainable's pause only lets
    the trials' reports interleave)."""
    from ray_tpu_torch.train.checkpoint import Checkpoint

    def trainable(config):
        import time as _time

        start = 0.0
        ckpt = tune.get_checkpoint()
        if ckpt is not None:
            start = ckpt.to_dict()["score"]
        score = start
        for _ in range(24):
            score += config["rate"]
            tune.report({"score": score}, checkpoint=Checkpoint.from_dict({"score": score}))
            _time.sleep(0.25)

    # quantile 0.5 with a 2-good/2-bad population: the bottom quantile
    # always holds both bad trials once all four have reported
    pbt = _RecordingPBT(
        metric="score", mode="max", perturbation_interval=3,
        hyperparam_mutations={"rate": [0.1, 1.0]}, quantile_fraction=0.5,
        resample_probability=0.5, seed=0)
    tuner = tune.Tuner(
        trainable,
        param_space={"rate": tune.grid_search([1.0, 1.0, 0.1, 0.1])},
        tune_config=tune.TuneConfig(metric="score", mode="max", scheduler=pbt,
                                    max_concurrent_trials=4),
        run_config=_run_config(tmp_path, "pbt"),
    )
    results = tuner.fit()
    assert pbt.num_exploits > 0, f"PBT never exploited; scores={pbt.scores}"
    assert len(pbt.explored) == pbt.num_exploits
    for trial_id, (bottom, top) in pbt.exploits:
        assert trial_id in bottom and top and trial_id not in top
    for donor, out in pbt.explored:
        r = donor["rate"]
        assert out["rate"] in (0.1, 1.0, r * 1.2, r * 0.8), (donor, out)
    exploited = {tid for tid, _ in pbt.exploits}
    scores = {r.trial_id: r.metrics["score"] for r in results}
    # a pure rate=0.1 trial tops out at 2.4; an exploiter restarts from a
    # top trial's checkpoint
    assert any(scores[t] > 2.4 for t in exploited if t in scores), (scores, exploited)
    assert sum(s > 3.0 for s in scores.values()) >= 2, scores


def test_tuner_restore_after_kill(rt, tmp_path):
    """Kill the driver mid-experiment, then Tuner.restore completes it:
    finished trials keep their results, unfinished ones resume from their
    checkpoints (no restart from zero)."""
    import signal
    import subprocess
    import sys
    import time

    storage = str(tmp_path / "exp")
    marker_dir = str(tmp_path / "markers")
    os.makedirs(marker_dir, exist_ok=True)
    driver = f'''
import sys
sys.path.insert(0, {ROOT!r})
import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.train.checkpoint import Checkpoint

ray_tpu_torch.init(num_cpus=8)

def trainable(config):
    import os, time
    start = 0
    ckpt = tune.get_checkpoint()
    if ckpt is not None:
        start = ckpt.to_dict()["step"]
    for step in range(start, 10):
        open(os.path.join({marker_dir!r}, f"t{{config['i']}}_s{{step}}"), "w").close()
        tune.report({{"step": step}},
                    checkpoint=Checkpoint.from_dict({{"step": step + 1}}))
        time.sleep(0.4)

tune.Tuner(trainable,
           param_space={{"i": tune.grid_search([0, 1])}},
           tune_config=tune.TuneConfig(metric="step", mode="max",
                                       max_concurrent_trials=2),
           run_config=type("RC", (), {{"storage_path": {storage!r},
                                       "name": None}})()).fit()
'''
    env = dict(os.environ, OMP_NUM_THREADS="1")
    p = subprocess.Popen([sys.executable, "-c", driver], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        # wait until both trials made progress AND a state snapshot exists
        deadline = time.monotonic() + 120
        state = os.path.join(storage, "experiment_state.pkl")
        while time.monotonic() < deadline:
            if len(os.listdir(marker_dir)) >= 6 and os.path.exists(state):
                break
            if p.poll() is not None:
                raise AssertionError(f"driver exited early:\n{p.stdout.read().decode()}")
            time.sleep(0.2)
    finally:
        p.send_signal(signal.SIGKILL)
        p.wait(timeout=30)
    assert os.listdir(marker_dir), "driver never progressed"

    # resume in THIS process (the module's runtime)
    def trainable(config):
        import os as _os

        start = 0
        ckpt = tune.get_checkpoint()
        if ckpt is not None:
            start = ckpt.to_dict()["step"]
        for step in range(start, 10):
            open(_os.path.join(marker_dir, f"t{config['i']}_s{step}"), "w").close()
            tune.report({"step": step},
                        checkpoint=tune.Checkpoint.from_dict({"step": step + 1}))

    results = tune.Tuner.restore(
        storage, trainable,
        tune_config=tune.TuneConfig(metric="step", mode="max",
                                    max_concurrent_trials=2)).fit()
    assert len(results) == 2
    for r in results:
        assert r.error is None
        assert r.metrics["step"] == 9, r.metrics
    # resumed from checkpoints: every step ran, none from zero again
    all_markers = os.listdir(marker_dir)
    assert len(all_markers) == len(set(all_markers)) == 20


# ------------------------------------------------------------------ TPE
def test_tpe_searcher_beats_random():
    """Sequential suggest/observe concentrates samples near the optimum:
    on a fixed-seed quadratic it beats pure random search at the same
    budget and lands near the optimum."""
    space = {"x": tune.uniform(0.0, 1.0),
             "nest": {"y": tune.loguniform(1e-3, 1.0)},
             "opt": tune.choice(["good", "bad"])}

    def objective(cfg):
        penalty = 0.0 if cfg["opt"] == "good" else 0.5
        return ((cfg["x"] - 0.7) ** 2
                + (cfg["nest"]["y"] - 0.05) ** 2 + penalty)

    budget = 48
    tpe = tune.TPESearcher(space, metric="loss", mode="min", n_initial=8, seed=3)
    tpe_losses = []
    for i in range(budget):
        cfg = tpe.suggest(f"t{i}")
        loss = objective(cfg)
        tpe_losses.append(loss)
        tpe.on_trial_complete(f"t{i}", {"loss": loss})
    random_losses = [objective(cfg)
                     for cfg in tune.generate_variants(space, num_samples=budget, seed=3)]
    tpe_mean = float(np.mean(tpe_losses[8:]))
    rand_mean = float(np.mean(random_losses))
    assert tpe_mean < rand_mean * 0.5, (tpe_mean, rand_mean)
    assert min(tpe_losses) < 0.02, f"TPE did not converge: {min(tpe_losses)}"


def test_tuner_with_tpe_search_alg(rt, tmp_path):
    """Tuner(search_alg=TPESearcher) creates trials on demand and optimizes
    the reported metric."""
    space = {"x": tune.uniform(-2.0, 2.0)}

    def trainable(config):
        tune.report({"score": -(config["x"] - 1.0) ** 2})

    tuner = tune.Tuner(
        trainable,
        param_space=space,
        tune_config=tune.TuneConfig(
            metric="score", mode="max", num_samples=12, max_concurrent_trials=3,
            search_alg=tune.TPESearcher(space, metric="score", mode="max", n_initial=4,
                                        seed=0)),
        run_config=_run_config(tmp_path, "tpe"),
    )
    grid = tuner.fit()
    assert len(grid) == 12
    best = grid.get_best_result()
    assert best.metrics["score"] > -0.5, best.metrics


def test_logger_callbacks_receive_events(rt, tmp_path):
    """air.LoggerCallback hook: callbacks see start/result/complete for
    every trial, driver-side."""
    events = []

    class Recorder(LoggerCallback):
        def setup(self, experiment_name=None):
            events.append(("setup", experiment_name))

        def on_trial_start(self, trial_id, config):
            events.append(("start", trial_id, config["x"]))

        def on_trial_result(self, trial_id, metrics):
            events.append(("result", trial_id, metrics["score"]))

        def on_trial_complete(self, trial_id, metrics):
            events.append(("complete", trial_id))

        def on_experiment_end(self):
            events.append(("end",))

    def trainable(config):
        tune.report({"score": config["x"] * 2})

    grid = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([1, 2])},
        tune_config=tune.TuneConfig(metric="score", mode="max", callbacks=[Recorder()]),
        run_config=_run_config(tmp_path, "cb"),
    ).fit()
    assert len(grid) == 2
    kinds = [e[0] for e in events]
    assert events[0] == ("setup", "cb") and kinds[-1] == "end"
    assert kinds.count("start") == 2
    assert kinds.count("result") == 2
    assert kinds.count("complete") == 2
    assert sorted(e[2] for e in events if e[0] == "result") == [2, 4]


def test_tracking_integrations_import_gate():
    """wandb/mlflow callbacks fail loudly at CONSTRUCTION when the SDK is
    absent (neither machine ships them)."""
    from ray_tpu_torch.air import MLflowLoggerCallback, WandbLoggerCallback

    with pytest.raises(ImportError, match="wandb"):
        WandbLoggerCallback(project="p")
    with pytest.raises(ImportError, match="mlflow"):
        MLflowLoggerCallback()


# ------------------------------------------------------------ against JAX
SPACES = {
    "grid_and_samplers": lambda s: {
        "lr": s.grid_search([0.1, 0.01]), "wd": s.uniform(0.0, 1.0),
        "nest": {"depth": s.choice([2, 4, 8]), "g": s.grid_search(["a", "b", "c"])},
        "k": s.randint(0, 100), "q": s.quniform(0.0, 1.0, 0.25),
        "log": s.loguniform(1e-5, 1e-1), "fixed": 3},
    "samplers_only": lambda s: {"x": s.uniform(-1.0, 1.0), "c": s.choice([1, "b", None])},
    "empty": lambda s: {},
}


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("space", sorted(SPACES))
def test_variants_match_jax(space, seed):
    """One space and seed: JAX's variants, in its order."""
    assert tsearch.generate_variants(SPACES[space](tsearch), 4, seed) == \
        jsearch.generate_variants(SPACES[space](jsearch), 4, seed)


@pytest.mark.parametrize("mode", ["min", "max"])
def test_tpe_suggestions_match_jax(mode):
    """TPE over every sampler kind, observing the same scores: the same
    suggestions, warm-up and model-driven alike."""
    def space(s):
        return {"u": s.uniform(0.0, 1.0), "l": s.loguniform(1e-4, 1.0),
                "q": s.quniform(-2.0, 2.0, 0.5), "r": s.randint(0, 1000),
                "nest": {"c": s.choice(["a", "b", "c"])}}

    def score(cfg):
        return ((cfg["u"] - 0.3) ** 2 + abs(math.log10(cfg["l"]) + 2) + cfg["q"] ** 2
                + (cfg["r"] - 400) ** 2 / 1e5 + (cfg["nest"]["c"] != "b"))

    ours = tsearch.TPESearcher(space(tsearch), metric="m", mode=mode, n_initial=5, seed=11)
    theirs = jsearch.TPESearcher(space(jsearch), metric="m", mode=mode, n_initial=5, seed=11)
    for i in range(30):
        a, b = ours.suggest(f"t{i}"), theirs.suggest(f"t{i}")
        assert a == b, i
        ours.on_trial_complete(f"t{i}", {"m": score(a)})
        theirs.on_trial_complete(f"t{i}", {"m": score(b)})


def _stream(seed: int, trials: int, steps: int):
    """A scripted result stream: trials report in a seeded interleaving,
    each with a noisy trend of its own, sometimes skipping iterations."""
    rng = np.random.default_rng(seed)
    slope = rng.normal(0, 1, trials)
    t = [0] * trials
    out = []
    while min(t) < steps:
        i = int(rng.integers(0, trials))
        if t[i] >= steps:
            continue
        t[i] += int(rng.integers(1, 3))
        out.append((f"trial_{i}", {"training_iteration": t[i],
                                   "acc": float(slope[i] * t[i] + rng.normal(0, 0.5))}))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_asha_and_median_decisions_match_jax(seed):
    stream = _stream(seed, trials=9, steps=20)
    pairs = [
        (tsched.ASHAScheduler(metric="acc", mode="max", grace_period=1, reduction_factor=3,
                              max_t=20),
         jsched.ASHAScheduler(metric="acc", mode="max", grace_period=1, reduction_factor=3,
                              max_t=20)),
        (tsched.ASHAScheduler(metric="acc", mode="min", grace_period=2, max_t=20),
         jsched.ASHAScheduler(metric="acc", mode="min", grace_period=2, max_t=20)),
        (tsched.MedianStoppingRule(metric="acc", mode="max", grace_period=3,
                                   min_samples_required=2),
         jsched.MedianStoppingRule(metric="acc", mode="max", grace_period=3,
                                   min_samples_required=2)),
        (tsched.FIFOScheduler(), jsched.FIFOScheduler()),
    ]
    for ours, theirs in pairs:
        ours_d = [ours.on_result(tid, r) for tid, r in stream]
        theirs_d = [theirs.on_result(tid, r) for tid, r in stream]
        assert ours_d == theirs_d, type(ours).__name__
        # the stream is long enough that every early stopper stops trials
        assert (STOP in ours_d) != isinstance(ours, tsched.FIFOScheduler)
        if isinstance(ours, tsched.MedianStoppingRule):
            ours.on_trial_complete("trial_0", None)
            theirs.on_trial_complete("trial_0", None)
            assert ours._history.keys() == theirs._history.keys()


@pytest.mark.parametrize("seed", [0, 3])
def test_pbt_decisions_and_mutations_match_jax(seed):
    """PBT on one stream: the same EXPLOIT decisions, donors and explored
    configs (list, sampler and callable mutations, perturbed scalars)."""
    def pbt(s, sched):
        return sched.PopulationBasedTraining(
            metric="acc", mode="max", perturbation_interval=2,
            hyperparam_mutations={"lr": s.loguniform(1e-4, 1e-1), "bs": [16, 32, 64],
                                  "wd": lambda: 0.5, "m": s.choice([0.8, 0.9])},
            quantile_fraction=0.25, resample_probability=0.4, seed=seed)

    ours, theirs = pbt(tsearch, tsched), pbt(jsearch, jsched)
    config = {"lr": 0.01, "bs": 32, "wd": 0.1, "m": 0.9, "keep": "x"}
    exploits = 0
    for tid, r in _stream(seed + 10, trials=8, steps=16):
        a, b = ours.on_result(tid, r), theirs.on_result(tid, r)
        assert a == b
        if a == EXPLOIT:
            exploits += 1
            donor = ours.pick_donor(exclude=tid)
            assert donor == theirs.pick_donor(exclude=tid)
            assert ours.explore(dict(config)) == theirs.explore(dict(config))
    assert exploits > 0


@pytest.fixture(scope="module")
def jax_tuner(tmp_path_factory):
    """JAX's Tuner results for ``_torch_tune_jax.experiments``, from a
    subprocess with a JAX runtime of its own (one a session)."""
    return _torch_data_jax.run_once(tmp_path_factory, "_torch_tune_jax.py", timeout=240)


def test_tuner_matches_jax(rt, jax_tuner, tmp_path):
    """Both packages' Tuner on the same grid, samplers and seed, and on the
    same TPE search: the same trial configs in the same order, the same
    statuses and the same best result."""
    ours = _torch_tune_jax.run_experiments(tune, str(tmp_path))
    assert ours.keys() == jax_tuner.keys()
    for name, want in jax_tuner.items():
        got = ours[name]
        assert got["configs"] == want["configs"], name
        assert got["statuses"] == want["statuses"] == ["TERMINATED"] * len(want["configs"])
        assert got["best_config"] == want["best_config"], name
        assert got["best_metrics"] == want["best_metrics"], name


# ------------------------------------------------ Tune over a TorchTrainer
def test_tune_over_torch_trainer_losses_equal_direct_fits(rt, tmp_path):
    """Two concurrent trials of a CPU TorchTrainer over LlamaConfig.tiny()
    at two learning rates: each trial's losses equal a direct fit() of the
    same loop and config, and each trial's run has a storage directory of
    its own."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    def trainer(config, storage):
        return TorchTrainer(
            loops.tiny_llama_loop, train_loop_config=config,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
            run_config=RunConfig(storage_path=storage))

    base = {"seed": 0, "steps": 3, "lr": 1e-3}
    grid = tune.Tuner(
        trainer(base, str(tmp_path / "runs")),
        param_space={"train_loop_config": {"lr": tune.grid_search([1e-3, 3e-3])}},
        tune_config=tune.TuneConfig(metric="loss", mode="min", max_concurrent_trials=2),
        run_config=_run_config(tmp_path, "llama"),
    ).fit()
    assert not grid.errors and [r.status for r in grid] == ["TERMINATED"] * 2
    assert sorted(os.listdir(tmp_path / "runs")) == sorted(r.trial_id for r in grid)
    for r in grid:
        lr = r.config["train_loop_config"]["lr"]
        direct = trainer({**base, "lr": lr}, str(tmp_path / f"direct_{lr}")).fit()
        assert direct.error is None
        assert r.metrics["losses"] == direct.metrics["losses"], lr
    a, b = (r.metrics["losses"] for r in grid)
    # one start (same weights and batch), then the learning rates part
    assert a[0] == b[0] and all(x != y for x, y in zip(a[1:], b[1:]))
    best = grid.get_best_result()
    assert best.metrics["loss"] == min(r.metrics["loss"] for r in grid)


# --------------------------------------------------------- RL through Tune
def _same(a, b) -> bool:
    return (math.isnan(a) and math.isnan(b)) or a == b


def _ppo_config():
    from ray_tpu_torch import rllib

    return (rllib.PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=1, num_envs_per_env_runner=2,
                         rollout_fragment_length=32)
            .training(epochs=1, minibatches=2, hidden=16).resources(device="cpu"))


def _dqn_config():
    from ray_tpu_torch import rllib

    return (rllib.DQNConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=1, num_envs_per_env_runner=2,
                         rollout_fragment_length=32)
            .training(hidden=16, learning_starts=32, train_batches_per_iter=2, batch_size=16)
            .resources(device="cpu"))


@pytest.mark.parametrize("algo", ["PPO", "DQN"])
def test_rl_as_trainable_through_tuner(rt, tmp_path, algo):
    """as_trainable through a Tuner on the CPU: both trials end TERMINATED
    with one report an iteration, and the trial at the config's lr reports
    what a direct build of the same config and seed reports."""
    from ray_tpu_torch import rllib

    make = _ppo_config if algo == "PPO" else _dqn_config
    cls = getattr(rllib, algo)
    lr = make().lr
    trainable = cls.as_trainable(make(), stop_iters=2)
    assert getattr(trainable, "trial_resources", None) is None  # a CPU trial: one CPU
    grid = tune.Tuner(
        trainable, param_space={"lr": tune.grid_search([lr, 3 * lr])},
        tune_config=tune.TuneConfig(metric="episode_return_mean", mode="max",
                                    max_concurrent_trials=2),
        run_config=_run_config(tmp_path, algo),
    ).fit()
    assert not grid.errors and [r.status for r in grid] == ["TERMINATED"] * 2
    assert all(len(r.metrics_history) == 2 for r in grid)
    tuned = next(r for r in grid if r.config["lr"] == lr).metrics_history
    direct = make().build()
    try:
        for got in tuned:
            want = direct.train()
            assert got["training_iteration"] == want["training_iteration"]
            assert _same(got["episode_return_mean"], want["episode_return_mean"]), (got, want)
            assert _same(got["loss"], want["loss"]), (got, want)
    finally:
        direct.stop()


def test_dqn_trial_on_the_card_leases_one(monkeypatch):
    """DQN learns in the trial's own process: on the card its trial asks for
    a card (the trial actor's lease covers it), on the CPU for one CPU."""
    from ray_tpu_torch.rllib import dqn

    monkeypatch.setattr(dqn, "resolve_device", lambda d: torch.device(d or "cuda"))
    cfg = _dqn_config().resources(device=None)
    trainable = dqn.DQN.as_trainable(cfg)
    assert trainable.trial_resources == {"CPU": 1.0, "GPU": 1.0}
    from ray_tpu_torch.tune import _as_trainable

    assert _as_trainable(trainable)[1] == {"CPU": 1.0, "GPU": 1.0}
    assert _as_trainable(dqn.DQN.as_trainable(_dqn_config()))[1] == {"CPU": 1.0}
