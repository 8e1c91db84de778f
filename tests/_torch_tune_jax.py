"""The JAX package's Tune results for the experiments of
``tests/test_torch_tune.py``. Not a test module.

    python tests/_torch_tune_jax.py <out.json>

Runs each experiment of ``experiments(tune)`` through ``ray_tpu.tune.Tuner``
on a fresh ``ray_tpu`` runtime in this process and writes ``{name: {"configs":
[each trial's config, in trial order], "statuses": [...], "best_config":
..., "best_metrics": ...}}``. The test runs the same experiments through
``ray_tpu_torch.tune`` and compares: the variants and the TPE suggestions
are pure Python over one seed in both packages, and each trainable's
reports are a function of its config, so every value must be equal. The
two runtimes never share a process (``_torch_data_jax.run_once`` starts
this script once a session).
"""
import faulthandler
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def experiments(tune):
    """{name: (trainable, param_space, TuneConfig keywords)} over a tune
    package (JAX's or the port's)."""
    def graded(config):
        for step in range(3):
            tune.report({"score": -100 * (config["lr"] - 0.05) ** 2 - config["wd"]
                         + step * config["nest"]["depth"] / 100 + config["k"] / 1000})

    def bowl(config):
        tune.report({"score": -(config["x"] - 1.0) ** 2 - abs(math.log10(config["y"]) + 1)
                     - (0.0 if config["opt"] == "a" else 0.5)})

    tpe_space = {"x": tune.uniform(-2.0, 2.0), "y": tune.loguniform(1e-3, 1.0),
                 "opt": tune.choice(["a", "b"])}
    return {
        # a grid crossed with four samplers, three samples of each cell
        "grid_and_samplers": (graded, {
            "lr": tune.grid_search([0.1, 0.01]), "wd": tune.uniform(0.0, 1.0),
            "nest": {"depth": tune.choice([2, 4, 8])}, "k": tune.randint(0, 100),
            "q": tune.quniform(0.0, 1.0, 0.25)},
            dict(metric="score", mode="max", num_samples=3, seed=7, max_concurrent_trials=4)),
        # one trial at a time: each suggestion observes every earlier result
        "tpe": (bowl, tpe_space, dict(
            metric="score", mode="max", num_samples=6, max_concurrent_trials=1,
            search_alg=tune.TPESearcher(tpe_space, metric="score", mode="max",
                                        n_initial=3, seed=0))),
    }


def run_experiments(tune, storage_root: str) -> dict:
    """Each experiment through ``tune.Tuner``: the trials' configs and
    statuses in trial order, and the best result's config and metrics."""
    import types

    out = {}
    for name, (trainable, space, kw) in experiments(tune).items():
        grid = tune.Tuner(trainable, param_space=space, tune_config=tune.TuneConfig(**kw),
                          run_config=types.SimpleNamespace(
                              storage_path=os.path.join(storage_root, name), name=name)).fit()
        best = grid.get_best_result()
        out[name] = {"configs": [r.config for r in grid], "statuses": [r.status for r in grid],
                     "best_config": best.config, "best_metrics": best.metrics}
    return out


def main() -> int:
    faulthandler.dump_traceback_later(240, exit=True)
    sys.path.insert(0, ROOT)
    import tempfile

    import ray_tpu
    from ray_tpu import tune

    ray_tpu.init(num_cpus=8)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = run_experiments(tune, tmp)
    finally:
        ray_tpu.shutdown()
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
