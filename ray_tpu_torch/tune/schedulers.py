"""Trial schedulers: early stopping of unpromising trials.

A copy of ``ray_tpu/tune/schedulers.py``: on one result stream the port's
schedulers take the JAX package's decisions, and PBT, seeded alike, draws
the same donors and mutations. Equivalents of the reference schedulers (ref:
python/ray/tune/schedulers/async_hyperband.py AsyncHyperBandScheduler —
the ASHA algorithm, median_stopping_rule.py, trial_scheduler.py
FIFOScheduler). Decisions are made on each reported result:
CONTINUE or STOP.
"""
from __future__ import annotations

import collections

CONTINUE = "CONTINUE"
STOP = "STOP"


class FIFOScheduler:
    """No early stopping (ref: trial_scheduler.py FIFOScheduler)."""

    def on_result(self, trial_id: str, result: dict) -> str:
        return CONTINUE

    def on_trial_complete(self, trial_id: str, result: dict | None) -> None:
        pass


class ASHAScheduler:
    """Asynchronous Successive Halving (ref: async_hyperband.py:19 — the
    ASHA paper's algorithm): rungs at grace_period * reduction_factor^k;
    a trial reaching a rung continues only if its metric is in the top
    1/reduction_factor of results recorded at that rung."""

    def __init__(self, metric: str, mode: str = "max", time_attr: str = "training_iteration",
                 grace_period: int = 1, reduction_factor: int = 4, max_t: int = 100):
        assert mode in ("max", "min")
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.rf = reduction_factor
        self.max_t = max_t
        # rung milestone -> list of recorded metric values
        self.rungs: dict[int, list[float]] = collections.defaultdict(list)
        # rung milestone -> trial_ids already recorded there (trials report
        # at arbitrary strides; each crosses a rung at most once)
        self._recorded: dict[int, set[str]] = collections.defaultdict(set)
        milestones = []
        t = grace_period
        while t < max_t:
            milestones.append(t)
            t *= reduction_factor
        self.milestones = milestones

    def _val(self, result: dict) -> float:
        v = float(result[self.metric])
        return v if self.mode == "max" else -v

    def on_result(self, trial_id: str, result: dict) -> str:
        if self.metric not in result or self.time_attr not in result:
            return CONTINUE
        t = int(result[self.time_attr])
        v = self._val(result)
        decision = CONTINUE
        # evaluate every rung the trial has crossed (t >= milestone, not
        # equality — trials may report in strides; matches the reference's
        # largest-milestone-<=-t behavior)
        for milestone in self.milestones:
            if t >= milestone and trial_id not in self._recorded[milestone]:
                self._recorded[milestone].add(trial_id)
                recorded = self.rungs[milestone]
                recorded.append(v)
                # continue only in the top 1/rf at this rung: cutoff is the
                # (1 - 1/rf) percentile of recorded values (matches the
                # reference _Bracket.cutoff, async_hyperband.py)
                import numpy as np

                cutoff = float(np.nanpercentile(recorded, (1 - 1 / self.rf) * 100))
                if v < cutoff:
                    decision = STOP
        return decision

    def on_trial_complete(self, trial_id: str, result: dict | None) -> None:
        pass


class MedianStoppingRule:
    """Stop a trial whose running-average metric falls below the median of
    other trials' averages at the same step (ref:
    median_stopping_rule.py:18)."""

    def __init__(self, metric: str, mode: str = "max",
                 time_attr: str = "training_iteration",
                 grace_period: int = 1, min_samples_required: int = 3):
        assert mode in ("max", "min")
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._history: dict[str, list[float]] = collections.defaultdict(list)

    def _val(self, result: dict) -> float:
        v = float(result[self.metric])
        return v if self.mode == "max" else -v

    def on_result(self, trial_id: str, result: dict) -> str:
        if self.metric not in result or self.time_attr not in result:
            return CONTINUE
        t = int(result[self.time_attr])
        self._history[trial_id].append(self._val(result))
        if t < self.grace_period:
            return CONTINUE
        others = [
            sum(h) / len(h)
            for tid, h in self._history.items()
            if tid != trial_id and h
        ]
        if len(others) < self.min_samples:
            return CONTINUE
        import statistics

        mine = self._history[trial_id]
        my_avg = sum(mine) / len(mine)
        return STOP if my_avg < statistics.median(others) else CONTINUE

    def on_trial_complete(self, trial_id: str, result: dict | None) -> None:
        self._history.pop(trial_id, None)


EXPLOIT = "EXPLOIT"


class PopulationBasedTraining:
    """PBT (ref: tune/schedulers/pbt.py PopulationBasedTraining): at every
    ``perturbation_interval`` (in ``time_attr`` units), a trial in the
    bottom quantile EXPLOITS — the controller clones a top-quantile
    trial's checkpoint and config — and EXPLORES: each mutable
    hyperparameter is resampled (prob ``resample_probability``) or
    perturbed by x1.2 / x0.8. The controller executes the clone+restart;
    this object only decides and mutates."""

    def __init__(self, *, metric: str, mode: str = "max",
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_mutations: dict | None = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25, seed: int = 0):
        assert mode in ("max", "min")
        assert 0 < quantile_fraction <= 0.5
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = dict(hyperparam_mutations or {})
        self.quantile = quantile_fraction
        self.resample_prob = resample_probability
        import numpy as _np
        import random as _random

        self._rng = _np.random.default_rng(seed)
        self._pyrng = _random.Random(seed)  # tune samplers take random.Random
        self.scores: dict[str, float] = {}  # trial_id -> latest score
        self._last_perturb: dict[str, int] = {}
        self.num_exploits = 0

    def _val(self, result: dict) -> float:
        v = float(result[self.metric])
        return v if self.mode == "max" else -v

    def _quantiles(self):
        ranked = sorted(self.scores, key=self.scores.get)
        n = max(1, int(len(ranked) * self.quantile))
        if len(ranked) < 2 * n:
            return [], []
        return ranked[:n], ranked[-n:]  # (bottom, top)

    def on_result(self, trial_id: str, result: dict) -> str:
        if self.metric not in result or self.time_attr not in result:
            return CONTINUE
        self.scores[trial_id] = self._val(result)
        t = int(result[self.time_attr])
        if t - self._last_perturb.get(trial_id, 0) < self.interval:
            return CONTINUE
        self._last_perturb[trial_id] = t
        bottom, top = self._quantiles()
        if trial_id in bottom and top:
            return EXPLOIT
        return CONTINUE

    def pick_donor(self, exclude: str) -> str | None:
        """A random top-quantile trial to clone from."""
        _, top = self._quantiles()
        top = [t for t in top if t != exclude]
        if not top:
            return None
        return top[int(self._rng.integers(0, len(top)))]

    def explore(self, config: dict) -> dict:
        """Mutate the donor's config (ref: pbt.py _explore)."""
        out = dict(config)
        for key, spec in self.mutations.items():
            if self._rng.random() < self.resample_prob or key not in out:
                if callable(spec):
                    out[key] = spec()
                elif hasattr(spec, "sample"):
                    out[key] = spec.sample(self._pyrng)
                else:  # explicit list of values
                    out[key] = spec[int(self._rng.integers(0, len(spec)))]
            else:
                factor = 1.2 if self._rng.random() < 0.5 else 0.8
                if isinstance(out[key], (int, float)):
                    out[key] = type(out[key])(out[key] * factor)
        return out

    def on_trial_complete(self, trial_id: str, result: dict | None) -> None:
        # keep the score: a finished top-quantile trial remains a valid
        # donor (its checkpoint exists) for still-running stragglers
        pass
