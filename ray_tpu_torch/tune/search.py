"""Search-space primitives + basic variant generation.

A copy of ``ray_tpu/tune/search.py``: pure Python over ``random``, so one
seed gives the JAX package's variants, in its order, and its TPE
suggestions. Counterpart of the reference search surface (ref:
python/ray/tune/search/sample.py uniform/loguniform/choice/randint,
search/basic_variant.py BasicVariantGenerator, search/grid_search).
Grid dimensions expand to a cross-product; sampling dimensions draw
num_samples independent variants — matching the reference's semantics
where num_samples multiplies the grid.
"""
from __future__ import annotations

import itertools
import random
from dataclasses import dataclass
from typing import Any, Callable


@dataclass
class _Sampler:
    fn: Callable[[random.Random], Any]
    repr_name: str
    kind: str = "custom"  # uniform/loguniform/randint/choice/quniform
    meta: dict | None = None  # kind-specific params (TPE models need them)

    def sample(self, rng: random.Random):
        return self.fn(rng)

    def __repr__(self):
        return self.repr_name


def uniform(low: float, high: float) -> _Sampler:
    return _Sampler(lambda rng: rng.uniform(low, high),
                    f"uniform({low}, {high})",
                    kind="uniform", meta={"low": low, "high": high})


def loguniform(low: float, high: float) -> _Sampler:
    import math

    lo, hi = math.log(low), math.log(high)
    return _Sampler(lambda rng: math.exp(rng.uniform(lo, hi)),
                    f"loguniform({low}, {high})",
                    kind="loguniform", meta={"low": low, "high": high})


def randint(low: int, high: int) -> _Sampler:
    return _Sampler(lambda rng: rng.randrange(low, high),
                    f"randint({low}, {high})",
                    kind="randint", meta={"low": low, "high": high})


def choice(options: list) -> _Sampler:
    opts = list(options)
    return _Sampler(lambda rng: rng.choice(opts), f"choice({opts})",
                    kind="choice", meta={"options": opts})


def quniform(low: float, high: float, q: float) -> _Sampler:
    return _Sampler(
        lambda rng: round(rng.uniform(low, high) / q) * q,
        f"quniform({low}, {high}, {q})",
        kind="quniform", meta={"low": low, "high": high, "q": q})


class grid_search(dict):
    """Marker: expand this dimension as a grid (ref: tune grid_search)."""

    def __init__(self, values: list):
        super().__init__(grid_search=list(values))

    @property
    def values(self):
        return self["grid_search"]


def generate_variants(param_space: dict, num_samples: int = 1,
                      seed: int | None = None) -> list[dict]:
    """Expand a param space into concrete trial configs
    (ref: basic_variant.py BasicVariantGenerator)."""
    rng = random.Random(seed)
    grid_keys: list[tuple[tuple, list]] = []
    _collect_grids(param_space, (), grid_keys)
    grid_axes = [vals for _, vals in grid_keys]
    combos = list(itertools.product(*grid_axes)) if grid_axes else [()]
    variants = []
    for _ in range(num_samples):
        for combo in combos:
            cfg = _materialize(param_space, rng)
            for (path, _), value in zip(grid_keys, combo):
                _set_path(cfg, path, value)
            variants.append(cfg)
    return variants


def _collect_grids(node, path, out):
    if isinstance(node, grid_search):
        out.append((path, node.values))
    elif isinstance(node, dict):
        for k, v in node.items():
            _collect_grids(v, path + (k,), out)


def _materialize(node, rng):
    if isinstance(node, grid_search):
        return None  # placeholder; overwritten by _set_path
    if isinstance(node, _Sampler):
        return node.sample(rng)
    if isinstance(node, dict):
        return {k: _materialize(v, rng) for k, v in node.items()}
    return node


def _set_path(cfg: dict, path: tuple, value):
    node = cfg
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value


# ------------------------------------------------------------------ searchers
class Searcher:
    """Sequential suggest/observe interface (ref: tune/search/searcher.py
    Searcher.suggest / on_trial_complete). Plugged into TuneController via
    TuneConfig(search_alg=...): trials are created on demand instead of
    expanded upfront, so later suggestions see earlier results."""

    def suggest(self, trial_id: str) -> dict | None:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str, metrics: dict | None) -> None:
        pass


class TPESearcher(Searcher):
    """Native Tree-structured Parzen Estimator (the role of the
    reference's pluggable HyperOpt/Optuna searchers, ref:
    tune/search/hyperopt/hyperopt_search.py — implemented here directly:
    split observations into good/bad by the gamma quantile, model each
    dimension with a Parzen (Gaussian-kernel) density per split, and pick
    the candidate maximizing l(x)/g(x)).

    Supports uniform / loguniform / quniform / randint / choice
    dimensions (nested dicts fine); unknown sampler kinds fall back to
    random draws for that dimension.
    """

    def __init__(self, space: dict, metric: str, mode: str = "max", *,
                 n_initial: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24, seed: int | None = None):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be min|max, got {mode!r}")
        self.space = space
        self.metric = metric
        self.mode = mode
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)
        self._dims: list[tuple[tuple, _Sampler]] = []
        _collect_samplers(space, (), self._dims)
        self._live: dict[str, dict] = {}   # trial_id -> flat values
        self._obs: list[tuple[dict, float]] = []  # (flat values, score)

    # ------------------------------------------------------------- suggest
    def suggest(self, trial_id: str) -> dict:
        import math

        flat: dict[tuple, Any] = {}
        use_model = len(self._obs) >= self.n_initial
        if use_model:
            good, bad = self._split()
        for path, dim in self._dims:
            if not use_model or dim.kind not in (
                    "uniform", "loguniform", "quniform", "randint", "choice"):
                flat[path] = dim.sample(self.rng)
                continue
            gvals = [o[path] for o, _ in good if path in o]
            bvals = [o[path] for o, _ in bad if path in o]
            if dim.kind == "choice":
                flat[path] = self._suggest_categorical(
                    dim.meta["options"], gvals, bvals)
            elif dim.kind == "randint":
                # bounded numeric, NOT categorical: materializing
                # range(lo, hi) would blow up on wide integer spaces
                # (seeds, buffer sizes) — model as a Parzen over the
                # continuous range and round
                lo, hi = dim.meta["low"], dim.meta["high"]
                x = self._suggest_parzen(
                    [float(v) for v in gvals], [float(v) for v in bvals],
                    float(lo), float(hi - 1))
                flat[path] = int(min(max(round(x), lo), hi - 1))
            else:
                lo, hi = dim.meta["low"], dim.meta["high"]
                logspace = dim.kind == "loguniform"
                xform = math.log if logspace else (lambda v: v)
                inv = math.exp if logspace else (lambda v: v)
                x = self._suggest_parzen(
                    [xform(v) for v in gvals], [xform(v) for v in bvals],
                    xform(lo), xform(hi))
                x = inv(x)
                if dim.kind == "quniform":
                    q = dim.meta["q"]
                    x = round(x / q) * q
                flat[path] = min(max(x, lo), hi)
        self._live[trial_id] = dict(flat)
        cfg = _materialize(self.space, self.rng)
        for path, v in flat.items():
            _set_path(cfg, path, v)
        return cfg

    def on_trial_complete(self, trial_id: str, metrics: dict | None) -> None:
        flat = self._live.pop(trial_id, None)
        if flat is None or not metrics or self.metric not in metrics:
            return
        score = float(metrics[self.metric])
        if self.mode == "min":
            score = -score
        self._obs.append((flat, score))

    # ------------------------------------------------------------ internals
    def _split(self):
        ranked = sorted(self._obs, key=lambda o: -o[1])
        n_good = max(1, int(round(self.gamma * len(ranked))))
        return ranked[:n_good], ranked[n_good:]

    def _suggest_categorical(self, options: list, gvals, bvals):
        # add-one smoothed category weights: p_good / p_bad odds
        def weights(vals):
            counts = {id_: 1.0 for id_ in range(len(options))}
            index = {repr(o): i for i, o in enumerate(options)}
            for v in vals:
                i = index.get(repr(v))
                if i is not None:
                    counts[i] += 1.0
            total = sum(counts.values())
            return [counts[i] / total for i in range(len(options))]

        wg, wb = weights(gvals), weights(bvals)
        odds = [g / b for g, b in zip(wg, wb)]
        # sample candidates from the good distribution, keep the best odds
        best, best_odds = None, -1.0
        for _ in range(self.n_candidates):
            i = self.rng.choices(range(len(options)), weights=wg)[0]
            if odds[i] > best_odds:
                best, best_odds = i, odds[i]
        return options[best]

    def _suggest_parzen(self, gvals, bvals, lo, hi):
        import math

        span = max(hi - lo, 1e-12)

        def kde(vals):
            # Parzen mixture: one Gaussian per observation + a uniform
            # prior component over the range (keeps densities positive)
            if not vals:
                return [(0.5 * (lo + hi), span)], 1.0 / max(len(vals) + 1, 1)
            bw = max(span * (len(vals) ** -0.2) * 0.5, 1e-9 * span)
            return [(v, bw) for v in vals], 1.0 / (len(vals) + 1)

        def density(mix, prior_w, x):
            comps, _ = mix, None
            p = prior_w / span  # uniform prior component
            if comps:
                w = (1.0 - prior_w) / len(comps)
                for mu, bw in comps:
                    z = (x - mu) / bw
                    p += w * math.exp(-0.5 * z * z) / (bw * 2.5066282746310002)
            return p

        gmix, gprior = kde(gvals)
        bmix, bprior = kde(bvals)
        best_x, best_score = None, -1.0
        for _ in range(self.n_candidates):
            # draw from the good mixture (or the prior when empty)
            if gvals and self.rng.random() > gprior:
                mu, bw = self.rng.choice(gmix)
                x = self.rng.gauss(mu, bw)
            else:
                x = self.rng.uniform(lo, hi)
            x = min(max(x, lo), hi)
            score = density(gmix, gprior, x) / max(
                density(bmix, bprior, x), 1e-12)
            if score > best_score:
                best_x, best_score = x, score
        return best_x


def _collect_samplers(node, path, out):
    if isinstance(node, _Sampler):
        out.append((path, node))
    elif isinstance(node, dict) and not isinstance(node, grid_search):
        for k, v in node.items():
            _collect_samplers(v, path + (k,), out)
