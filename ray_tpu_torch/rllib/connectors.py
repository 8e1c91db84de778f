"""ConnectorV2: composable transform pipelines between env, module, and
learner.

A copy of ``ray_tpu/rllib/connectors.py`` (numpy only; the port imports
nothing of ``ray_tpu``), itself the counterpart of the reference connector
layer (ref: rllib/connectors/connector_v2.py:35 ConnectorV2,
connector_pipeline_v2.py:18 ConnectorPipelineV2, and the env_to_module /
module_to_env / learner default pipelines): small pure callables
``(batch, ctx) -> batch`` that own optional state, composed into mutable
pipelines with insert/remove surgery. Batches are flat numpy dicts /
arrays, the shapes the sample and update functions take.

Stateful connectors (NormalizeObservations) expose get/set/merge state so
an algorithm can aggregate running statistics across env runners each
iteration and re-broadcast (ref: env_runner_group sync of connector
states).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np


@dataclass
class ConnectorCtx:
    """Call-site context (ref: ConnectorV2's rl_module/explore kwargs)."""

    phase: str = "env_to_module"  # or "module_to_env" / "learner"
    num_envs: int = 1
    extra: dict = field(default_factory=dict)


class ConnectorV2:
    """One transform stage. Subclasses override __call__; name defaults to
    the class name (pipeline surgery addresses stages by name)."""

    @property
    def name(self) -> str:
        return type(self).__name__

    def __call__(self, batch: Any, ctx: ConnectorCtx) -> Any:
        raise NotImplementedError

    # -- optional state (running statistics etc.) ------------------------
    def get_state(self) -> dict:
        return {}

    def set_state(self, state: dict) -> None:
        pass

    @staticmethod
    def merge_states(states: list[dict]) -> dict:
        return states[0] if states else {}


class ConnectorPipelineV2(ConnectorV2):
    """Ordered composition with list surgery (ref:
    connector_pipeline_v2.py insert_before/insert_after/prepend/append/
    remove)."""

    def __init__(self, *connectors: ConnectorV2):
        self.connectors: list[ConnectorV2] = list(connectors)

    def __call__(self, batch, ctx):
        for c in self.connectors:
            batch = c(batch, ctx)
        return batch

    def _index_of(self, name_or_cls) -> int:
        key = name_or_cls if isinstance(name_or_cls, str) \
            else name_or_cls.__name__
        for i, c in enumerate(self.connectors):
            if c.name == key:
                return i
        raise ValueError(f"no connector named {key!r} in pipeline")

    def prepend(self, connector: ConnectorV2) -> "ConnectorPipelineV2":
        self.connectors.insert(0, connector)
        return self

    def append(self, connector: ConnectorV2) -> "ConnectorPipelineV2":
        self.connectors.append(connector)
        return self

    def insert_before(self, name_or_cls, connector) -> "ConnectorPipelineV2":
        self.connectors.insert(self._index_of(name_or_cls), connector)
        return self

    def insert_after(self, name_or_cls, connector) -> "ConnectorPipelineV2":
        self.connectors.insert(self._index_of(name_or_cls) + 1, connector)
        return self

    def remove(self, name_or_cls) -> "ConnectorPipelineV2":
        del self.connectors[self._index_of(name_or_cls)]
        return self

    def __len__(self):
        return len(self.connectors)

    def __getitem__(self, i):
        return self.connectors[i]

    # state is keyed by stage name; duplicate names share state slots in
    # registration order
    def get_state(self) -> dict:
        return {f"{i}:{c.name}": c.get_state()
                for i, c in enumerate(self.connectors)}

    def set_state(self, state: dict) -> None:
        for i, c in enumerate(self.connectors):
            s = state.get(f"{i}:{c.name}")
            if s:
                c.set_state(s)

    def merge_states(self, states: list[dict]) -> dict:
        out = {}
        for i, c in enumerate(self.connectors):
            key = f"{i}:{c.name}"
            per = [s[key] for s in states if s.get(key)]
            if per:
                out[key] = type(c).merge_states(per)
        return out


# -------------------------------------------------------- env -> module
class FlattenObservations(ConnectorV2):
    """[N, *obs_shape] -> [N, prod(obs_shape)] float array."""

    def __call__(self, batch, ctx):
        obs = np.asarray(batch)
        return obs.reshape(obs.shape[0], -1)


class CastObservations(ConnectorV2):
    def __init__(self, dtype=np.float32):
        self.dtype = np.dtype(dtype)

    def __call__(self, batch, ctx):
        return np.asarray(batch, dtype=self.dtype)


def _welford_merge(a: tuple, b: tuple) -> tuple:
    """Combine two (count, mean, M2) accumulators exactly (Chan et al.)."""
    (ca, ma, m2a), (cb, mb, m2b) = a, b
    if ca == 0:
        return b
    if cb == 0:
        return a
    tot = ca + cb
    d = mb - ma
    return (tot, ma + d * (cb / tot), m2a + m2b + d * d * (ca * cb / tot))


class NormalizeObservations(ConnectorV2):
    """Running mean/std normalization (ref: the MeanStdFilter connector
    role). Keeps a BASE accumulator (last broadcast fleet-wide state) and
    a local DELTA since that broadcast; cross-runner merges combine the
    shared base once plus every runner's delta — exact parallel variance
    (Chan et al.), no double-counting of shared history across sync
    rounds."""

    def __init__(self, eps: float = 1e-8, clip: float = 10.0,
                 update: bool = True):
        self.eps = eps
        self.clip = clip
        self.update = update
        zero = (0.0, None, None)  # (count, mean, m2); arrays lazily sized
        self._base: tuple = zero
        self._delta: tuple = zero

    @staticmethod
    def _mat(state: tuple, dim: int) -> tuple:
        c, m, m2 = state
        if m is None:
            return (c, np.zeros(dim), np.zeros(dim))
        return state

    def _combined(self, dim: int) -> tuple:
        return _welford_merge(self._mat(self._base, dim),
                              self._mat(self._delta, dim))

    def __call__(self, batch, ctx):
        obs = np.asarray(batch, dtype=np.float64)
        flat = obs.reshape(obs.shape[0], -1)
        dim = flat.shape[1]
        if self.update:
            n = flat.shape[0]
            bmean = flat.mean(axis=0)
            bm2 = ((flat - bmean) ** 2).sum(axis=0)
            self._delta = _welford_merge(
                self._mat(self._delta, dim), (float(n), bmean, bm2))
        count, mean, m2 = self._combined(dim)
        if count < 2:
            return np.asarray(batch, dtype=np.float32)
        std = np.sqrt(m2 / count + self.eps)
        out = (flat - mean) / std
        return np.clip(out, -self.clip, self.clip).astype(
            np.float32).reshape(obs.shape)

    def get_state(self) -> dict:
        c, m, m2 = self._delta
        state: dict = {}
        if m is not None:
            state["delta"] = {"count": c, "mean": m, "m2": m2}
        bc, bm, bm2 = self._base
        if bm is not None:
            state["base"] = {"count": bc, "mean": bm, "m2": bm2}
        return state

    def set_state(self, state: dict) -> None:
        """Adopt a merged fleet-wide state as the new base; local delta
        restarts from zero (its samples are inside the merge)."""
        base = state.get("base") or state.get("delta")
        if base:
            self._base = (float(base["count"]), np.asarray(base["mean"]),
                          np.asarray(base["m2"]))
            self._delta = (0.0, None, None)

    @staticmethod
    def merge_states(states: list[dict]) -> dict:
        """base (shared; counted once) ⊕ every runner's delta."""
        states = [s for s in states if s]
        if not states:
            return {}
        acc = (0.0, None, None)

        def tup(d):
            return (float(d["count"]), np.asarray(d["mean"]),
                    np.asarray(d["m2"]))

        bases = [s["base"] for s in states if "base" in s]
        if bases:
            acc = tup(bases[0])  # identical across runners post-broadcast
        for s in states:
            if "delta" in s:
                d = tup(s["delta"])
                acc = _welford_merge(acc, d) if acc[1] is not None else d
        if acc[1] is None:
            return {}
        return {"base": {"count": acc[0], "mean": acc[1], "m2": acc[2]}}


# -------------------------------------------------------- module -> env
class ClipActions(ConnectorV2):
    """Clip continuous actions to the env's bounds; discrete passes
    through (ref: module_to_env clip-by-space)."""

    def __init__(self, low=None, high=None):
        self.low = low
        self.high = high

    def __call__(self, batch, ctx):
        if self.low is None and self.high is None:
            return batch
        return np.clip(np.asarray(batch), self.low, self.high)


# ------------------------------------------------------------- learner
class NormalizeAdvantages(ConnectorV2):
    """Standardize batch["advantages"] (ref: the learner pipeline's
    GeneralAdvantageEstimation postprocessing)."""

    def __call__(self, batch, ctx):
        adv = np.asarray(batch["advantages"], dtype=np.float32)
        batch = dict(batch)
        batch["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
        return batch


class LambdaConnector(ConnectorV2):
    """Inline connector from a plain function (handy in configs/tests)."""

    def __init__(self, fn: Callable, name: str = "LambdaConnector"):
        self._fn = fn
        self._name = name

    @property
    def name(self) -> str:
        return self._name

    def __call__(self, batch, ctx):
        return self._fn(batch, ctx)


# ------------------------------------------------------------- defaults
def default_env_to_module() -> ConnectorPipelineV2:
    """Flatten + cast; mirror of the reference's default env-to-module
    stack (add NormalizeObservations() for MeanStdFilter behavior)."""
    return ConnectorPipelineV2(FlattenObservations(), CastObservations())


def default_module_to_env() -> ConnectorPipelineV2:
    return ConnectorPipelineV2(ClipActions())


def default_learner_pipeline() -> ConnectorPipelineV2:
    return ConnectorPipelineV2(NormalizeAdvantages())
