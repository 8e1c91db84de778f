"""The environments the RL stack steps: the port's own CartPole-v1 and a
synchronous vector env.

Counterpart of what ``ray_tpu/rllib`` takes from gymnasium
(``gym.make``, ``gym.vector.SyncVectorEnv``; ``env_runner.py:19-24``,
``offline.py:234-240``). ``"CartPole-v1"`` always resolves to
``CartPoleEnv`` below, a copy of gymnasium 1.x's
(``envs/classic_control/cartpole.py``) under its 500-step ``TimeLimit``:
the same float64 dynamics, float32 observations and reset draw from
``Generator(PCG64(SeedSequence(seed)))``, so a seeded run gives gymnasium's
observations bit for bit. Any other id goes to ``gymnasium.make``, which
must then be installed. The env stays on the host; only the policy runs on
the device.
"""
from __future__ import annotations

import math

import numpy as np


class Discrete:
    """The ``n`` of a discrete action space (``gymnasium.spaces.Discrete``)."""

    def __init__(self, n: int):
        self.n = int(n)


class Box:
    """The ``shape`` and ``dtype`` of a box observation space."""

    def __init__(self, shape: tuple, dtype=np.float32):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)


class CartPoleEnv:
    """gymnasium's ``CartPole-v1``: cart-pole dynamics by the Euler rule,
    terminated when |x| > 2.4 or |theta| > 12 degrees, truncated after
    ``max_episode_steps`` steps; reward 1 per step."""

    gravity = 9.8
    masscart = 1.0
    masspole = 0.1
    total_mass = masspole + masscart
    length = 0.5  # half the pole's length
    polemass_length = masspole * length
    force_mag = 10.0
    tau = 0.02
    theta_threshold_radians = 12 * 2 * math.pi / 360
    x_threshold = 2.4

    def __init__(self, max_episode_steps: int = 500):
        self.max_episode_steps = max_episode_steps
        self.action_space = Discrete(2)
        self.observation_space = Box((4,), np.float32)
        self.np_random: np.random.Generator | None = None
        self.state: np.ndarray | None = None
        self._steps_beyond_terminated = None
        self._elapsed_steps = None

    def reset(self, *, seed: int | None = None, options: dict | None = None):
        if seed is not None or self.np_random is None:
            self.np_random = np.random.Generator(
                np.random.PCG64(np.random.SeedSequence(seed)))
        self.state = self.np_random.uniform(low=-0.05, high=0.05, size=(4,))
        self._steps_beyond_terminated = None
        self._elapsed_steps = 0
        return np.array(self.state, dtype=np.float32), {}

    def step(self, action):
        if self._elapsed_steps is None:
            raise RuntimeError("call reset before step")
        if int(action) not in (0, 1):
            raise ValueError(f"{action!r} is not an action of Discrete(2)")
        # the same numpy float64 scalar arithmetic as gymnasium's, in the
        # same order, so the results agree to the last bit
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta = np.cos(theta)
        sintheta = np.sin(theta)
        temp = (force + self.polemass_length * np.square(theta_dot) * sintheta
                ) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length
            * (4.0 / 3.0 - self.masspole * np.square(costheta) / self.total_mass))
        xacc = temp - self.polemass_length * thetaacc * costheta / self.total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array((x, x_dot, theta, theta_dot), dtype=np.float64)
        terminated = bool(x < -self.x_threshold or x > self.x_threshold
                          or theta < -self.theta_threshold_radians
                          or theta > self.theta_threshold_radians)
        if not terminated:
            reward = 1.0
        elif self._steps_beyond_terminated is None:
            self._steps_beyond_terminated = 0
            reward = 1.0
        else:
            self._steps_beyond_terminated += 1
            reward = 0.0
        self._elapsed_steps += 1
        truncated = self._elapsed_steps >= self.max_episode_steps
        return np.array(self.state, dtype=np.float32), reward, terminated, truncated, {}


def make(env_id: str, **env_config):
    """One env: ``"CartPole-v1"`` is the port's copy; any other id is
    ``gymnasium.make(env_id, **env_config)``."""
    if env_id == "CartPole-v1":
        return CartPoleEnv(**env_config)
    try:
        import gymnasium
    except ImportError as e:
        raise ImportError(
            f"env {env_id!r} needs gymnasium, which is not installed; the port "
            "carries only 'CartPole-v1'") from e
    return gymnasium.make(env_id, **env_config)


class SyncVectorEnv:
    """Steps ``len(env_fns)`` envs one after another and batches their
    results, with gymnasium 1.x's default NEXT_STEP autoreset: the step
    after an env is done ignores its action, resets it and returns the reset
    observation with reward 0 and ``terminated = truncated = False``."""

    def __init__(self, env_fns):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space
        n = self.num_envs
        self._obs = np.zeros((n, *self.single_observation_space.shape),
                             dtype=self.single_observation_space.dtype)
        self._rewards = np.zeros(n, dtype=np.float64)
        self._terminations = np.zeros(n, dtype=np.bool_)
        self._truncations = np.zeros(n, dtype=np.bool_)
        self._autoreset = np.zeros(n, dtype=np.bool_)

    def reset(self, seed: int | None = None):
        """Reset every env; env i gets ``seed + i`` (no seed: each keeps
        its generator, or draws one from the OS on its first reset)."""
        seeds = [None] * self.num_envs if seed is None else [
            seed + i for i in range(self.num_envs)]
        self._terminations[:] = False
        self._truncations[:] = False
        self._autoreset[:] = False
        for i, (env, s) in enumerate(zip(self.envs, seeds)):
            self._obs[i], _ = env.reset(seed=s)
        return self._obs.copy(), {}

    def step(self, actions):
        actions = np.asarray(actions)
        for i, env in enumerate(self.envs):
            if self._autoreset[i]:
                self._obs[i], _ = env.reset()
                self._rewards[i] = 0.0
                self._terminations[i] = False
                self._truncations[i] = False
            else:
                (self._obs[i], self._rewards[i], self._terminations[i],
                 self._truncations[i], _) = env.step(actions[i])
        self._autoreset = np.logical_or(self._terminations, self._truncations)
        return (self._obs.copy(), self._rewards.copy(), self._terminations.copy(),
                self._truncations.copy(), {})


def make_vec(env_id: str, num_envs: int, env_config: dict | None = None) -> SyncVectorEnv:
    """``num_envs`` copies of ``make(env_id, **env_config)`` in one
    ``SyncVectorEnv``."""
    return SyncVectorEnv([lambda: make(env_id, **(env_config or {}))
                          for _ in range(num_envs)])
