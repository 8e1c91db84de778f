"""The port's CartPole-v1 and vector env (``ray_tpu_torch.rllib.envs``)
against gymnasium's, bit for bit.

``gymnasium.vector.SyncVectorEnv`` over ``gym.make("CartPole-v1")`` is what
the JAX package's runners step. Both are reset with one seed and fed the
same actions: env 0 by a balancing rule (so episodes reach the 500-step
truncation), the others at random (so NEXT_STEP autoresets come often).
Observations must be equal bit for bit, and rewards, ``terminated`` and
``truncated`` equal.
"""
import sys

import gymnasium as gym
import numpy as np
import pytest

from ray_tpu_torch.rllib import envs

N_ENVS = 4
STEPS = 1600


def balance(obs):
    """Push the cart toward the side the pole leans to."""
    return int(obs[2] + 0.5 * obs[3] > 0)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_vector_cartpole_equals_gymnasium(seed):
    theirs = gym.vector.SyncVectorEnv([lambda: gym.make("CartPole-v1")
                                       for _ in range(N_ENVS)])
    ours = envs.make_vec("CartPole-v1", N_ENVS)
    want, _ = theirs.reset(seed=seed)
    got, _ = ours.reset(seed=seed)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    rng = np.random.default_rng(seed)
    truncations = resets = 0
    for t in range(STEPS):
        actions = rng.integers(0, 2, N_ENVS)
        actions[0] = balance(got[0])
        w_obs, w_rew, w_term, w_trunc, _ = theirs.step(actions)
        got, rew, term, trunc, _ = ours.step(actions)
        assert got.tobytes() == w_obs.tobytes(), t
        assert rew.dtype == w_rew.dtype and np.array_equal(rew, w_rew), t
        assert np.array_equal(term, w_term) and np.array_equal(trunc, w_trunc), t
        truncations += int(trunc.sum())
        resets += int((term | trunc).sum())
    assert truncations >= 1 and resets >= 50, (truncations, resets)
    assert ours.single_observation_space.shape == theirs.single_observation_space.shape
    assert ours.single_action_space.n == theirs.single_action_space.n


def test_single_env_equals_gymnasium_and_keeps_its_generator():
    """One env through reset(seed), steps to the end of an episode, and a
    reset without a seed, which continues the seeded generator."""
    theirs, ours = gym.make("CartPole-v1"), envs.make("CartPole-v1")
    for seed in (11, None, None):
        want, _ = theirs.reset(seed=seed)
        got, _ = ours.reset(seed=seed)
        assert got.tobytes() == want.tobytes()
        done = False
        while not done:
            a = balance(got) if seed else 0
            w = theirs.step(a)
            g = ours.step(a)
            assert g[0].tobytes() == w[0].tobytes() and g[1:4] == w[1:4]
            got, done = g[0], g[2] or g[3]


def test_other_ids_go_to_gymnasium(monkeypatch):
    env = envs.make("MountainCar-v0")
    assert type(env.unwrapped).__name__ == "MountainCarEnv"
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    with pytest.raises(ImportError, match="needs gymnasium"):
        envs.make("MountainCar-v0")
    assert isinstance(envs.make("CartPole-v1"), envs.CartPoleEnv)


def test_step_checks():
    env = envs.make("CartPole-v1")
    with pytest.raises(RuntimeError, match="reset"):
        env.step(0)
    env.reset(seed=0)
    with pytest.raises(ValueError):
        env.step(2)
