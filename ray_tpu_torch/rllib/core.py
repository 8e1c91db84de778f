"""RLModule counterpart: policy, value and Q networks as ``nn.Module``s.

Counterpart of ``ray_tpu/rllib/core.py`` (``mlp_init``, ``mlp_apply``,
``policy_init``, ``policy_logits``, ``value_fn``, ``sample_action``). Where
JAX keeps a network as a pytree of ``{"w", "b"}`` layers, the port keeps an
``MLP`` of ``nn.Linear`` layers (tanh between them), and groups the heads of
one algorithm in an ``RLModule``: ``pi``/``vf`` for PPO, IMPALA and APPO,
``q`` for DQN, ``pi``/``q1``/``q2`` and a scalar ``log_alpha`` for SAC and
CQL. ``params_from_numpy`` and ``params_to_numpy`` carry JAX's trees (``w``
as ``[d_in, d_out]``) into modules and back. ``Adam`` is optax's ``adam`` on
``torch.optim.Adam``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.utils.device import resolve_device


class MLP(nn.Module):
    """Linear layers with tanh between them (``mlp_apply``)."""

    def __init__(self, sizes: list[int]):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.tanh(x)
        return x


class RLModule(nn.Module):
    """Named ``MLP`` heads (``module["pi"]``) and, for SAC and CQL, the
    learned temperature ``log_alpha``."""

    def __init__(self, heads: dict[str, MLP], log_alpha: float | None = None):
        super().__init__()
        self.heads = nn.ModuleDict(heads)
        if log_alpha is not None:
            self.log_alpha = nn.Parameter(torch.tensor(float(log_alpha)))

    def __getitem__(self, name: str) -> MLP:
        return self.heads[name]


def mlp_init(generator: torch.Generator, sizes: list[int]) -> MLP:
    """He-normal weights (``normal * sqrt(2 / d_in)``, drawn as
    ``[d_in, d_out]``) and zero biases, as JAX's ``mlp_init``; on the
    generator's device."""
    mlp = MLP(sizes).to(generator.device)
    with torch.no_grad():
        for layer in mlp.layers:
            d_out, d_in = layer.weight.shape
            w = torch.randn((d_in, d_out), generator=generator, device=generator.device)
            layer.weight.copy_((w * np.sqrt(2.0 / d_in)).T)
            layer.bias.zero_()
    return mlp


def seeded(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(int(seed))


def policy_init(generator: torch.Generator, obs_dim: int, n_actions: int,
                hidden: int = 64, device=None) -> RLModule:
    """Separate policy and value heads, drawn from ``generator`` and
    placed on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    return RLModule({"pi": mlp_init(generator, [obs_dim, hidden, hidden, n_actions]),
                     "vf": mlp_init(generator, [obs_dim, hidden, hidden, 1])}).to(dev)


def policy_logits(module: RLModule, obs):
    return module["pi"](obs)


def value_fn(module: RLModule, obs):
    return module["vf"](obs)[..., 0]


def action_logp_value(module: RLModule, obs, actions):
    """(logp of ``actions`` under the policy, value): ``sample_action``'s
    math on given actions."""
    logp = F.log_softmax(policy_logits(module, obs), dim=-1)
    return logp.gather(-1, actions[..., None])[..., 0], value_fn(module, obs)


@torch.no_grad()
def sample_action(module: RLModule, obs, generator: torch.Generator):
    """Categorical sample, its logp and the value in one call (the env
    runner's hot path); ``obs`` [N, obs_dim] on the module's device."""
    logits = policy_logits(module, obs)
    action = torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=generator)[:, 0]
    logp = F.log_softmax(logits, dim=-1).gather(-1, action[:, None])[:, 0]
    return action, logp, value_fn(module, obs)


# -------------------------------------------------------- JAX trees <-> modules
def params_from_numpy(tree: dict, device=None) -> RLModule:
    """An ``RLModule`` holding a JAX-layout tree's values: each key with a
    list of ``{"w": [d_in, d_out], "b": [d_out]}`` layers becomes an
    ``MLP`` head, a scalar ``log_alpha`` the temperature."""
    heads = {}
    for name, layers in tree.items():
        if name == "log_alpha":
            continue
        sizes = [np.shape(layers[0]["w"])[0]] + [np.shape(layer["w"])[1] for layer in layers]
        mlp = MLP(sizes)
        with torch.no_grad():
            for lin, layer in zip(mlp.layers, layers):
                lin.weight.copy_(torch.tensor(np.asarray(layer["w"], np.float32)).T)
                lin.bias.copy_(torch.tensor(np.asarray(layer["b"], np.float32)))
        heads[name] = mlp
    log_alpha = float(np.asarray(tree["log_alpha"])) if "log_alpha" in tree else None
    return RLModule(heads, log_alpha).to(resolve_device(device))


def params_to_numpy(module: RLModule) -> dict:
    """The JAX-layout tree of ``module``'s values, as host numpy."""
    tree = {name: [{"w": lin.weight.detach().cpu().numpy().T.copy(),
                    "b": lin.bias.detach().cpu().numpy().copy()} for lin in mlp.layers]
            for name, mlp in module.heads.items()}
    if hasattr(module, "log_alpha"):
        tree["log_alpha"] = module.log_alpha.detach().cpu().numpy().copy()
    return tree


# ------------------------------------------------------------------- optimizer
class Adam:
    """``optax.adam(lr)`` on ``torch.optim.Adam`` (b1 0.9, b2 0.999, eps
    1e-8: optax's defaults, and torch's). ``init`` builds the optimizer over
    a module's parameters with its state in place, as optax's ``init`` gives
    zero moments and a zero count before any update: a learner that never
    steps still holds moments to average."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, module: nn.Module) -> torch.optim.Adam:
        opt = torch.optim.Adam(module.parameters(), lr=self.lr, betas=(0.9, 0.999), eps=1e-8)
        for p in module.parameters():
            opt.state[p] = {"step": torch.tensor(0.0),
                            "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                            "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}
        return opt


def apply(opt: torch.optim.Optimizer, loss) -> None:
    """One optimizer step on ``loss``'s gradients."""
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
