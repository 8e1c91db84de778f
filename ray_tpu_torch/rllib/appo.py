"""APPO: IMPALA's sampling and V-trace correction with PPO's clipped
surrogate objective.

Counterpart of ``ray_tpu/rllib/appo.py`` (ref: rllib/algorithms/appo/
appo.py + appo_learner.py: "APPO is an IMPALA-variant that uses a PPO
surrogate loss on V-trace-corrected advantages"). The driver IS the IMPALA
driver; only the learner loss differs:

    ratio    = pi_target(a|s) / pi_behavior(a|s)
    L_pi     = -min(ratio * A_vtrace, clip(ratio, 1±eps) * A_vtrace)

so a runner's policy lag shows up twice, both times bounded: in the
V-trace rho/c truncation of the TARGETS and in the clipped ratio of the
SURROGATE.
"""
from __future__ import annotations

import torch

from ray_tpu_torch.rllib.core import Adam, apply
from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig, vtrace_terms
from ray_tpu_torch.rllib.learner import entropy


def make_appo_update(lr: float, gamma: float, vf_coeff: float,
                     entropy_coeff: float, rho_bar: float, c_bar: float,
                     clip: float):
    """(update, optimizer): ``update(module, opt, batch)`` takes one step in
    place and returns the loss as a 0-dim tensor."""

    def update(module, opt, batch):
        logp_all, target_logp, values, vs, adv = vtrace_terms(
            module, batch, gamma, rho_bar, c_bar)
        # PPO clipped surrogate on the V-trace advantages (appo_learner)
        ratio = torch.exp(target_logp - batch["logp"])
        surr = torch.minimum(ratio * adv, torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv)
        pi_loss = -surr.mean()
        vf_loss = 0.5 * ((values - vs) ** 2).mean()
        loss = pi_loss + vf_coeff * vf_loss - entropy_coeff * entropy(logp_all)
        apply(opt, loss)
        return loss.detach()

    return update, Adam(lr)


class APPOConfig(IMPALAConfig):
    """Builder config (ref: appo.py APPOConfig — an IMPALAConfig with the
    PPO clip parameter)."""

    def __init__(self):
        super().__init__()
        self.clip = 0.2

    def training(self, *, clip=None, **kw):
        if clip is not None:
            self.clip = clip
        super().training(**kw)
        return self

    def _build_update(self):
        return make_appo_update(
            self.lr, self.gamma, self.vf_coeff, self.entropy_coeff,
            self.rho_bar, self.c_bar, self.clip)

    def build(self) -> "APPO":
        if self.env_name is None:
            raise ValueError("APPOConfig.environment(...) is required")
        return APPO(self)


class APPO(IMPALA):
    """The IMPALA driver with the APPO learner update."""
