"""ChaosPlan: the declarative, seeded fault schedule.

A plan is JSON so it can be checked into a repo, attached to a bug
report, and replayed byte-for-byte (``RT_CHAOS_ENABLED=1
RT_CHAOS_PLAN=plan.json``):

    {
      "seed": 7,
      "rules": [
        {"point": "worker.exec", "action": "kill", "every": 40,
         "max_fires": 3},
        {"point": "rpc.send", "match": {"method": "kv_put"},
         "action": "delay", "delay_ms": 25, "prob": 0.1},
        {"point": "ring.push", "action": "drop", "after": 100,
         "every": 50}
      ],
      "native": {"ring_partial_every": 3}
    }

Rule fields:

- ``point``: fault-point name, exact or an ``fnmatch`` glob
  (``"gcs.*"``). See README § Fault injection for the point table.
- ``match``: optional ``{ctx_key: value}`` equality filter against the
  keyword context the call site passes to ``chaos.point`` — e.g. fire
  only on a named task or a specific RPC method.
- ``action``: ``delay`` (sleep ``delay_ms``) / ``drop`` / ``duplicate``
  / ``error`` (raise ChaosError) / ``corrupt`` (flip one seeded byte of
  the site's payload) / ``kill`` (SIGKILL this process).
- timing: ``after`` (skip the first N eligible calls), ``every`` (then
  fire on every Nth), ``prob`` (seeded coin flip per eligible call),
  ``max_fires`` (stop after N fires). All optional; a rule with none of
  them fires on every eligible call.
- ``cluster_once``: fire at most once ACROSS the whole cluster run, not
  per process. Controllers are per-process, so without this a "lose one
  shard" kill rule would strike every fresh worker the recovery path
  retries onto, defeating the recovery it means to test. Implemented as
  an O_EXCL sentinel file in the shared chaos log dir, namespaced by
  the per-run RT_CHAOS_RUN_ID (stamped at arm time, inherited by every
  child) so a reused log dir re-arms the rule each run; falls back to
  per-process once when no log dir is configured.

Determinism: rules are evaluated in plan order, each owns a
``random.Random`` seeded from ``(plan.seed, rule index)``, and every
counter advances only on rule-eligible calls — the same seed over the
same call sequence makes the same decisions.
"""

from __future__ import annotations

import dataclasses
import json

ACTIONS = ("delay", "drop", "duplicate", "error", "corrupt", "kill")
_NATIVE_ARMS = ("ring_partial_every", "ring_timeout_every",
                "store_seal_fail_every")


@dataclasses.dataclass
class ChaosRule:
    point: str
    action: str
    match: dict = dataclasses.field(default_factory=dict)
    delay_ms: float = 10.0
    prob: float | None = None
    every: int = 0
    after: int = 0
    max_fires: int = 0  # 0 = unlimited
    cluster_once: bool = False  # at most one fire across ALL processes

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(
                f"unknown chaos action {self.action!r} (choose from "
                f"{', '.join(ACTIONS)})")
        if self.prob is not None and not (0.0 <= self.prob <= 1.0):
            raise ValueError(f"prob must be in [0, 1], got {self.prob}")
        if self.every < 0 or self.after < 0 or self.max_fires < 0:
            raise ValueError("every/after/max_fires must be >= 0")

    def as_dict(self) -> dict:
        d = {"point": self.point, "action": self.action}
        if self.match:
            d["match"] = dict(self.match)
        if self.action == "delay":
            d["delay_ms"] = self.delay_ms
        for k in ("prob", "every", "after", "max_fires", "cluster_once"):
            v = getattr(self, k)
            if v:
                d[k] = v
        return d


@dataclasses.dataclass
class ChaosPlan:
    seed: int = 0
    rules: list[ChaosRule] = dataclasses.field(default_factory=list)
    #: native fault arms applied at enable() (see chaos.arm_native)
    native: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.rules = [r if isinstance(r, ChaosRule) else ChaosRule(**r)
                      for r in self.rules]
        unknown = set(self.native) - set(_NATIVE_ARMS)
        if unknown:
            raise ValueError(
                f"unknown native arms {sorted(unknown)} (choose from "
                f"{', '.join(_NATIVE_ARMS)})")

    @classmethod
    def from_json(cls, text: str) -> "ChaosPlan":
        raw = json.loads(text)
        return cls(seed=int(raw.get("seed", 0)), rules=raw.get("rules", []),
                   native=raw.get("native", {}))

    @classmethod
    def load(cls, path: str) -> "ChaosPlan":
        """Load a plan file; ``path`` may also be an inline JSON object
        (starts with '{') so RT_CHAOS_PLAN works without a file."""
        if path.lstrip().startswith("{"):
            return cls.from_json(path)
        with open(path) as f:
            return cls.from_json(f.read())

    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "rules": [r.as_dict() for r in self.rules],
            **({"native": dict(self.native)} if self.native else {}),
        }, indent=2)
