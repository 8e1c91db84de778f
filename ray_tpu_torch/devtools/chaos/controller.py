"""ChaosController: deterministic rule evaluation + the fault-event log.

``fire()`` is the single funnel every armed fault point goes through:
rule matching, seeded timing decisions, and event logging happen under
one lock (points fire from ring-pump threads, executor threads, and
event loops concurrently); the SIDE EFFECTS — sleeping, raising,
SIGKILL — happen after the lock is released so one delayed point never
serializes the rest of the process.

Every fired fault is (1) appended to ``self.events``, (2) appended as a
JSON line to the per-process log file (fsync'd before a ``kill`` so the
event that explains the death survives it), and (3) stamped into the
flight recorder (stage ``chaos``) so chrome-trace/postmortem reads show
exactly where the schedule struck. ``signature()`` is the
determinism-checkable projection: same seed + same call sequence ⇒
identical signature.
"""

from __future__ import annotations

import json
import os
import random
import signal
import threading
import time
from fnmatch import fnmatchcase

from ray_tpu_torch.devtools.chaos.plan import ChaosPlan

# action codes for recorder slots (utils/recorder.py stage CHAOS args)
ACTION_CODES = {"delay": 1, "drop": 2, "duplicate": 3, "error": 4,
                "corrupt": 5, "kill": 6}


class ChaosError(Exception):
    """The injected failure of an ``error`` action. Deliberately a plain
    Exception: it must travel the same handler paths a real fault would."""


class Act:
    """What a fault point's call site must do. ``kind`` is the action
    name; ``payload`` carries the mangled bytes for ``corrupt``."""

    __slots__ = ("kind", "payload")

    def __init__(self, kind: str, payload: bytes | None = None):
        self.kind = kind
        self.payload = payload

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Act({self.kind!r})"


class _CompiledRule:
    __slots__ = ("rule", "index", "rng", "seen", "fired", "is_glob")

    def __init__(self, rule, index: int, seed: int):
        self.rule = rule
        self.index = index
        # per-rule stream: rule order in one plan never perturbs another
        # rule's coin flips
        self.rng = random.Random((seed << 20) ^ (index + 1))
        self.seen = 0
        self.fired = 0
        self.is_glob = any(c in rule.point for c in "*?[")


class ChaosController:
    def __init__(self, plan: ChaosPlan, log_path: str | None = None):
        self.plan = plan
        self.events: list[dict] = []
        self._lock = threading.Lock()
        self._seq = 0
        self._rules = [_CompiledRule(r, i, plan.seed)
                       for i, r in enumerate(plan.rules)]
        # armed-but-idle fast path: a point no rule could ever match
        # returns before taking the lock (immutable structures, so the
        # lock-free read is safe) — hot paths stay sub-µs while armed
        self._exact = frozenset(cr.rule.point for cr in self._rules
                                if not cr.is_glob)
        self._globs = tuple(cr.rule.point for cr in self._rules
                            if cr.is_glob)
        self._log_path = log_path
        self._log_f = open(log_path, "a", buffering=1) if log_path else None

    # ------------------------------------------------------------ evaluation
    def fire(self, name: str, payload: bytes | None, ctx: dict):
        """Evaluate ``name`` against the plan; returns the Act for the
        call site (or None). First matching-and-firing rule wins."""
        if name not in self._exact and not any(
                fnmatchcase(name, g) for g in self._globs):
            return None
        decided = None
        with self._lock:
            for cr in self._rules:
                r = cr.rule
                if cr.is_glob:
                    if not fnmatchcase(name, r.point):
                        continue
                elif r.point != name:
                    continue
                if r.match and any(ctx.get(k) != v
                                   for k, v in r.match.items()):
                    continue
                cr.seen += 1
                if cr.seen <= r.after:
                    continue
                if r.max_fires and cr.fired >= r.max_fires:
                    continue
                if r.every and (cr.seen - r.after) % r.every != 0:
                    continue
                if r.prob is not None and cr.rng.random() >= r.prob:
                    continue
                if r.cluster_once and not self._claim_cluster_once(cr):
                    continue  # another process (or a past fire) owns it
                cr.fired += 1
                self._log_locked(name, r.action, cr.index, ctx)
                # every rng draw stays under the lock so concurrent
                # points can never reorder a rule's seeded stream
                flip_at = (cr.rng.randrange(len(payload))
                           if r.action == "corrupt" and payload else -1)
                decided = (cr, flip_at)
                break
        if decided is None:
            return None
        cr, flip_at = decided
        return self._execute(name, cr, payload, flip_at)

    def _claim_cluster_once(self, cr: _CompiledRule) -> bool:
        """Atomically claim a cluster_once rule's single fire: an O_EXCL
        sentinel in the SHARED chaos log dir (every armed process points
        at the same dir via RT_CHAOS_LOG_DIR), named by the per-run id
        (RT_CHAOS_RUN_ID, stamped at arm time and inherited by every
        child) plus rule index — so log dirs REUSED across runs re-arm
        the rule each run instead of staying disarmed by a stale
        sentinel. Controllers are per-process; without the shared claim
        a shard-loss kill rule would strike every fresh worker a
        recovery retry lands on. No log dir configured -> degrade to
        per-process once (this controller's own fired counter)."""
        if self._log_path is None:
            return cr.fired == 0
        run_id = os.environ.get("RT_CHAOS_RUN_ID", "")
        sentinel = os.path.join(
            os.path.dirname(self._log_path),
            f"once-{run_id}-{cr.index}.fired" if run_id
            else f"once-{cr.index}.fired")
        try:
            os.close(os.open(sentinel, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
            return True
        except FileExistsError:
            return False
        except OSError:
            return cr.fired == 0  # unwritable dir: per-process fallback

    def _execute(self, name: str, cr: _CompiledRule,
                 payload: bytes | None, flip_at: int):
        """Side effects, outside the lock."""
        r = cr.rule
        act = r.action
        if act == "delay":
            time.sleep(r.delay_ms / 1e3)
            return None
        if act == "error":
            raise ChaosError(
                f"chaos: injected error at {name} (rule {cr.index})")
        if act == "kill":
            self.close()  # flush: the kill event must survive the kill
            os.kill(os.getpid(), signal.SIGKILL)
            return None  # pragma: no cover - unreachable
        if act == "corrupt":
            if flip_at < 0:
                return Act("corrupt", None)  # no payload: log-only
            mangled = bytearray(payload)
            mangled[flip_at] ^= 0xFF
            return Act("corrupt", bytes(mangled))
        return Act(act)  # drop / duplicate

    # --------------------------------------------------------------- logging
    def _log_locked(self, name: str, action: str, rule_index: int,
                    ctx: dict) -> dict:
        self._seq += 1
        ev = {
            "n": self._seq,
            "pid": os.getpid(),
            "point": name,
            "rule": rule_index,
            "action": action,
            "ts": time.time(),
            "ctx": {k: v for k, v in ctx.items()
                    if isinstance(v, (str, int, float, bool))},
        }
        self.events.append(ev)
        if self._log_f is not None:
            try:
                self._log_f.write(json.dumps(ev) + "\n")
            except (OSError, ValueError):
                # full disk, or close() swapped the file between the None
                # check and the write: chaos must not become a new fault
                pass
        self._record(name, action, rule_index)
        return ev

    def log_external(self, name: str, action: str, ctx: dict) -> None:
        """Log a fault executed outside rule evaluation (killers)."""
        with self._lock:
            self._log_locked(name, action, -1, ctx)

    def _record(self, name: str, action: str, rule_index: int) -> None:
        """Stamp the fired fault into the flight recorder: the 16-byte id
        slot carries the point name, args carry (rule, action, seq)."""
        from ray_tpu_torch.utils import recorder as _rec

        rec = _rec.get_recorder()
        if rec is not None:
            rec.record(name.encode()[:16].ljust(16, b"\0"), _rec.CHAOS,
                       a0=rule_index & 0xFFFFFFFF,
                       a1=ACTION_CODES.get(action, 0), a2=self._seq)

    def signature(self) -> list[tuple]:
        """The deterministic projection of the fault log: (n, point,
        rule, action) per fired fault. Two runs of the same plan seed
        over the same workload must produce identical signatures."""
        with self._lock:
            return [(e["n"], e["point"], e["rule"], e["action"])
                    for e in self.events]

    def close(self) -> None:
        # swap under the lock so no _log_locked writer holds a reference
        # to a file we are about to close (kill-action close() races
        # concurrent fault points on other threads)
        with self._lock:
            f, self._log_f = self._log_f, None
        if f is not None:
            try:
                f.flush()
                os.fsync(f.fileno())
                f.close()
            except (OSError, ValueError):
                pass
