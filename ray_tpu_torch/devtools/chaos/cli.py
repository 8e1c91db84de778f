"""`python -m ray_tpu_torch chaos` — run workloads under a fault schedule.

    ray_tpu_torch chaos run plan.json -- python workload.py
    ray_tpu_torch chaos run --seed 9 plan.json -- python -m pytest tests/x.py
    ray_tpu_torch chaos validate plan.json
    ray_tpu_torch chaos events [--log-dir DIR]

(`run` flags go BEFORE the plan path: everything after it is the
workload's own argv.)

Counterpart of ``ray_tpu/devtools/chaos/cli.py``. ``run`` exports the
RT_CHAOS_* flags (picked up by every process the workload spawns — driver,
raylets, workers, GCS — via the serialized config), executes the command,
then prints a summary of every fault that fired across all of them from
the shared JSONL event log (:func:`read_events`: every armed process
appends the faults it fired to ``<log_dir>/chaos-<pid>.jsonl``). The
child's exit code is passed through, so a chaos run drops into CI
unchanged.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

from ray_tpu_torch.devtools.chaos.plan import ChaosPlan


def read_events(log_dir: str) -> list[dict]:
    """Merge every process's chaos JSONL under ``log_dir``, oldest first.
    Unreadable or torn lines are skipped (a SIGKILL mid-write must not
    sink the report)."""
    events: list[dict] = []
    try:
        names = sorted(os.listdir(log_dir))
    except OSError:
        return events
    for name in names:
        if not name.endswith(".jsonl"):
            continue
        try:
            with open(os.path.join(log_dir, name)) as f:
                for line in f:
                    try:
                        events.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue
        except OSError:
            continue
    events.sort(key=lambda e: (e.get("ts", 0), e.get("pid", 0),
                               e.get("n", 0)))
    return events


def add_chaos_parser(sub):
    p = sub.add_parser("chaos",
                       help="deterministic fault injection (devtools/chaos)")
    csub = p.add_subparsers(dest="chaos_cmd", required=True)

    runp = csub.add_parser("run", help="run a command under a chaos plan")
    runp.add_argument("--seed", type=int, default=None,
                      help="override the plan's seed")
    runp.add_argument("--log-dir", default=None,
                      help="fault-event log dir (default: fresh dir under "
                           "the session temp tree)")
    # flags must precede the plan: everything after it (REMAINDER) is the
    # workload's own argv, passed through untouched
    runp.add_argument("plan", help="path to a ChaosPlan JSON file")
    runp.add_argument("command", nargs="...",
                      help="workload, e.g. -- python script.py")

    vp = csub.add_parser("validate", help="parse + echo a compiled plan")
    vp.add_argument("plan")

    ep = csub.add_parser("events", help="print the merged fault-event log")
    ep.add_argument("--log-dir", default=None)
    return p


def cmd_chaos(args) -> int:
    from ray_tpu_torch.devtools import chaos

    if args.chaos_cmd == "validate":
        plan = ChaosPlan.load(args.plan)
        print(plan.to_json())
        print(f"ok: {len(plan.rules)} rule(s), seed={plan.seed}",
              file=sys.stderr)
        return 0

    if args.chaos_cmd == "events":
        log_dir = args.log_dir or chaos.default_log_dir()
        print(json.dumps(read_events(log_dir), indent=2))
        return 0

    # ------------------------------------------------------------------ run
    plan = ChaosPlan.load(args.plan)  # fail fast on a broken plan
    command = list(args.command)
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        print("chaos run needs a command, e.g. -- python workload.py",
              file=sys.stderr)
        return 2
    log_dir = args.log_dir
    if log_dir is None:
        import tempfile

        log_dir = tempfile.mkdtemp(prefix="rt_chaos_")
    os.makedirs(log_dir, exist_ok=True)
    env = dict(os.environ)
    env["RT_CHAOS_ENABLED"] = "1"
    # inline-JSON plans pass through verbatim; only real paths absolutize
    # (children may run from a different cwd)
    env["RT_CHAOS_PLAN"] = (args.plan if args.plan.lstrip().startswith("{")
                            else os.path.abspath(args.plan))
    env["RT_CHAOS_LOG_DIR"] = log_dir
    # fresh per-run id: cluster_once sentinels are namespaced by it, so
    # re-running against the SAME log dir re-arms those rules
    env["RT_CHAOS_RUN_ID"] = f"{os.getpid():x}-{int(time.time() * 1e3):x}"
    if args.seed is not None:
        env["RT_CHAOS_SEED"] = str(args.seed)
    # native arms also ride plain env so C++ picks them up at dlopen in
    # every child, not only where maybe_arm() runs
    for arm, value in (plan.native or {}).items():
        env["RT_CHAOS_" + arm.upper()] = str(value)
    proc = subprocess.run(command, env=env)

    events = read_events(log_dir)
    by_kind: dict[tuple, int] = {}
    for ev in events:
        key = (ev.get("point", "?"), ev.get("action", "?"))
        by_kind[key] = by_kind.get(key, 0) + 1
    print(f"\nchaos: {len(events)} fault(s) fired "
          f"(seed={args.seed if args.seed is not None else plan.seed}, "
          f"log: {log_dir})", file=sys.stderr)
    for (pt, action), n in sorted(by_kind.items()):
        print(f"  {pt:<24} {action:<10} ×{n}", file=sys.stderr)
    return proc.returncode
