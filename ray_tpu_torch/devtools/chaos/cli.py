"""The chaos event log, read back.

Counterpart of ``ray_tpu/devtools/chaos/cli.py``'s :func:`read_events`.
Every armed process (driver, raylets, workers, GCS) appends the faults it
fired to ``<log_dir>/chaos-<pid>.jsonl`` (controller.py); a workload run
under a plan (``RT_CHAOS_ENABLED=1``, ``RT_CHAOS_PLAN``,
``RT_CHAOS_LOG_DIR``) reads them all back here to prove the plan struck.
The port has no ``python -m`` command line.
"""
from __future__ import annotations

import json
import os


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
