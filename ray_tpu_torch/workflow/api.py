"""Workflow authoring + durable execution engine.

Counterpart of ``ray_tpu/workflow/api.py`` on the port's runtime (ref:
python/ray/workflow/workflow_executor.py, step checkpointing
task_executor.py + workflow_storage.py). Design:

- @workflow.step wraps a function; .bind() builds a static DAG node
  (same authoring shape as compiled graphs / the reference's DAG API).
- run(dag, workflow_id) executes steps as ray_tpu_torch tasks in
  dependency order; every completed step's result is written to the
  storage dir (filesystem — durable across driver and cluster restarts,
  the reference's default local storage role).
- A checkpoint is the runtime's own wire form (``utils.serialization``):
  a tensor is kept as host bytes with its dtype and shape, and a CUDA
  tensor is restored on the reader's current card; a reader without CUDA
  raises (never a CPU tensor), as the object store's get does.
- resume(workflow_id) reloads the DAG definition itself from storage
  and replays: completed steps short-circuit to their checkpointed
  results; pending steps execute. Nothing about the original driver
  process is needed.
- Step failures retry per-step (max_retries: a step whose worker died
  runs again); a failed workflow keeps its partial checkpoints and can
  resume after the bug/outage is fixed.

Storage defaults to ``$TMPDIR/ray_tpu_torch/workflows`` (set
``RAY_TPU_TORCH_WORKFLOW_STORAGE`` to move it), and events live in the
port's GCS KV under the namespace ``rtt_wf_events``: neither is shared
with the JAX package's workflows.
"""
from __future__ import annotations

import logging
import json
import os
import tempfile
import time
import uuid
from typing import Any, Callable

_log = logging.getLogger(__name__)

from ray_tpu_torch.utils.serialization import pack, unpack

STORAGE_ENV = "RAY_TPU_TORCH_WORKFLOW_STORAGE"
DEFAULT_STORAGE = os.path.join(tempfile.gettempdir(), "ray_tpu_torch", "workflows")

RUNNING = "RUNNING"
SUCCESSFUL = "SUCCESSFUL"
FAILED = "FAILED"


def _storage_root() -> str:
    return os.environ.get(STORAGE_ENV, DEFAULT_STORAGE)


def _wf_dir(workflow_id: str) -> str:
    return os.path.join(_storage_root(), workflow_id)


# ------------------------------------------------------------------ authoring
class WorkflowStep:
    """A step definition (ref: workflow step decorator)."""

    def __init__(self, fn: Callable, *, name: str | None = None,
                 max_retries: int = 0, num_cpus: float = 1.0,
                 resources: dict | None = None):
        self.fn = fn
        self.name = name or fn.__name__
        self.max_retries = max_retries
        self.num_cpus = num_cpus
        self.resources = resources or {}

    def options(self, **kw) -> "WorkflowStep":
        merged = dict(name=self.name, max_retries=self.max_retries,
                      num_cpus=self.num_cpus, resources=self.resources)
        merged.update(kw)
        return WorkflowStep(self.fn, **merged)

    def bind(self, *args, **kwargs) -> "StepNode":
        return StepNode(self, args, kwargs)

    def __call__(self, *a, **k):
        return self.fn(*a, **k)  # direct call runs locally (debugging)


class StepNode:
    """DAG node: a step bound to (possibly node-valued) arguments.
    step_id is assigned by _assign_ids at run time from the DAG's own
    structure (DFS order), so identical DAGs get identical ids no matter
    what else the process built before them."""

    def __init__(self, step: WorkflowStep, args: tuple, kwargs: dict):
        self.step = step
        self.args = args
        self.kwargs = kwargs
        self.step_id: str | None = None


def _assign_ids(dag: StepNode) -> None:
    """Deterministic ids: <name>_<k> by first-visit DFS order over args
    then kwargs (sorted). Persisted ids in a stored DAG are kept."""
    counters: dict[str, int] = {}
    seen: set[int] = set()

    def visit(node: StepNode):
        if id(node) in seen:
            return
        seen.add(id(node))
        for a in node.args:
            if isinstance(a, StepNode):
                visit(a)
        for k in sorted(node.kwargs):
            v = node.kwargs[k]
            if isinstance(v, StepNode):
                visit(v)
        if node.step_id is None:
            counters[node.step.name] = counters.get(node.step.name, 0) + 1
            node.step_id = f"{node.step.name}_{counters[node.step.name]}"

    visit(dag)


def step(fn=None, *, name: str | None = None, max_retries: int = 0,
         num_cpus: float = 1.0, resources: dict | None = None):
    """@workflow.step decorator."""

    def wrap(f):
        return WorkflowStep(f, name=name, max_retries=max_retries,
                            num_cpus=num_cpus, resources=resources)

    if fn is not None:
        return wrap(fn)
    return wrap


# ------------------------------------------------------------------ storage
class _Storage:
    """Filesystem checkpoint layout (ref: workflow_storage.py):
    <root>/<workflow_id>/{dag.pkl, status.json, steps/<step_id>.pkl}"""

    def __init__(self, workflow_id: str):
        self.workflow_id = workflow_id
        self.dir = _wf_dir(workflow_id)

    def _ensure_dirs(self):
        # write paths only: reads of unknown ids must not create phantom
        # workflow directories that pollute list_all()/resume_all()
        os.makedirs(os.path.join(self.dir, "steps"), exist_ok=True)

    def save_dag(self, dag: StepNode):
        self._ensure_dirs()
        _write(os.path.join(self.dir, "dag.pkl"), dag)

    def load_dag(self) -> StepNode:
        return _read(os.path.join(self.dir, "dag.pkl"))

    def set_status(self, status: str, error: str | None = None):
        self._ensure_dirs()
        with open(os.path.join(self.dir, "status.json"), "w") as f:
            json.dump({"status": status, "error": error, "ts": time.time()}, f)

    def get_status(self) -> dict:
        try:
            with open(os.path.join(self.dir, "status.json")) as f:
                return json.load(f)
        except FileNotFoundError:
            return {"status": "NOT_FOUND"}

    def step_path(self, step_id: str) -> str:
        return os.path.join(self.dir, "steps", f"{step_id}.pkl")

    def has_step(self, step_id: str) -> bool:
        return os.path.exists(self.step_path(step_id))

    def save_step(self, step_id: str, value: Any):
        self._ensure_dirs()
        _write(self.step_path(step_id), value)

    def load_step(self, step_id: str) -> Any:
        return _read(self.step_path(step_id))


def _write(path: str, value: Any) -> None:
    """``value`` in the runtime's wire form, replaced atomically (no torn
    checkpoint)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(pack(value))
    os.replace(tmp, path)


def _read(path: str) -> Any:
    with open(path, "rb") as f:
        # a bytearray: arrays read back are writable, as unpickled ones are
        return unpack(bytearray(f.read()))


# ------------------------------------------------------------------ executor
def _execute(dag: StepNode, storage: _Storage) -> Any:
    """DAG execution with checkpoint short-circuiting. Independent
    branches run in parallel: steps receive upstream ObjectRefs and the
    runtime's dependency resolution does the waiting; the driver then
    drains results in submission (topological) order to checkpoint them."""
    import ray_tpu_torch
    from ray_tpu_torch.core.ref import ObjectRef

    memo: dict[str, Any] = {}  # step_id -> ObjectRef | checkpointed value
    order: list[tuple[StepNode, Any]] = []  # submitted, pending checkpoint

    def submit(node: StepNode) -> Any:
        if node.step_id in memo:
            return memo[node.step_id]
        if storage.has_step(node.step_id):
            value = storage.load_step(node.step_id)  # replay from checkpoint
            memo[node.step_id] = value
            return value
        args = [submit(a) if isinstance(a, StepNode) else a for a in node.args]
        kwargs = {k: submit(v) if isinstance(v, StepNode) else v
                  for k, v in node.kwargs.items()}
        if getattr(node.step, "_rt_event_listener", None) is not None:
            # event waits poll keys scoped to THIS workflow first (see
            # KVEventListener.event_keys) so runs can't consume each
            # other's payloads
            kwargs["_wf_event_scope"] = storage.workflow_id
        remote_fn = ray_tpu_torch.remote(node.step.fn)
        ref = remote_fn.options(
            num_cpus=node.step.num_cpus,
            resources=node.step.resources or None,
            max_retries=node.step.max_retries,
            name=f"wf:{node.step_id}",
        ).remote(*args, **kwargs)
        memo[node.step_id] = ref
        order.append((node, ref))
        return ref

    out = submit(dag)
    # per-step get is load-bearing for durability: each step checkpoints
    # the moment it completes, so a crash mid-workflow resumes from the
    # last saved step; one batched get would checkpoint all-or-nothing
    for node, ref in order:  # topological: deps checkpoint before dependents
        storage.save_step(node.step_id, ray_tpu_torch.get(ref))  # raylint: disable=RT002
        listener = getattr(node.step, "_rt_event_listener", None)
        if listener is not None:
            # the payload is checkpointed now — delete the consumed KV
            # entry so a later run's wait can't short-circuit on it and
            # event blobs stop accumulating in the GCS WAL/snapshot
            _cleanup_event_keys(listener, storage.workflow_id, node)
    if isinstance(out, ObjectRef):
        return ray_tpu_torch.get(out)
    return out


def _cleanup_event_keys(listener_cls, workflow_id: str, node: StepNode) -> None:
    """Best-effort delete of the CONSUMED event's KV entry, AFTER the
    waiting step checkpointed its result — a crash before the checkpoint
    must keep the payload for the re-wait.

    Only what the wait ACTUALLY consumed is deleted: the poll records the
    consumed key under a marker entry (see consumed_marker), so a sibling
    payload under the other candidate key — e.g. a shared-key event
    addressed to a different workflow, or a freshly posted scoped event
    for this workflow's NEXT wait — is never collaterally destroyed."""
    keys_fn = getattr(listener_cls, "event_keys", None)
    if keys_fn is None or not node.args:
        return
    try:
        from ray_tpu_torch.core import api as _core_api

        core = _core_api.get_core()
        targets = []
        marker = None
        marker_fn = getattr(listener_cls, "consumed_marker", None)
        if marker_fn is not None:
            marker = marker_fn(workflow_id, node.args[0])
            consumed = core._run_sync(core.gcs.call(
                "kv_get", {"ns": listener_cls.NS, "key": marker}))
            if consumed is not None:
                targets = [consumed.decode()]
        if not targets:
            # no marker (replayed-from-checkpoint node, legacy DAG): the
            # conservative fallback deletes only the scoped key, which is
            # addressed to this workflow by construction
            candidates = keys_fn(workflow_id, node.args[0])
            targets = candidates[:1] if len(candidates) > 1 else candidates
        for k in targets:
            core._run_sync(core.gcs.call(
                "kv_del", {"ns": listener_cls.NS, "key": k}))
        if marker is not None:
            core._run_sync(core.gcs.call(
                "kv_del", {"ns": listener_cls.NS, "key": marker}))
    except Exception:
        # a failed delete only leaves a stale blob behind
        _log.debug("workflow event cleanup failed", exc_info=True)


def _run_to_completion(storage: _Storage, dag: StepNode) -> Any:
    storage.set_status(RUNNING)
    try:
        result = _execute(dag, storage)
    except Exception as e:
        storage.set_status(FAILED, error=repr(e))
        raise
    # the output checkpoint lands BEFORE the status flip: a crash between
    # the two leaves a resumable RUNNING workflow, never a SUCCESSFUL one
    # with no output
    storage.save_step("__output__", result)
    storage.set_status(SUCCESSFUL)
    return result


def run(dag: StepNode, *, workflow_id: str | None = None) -> Any:
    """Execute a workflow DAG durably (ref: api.py run:123)."""
    import ray_tpu_torch

    if not isinstance(dag, StepNode):
        raise TypeError("workflow.run takes a bound step: my_step.bind(...)")
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    workflow_id = workflow_id or f"wf-{uuid.uuid4().hex[:12]}"
    storage = _Storage(workflow_id)
    _assign_ids(dag)
    storage.save_dag(dag)
    return _run_to_completion(storage, dag)


def resume(workflow_id: str) -> Any:
    """Resume from checkpoints; the DAG definition comes from storage, so
    any process can resume any workflow (ref: api.py resume:243)."""
    import ray_tpu_torch

    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    storage = _Storage(workflow_id)
    status = storage.get_status()
    if status.get("status") == "NOT_FOUND":
        raise ValueError(f"no workflow {workflow_id!r} in storage")
    if status.get("status") == SUCCESSFUL:
        return storage.load_step("__output__")
    dag = storage.load_dag()
    return _run_to_completion(storage, dag)


def resume_all(include_failed: bool = True) -> list[tuple[str, Any]]:
    """Resume every non-successful stored workflow (ref: api.py
    resume_all:502)."""
    out = []
    for wf_id in list_all():
        status = get_status(wf_id)
        if status == SUCCESSFUL:
            continue
        if status == FAILED and not include_failed:
            continue
        try:
            out.append((wf_id, resume(wf_id)))
        except Exception as e:  # keep going: one bad workflow isn't fatal
            out.append((wf_id, e))
    return out


def get_status(workflow_id: str) -> str:
    return _Storage(workflow_id).get_status().get("status", "NOT_FOUND")


def get_output(workflow_id: str) -> Any:
    storage = _Storage(workflow_id)
    if storage.get_status().get("status") != SUCCESSFUL:
        raise ValueError(f"workflow {workflow_id!r} has not succeeded")
    return storage.load_step("__output__")


def list_all() -> list[str]:
    root = _storage_root()
    try:
        return sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
        )
    except FileNotFoundError:
        return []


# ------------------------------------------------------------------- events
class EventListener:
    """Pluggable event source for wait_for_event (ref:
    python/ray/workflow/event_listener.py EventListener.poll_for_event —
    async there; a plain blocking poll here, since the wait runs inside
    an ordinary worker task, not an event loop)."""

    def poll_for_event(self, *args, **kwargs):
        raise NotImplementedError


class TimerListener(EventListener):
    """Fires after a duration (ref: event_listener.py TimerListener)."""

    def poll_for_event(self, duration_s: float):
        time.sleep(duration_s)
        return duration_s


class KVEventListener(EventListener):
    """Fires when ``send_event(key, payload)`` posts to the cluster KV —
    the cross-process event channel (ref: the HTTP event provider role,
    workflow/http_event_provider.py, over this framework's GCS KV
    instead of an HTTP endpoint).

    Event lifecycle: a wait step polls the key scoped to its own workflow
    id first (``send_event(key, payload, workflow_id=...)``), then the
    shared plain key; once the waiting step's result is checkpointed the
    consumed entries are deleted (see _cleanup_event_keys), so a stale
    payload from a previous run can never short-circuit a later wait and
    blobs don't accumulate in the GCS WAL. Consequence: a shared-key
    event is consumed by ONE workflow — to address several concurrent
    workflows, send each a workflow_id-scoped event (or distinct keys);
    a shared key is not a broadcast channel."""

    NS = "rtt_wf_events"
    workflow_id: str | None = None  # injected by the wait_for_event step

    @classmethod
    def event_keys(cls, workflow_id: str | None, key: str) -> list[str]:
        """KV keys consulted for ``key``, most specific first."""
        keys = []
        if workflow_id:
            keys.append(f"wf:{workflow_id}:{key}")
        keys.append(key)
        return keys

    @classmethod
    def consumed_marker(cls, workflow_id: str, key: str) -> str:
        """KV key recording WHICH entry a workflow's wait consumed, so
        the post-checkpoint cleanup deletes exactly that entry — never a
        sibling payload addressed to someone else."""
        return f"wf-consumed::{workflow_id}::{key}"

    def poll_for_event(self, key: str, poll_interval_s: float = 0.2,
                       timeout_s: float | None = None):
        from ray_tpu_torch.core import api as _core_api

        core = _core_api.get_core()
        candidates = self.event_keys(self.workflow_id, key)
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while True:
            for k in candidates:
                blob = core._run_sync(core.gcs.call(
                    "kv_get", {"ns": self.NS, "key": k}))
                if blob is not None:
                    if self.workflow_id:
                        # record the consumed key BEFORE returning: the
                        # driver-side cleanup reads it after the step
                        # checkpoints (a crash-retry simply overwrites it)
                        core._run_sync(core.gcs.call("kv_put", {
                            "ns": self.NS,
                            "key": self.consumed_marker(self.workflow_id,
                                                        key),
                            "value": k.encode()}))
                    return unpack(blob)
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"no event {key!r} within {timeout_s}s")
            time.sleep(poll_interval_s)


def send_event(key: str, payload: Any = None,
               workflow_id: str | None = None) -> None:
    """Deliver an event to any KVEventListener waiting on ``key``; with
    ``workflow_id`` the payload is addressed to that workflow's waits
    only (other workflows sharing the key name never observe it)."""
    from ray_tpu_torch.core import api as _core_api

    if workflow_id:
        key = f"wf:{workflow_id}:{key}"
    core = _core_api.get_core()
    core._run_sync(core.gcs.call("kv_put", {
        "ns": KVEventListener.NS, "key": key,
        "value": pack(payload)}))


def wait_for_event(listener_cls: type, *args, name: str | None = None,
                   num_cpus: float = 0.1, **kwargs) -> StepNode:
    """A workflow step that completes when the listener's event arrives
    (ref: api.py wait_for_event:380). The delivered payload checkpoints
    like any step result, so a resumed workflow does NOT re-wait for an
    event it already consumed."""
    if not (isinstance(listener_cls, type)
            and issubclass(listener_cls, EventListener)):
        raise TypeError("wait_for_event takes an EventListener subclass")

    def poll(*a, _wf_event_scope=None, **k):
        listener = listener_cls()
        listener.workflow_id = _wf_event_scope
        return listener.poll_for_event(*a, **k)

    wrapped = WorkflowStep(
        poll, name=name or f"wait_{listener_cls.__name__}",
        num_cpus=num_cpus)
    # marks the step for scope injection + post-checkpoint KV cleanup
    wrapped._rt_event_listener = listener_cls
    return wrapped.bind(*args, **kwargs)
