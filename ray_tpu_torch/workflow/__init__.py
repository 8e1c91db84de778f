"""ray_tpu_torch.workflow — durable workflows on the port's task runtime.

Counterpart of ``ray_tpu/workflow`` and of Ray Workflows (ref:
python/ray/workflow/ — api.py run:123/resume:243/resume_all:502, step
checkpointing in workflow_state.py + storage): a DAG of steps authored with .bind(),
executed as ordinary tasks, with every step's result checkpointed to
durable storage so a crashed/restarted driver resumes from the last
completed step instead of recomputing.

    from ray_tpu_torch import workflow

    @workflow.step
    def fetch(x): ...
    @workflow.step
    def train(data): ...

    out = workflow.run(train.bind(fetch.bind(1)), workflow_id="exp1")
    # process dies mid-run? ->
    out = workflow.resume("exp1")   # completed steps replay from storage
"""
from ray_tpu_torch.workflow.api import (
    EventListener,
    KVEventListener,
    TimerListener,
    WorkflowStep,
    get_output,
    get_status,
    list_all,
    resume,
    resume_all,
    run,
    send_event,
    step,
    wait_for_event,
)

__all__ = [
    "EventListener",
    "KVEventListener",
    "TimerListener",
    "WorkflowStep",
    "get_output",
    "get_status",
    "list_all",
    "resume",
    "resume_all",
    "run",
    "send_event",
    "step",
    "wait_for_event",
]
