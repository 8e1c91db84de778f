"""DAG authoring: bind actor methods into a static dataflow graph.

Counterpart of ``ray_tpu/dag/dag_node.py`` (ref: python/ray/dag/
dag_node.py:265 experimental_compile entry, dag/class_node.py
ClassMethodNode, dag/input_node.py, dag/output_node.py). The node graph is
pure description: nothing runs until ``experimental_compile()`` turns it
into per-actor static schedules over shared-memory channels
(``compiled_dag.py``).

As in the JAX package there is no FunctionNode: the compiled path is the
only path (a dynamic task DAG is the plain task API). Tensors move between
stages through the channels; a CUDA tensor goes through host memory.
"""

from __future__ import annotations

from typing import Any


class DAGNode:
    """Base: a node in the authored graph."""

    def __init__(self, upstream: list["DAGNode"]):
        self.upstream = upstream

    def experimental_compile(self, *, buffer_size_bytes: int = 8 << 20,
                             timeout_s: float = 30.0, overlap: bool = True):
        from ray_tpu_torch.dag.compiled_dag import CompiledDAG

        return CompiledDAG(self, buffer_size_bytes=buffer_size_bytes,
                           timeout_s=timeout_s, overlap=overlap)

    # -- traversal helpers ---------------------------------------------------
    def walk(self, seen: set | None = None):
        """Every node this one depends on, then this one (DFS postorder)."""
        if seen is None:
            seen = set()
        if id(self) in seen:
            return
        seen.add(id(self))
        for up in self.upstream:
            yield from up.walk(seen)
        yield self


class InputNode(DAGNode):
    """The driver-fed input (ref: dag/input_node.py). Context manager so the
    authoring block reads naturally:

        with InputNode() as inp:
            x = actor_a.step.bind(inp)
            dag = actor_b.step.bind(x)
    """

    def __init__(self):
        super().__init__([])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class ClassMethodNode(DAGNode):
    """One actor-method invocation per iteration (ref: dag/class_node.py)."""

    def __init__(self, actor_handle, method_name: str, args: tuple):
        upstream = [a for a in args if isinstance(a, DAGNode)]
        super().__init__(upstream)
        self.actor_handle = actor_handle
        self.method_name = method_name
        self.args = args  # mix of DAGNode and static values


class MultiOutputNode(DAGNode):
    """Wraps N leaves so execute() returns a list (ref: dag/output_node.py)."""

    def __init__(self, outputs: list[DAGNode]):
        super().__init__(list(outputs))
        self.outputs = list(outputs)


class CollectiveNode(ClassMethodNode):
    """A collective op over one actor's iteration value (ref:
    dag/collective_node.py CollectiveOutputNode +
    experimental/collective/operations.py): every actor in ``group_name``
    binds its own CollectiveNode; at run time each DAG loop calls
    ``ray_tpu_torch.collective`` with its local value, and the group's
    rendezvous synchronizes the members (NCCL or gloo)."""

    def __init__(self, actor_handle, op: str, arg, group_name: str):
        super().__init__(actor_handle, f"__collective_{op}__", (arg,))
        self.op = op
        self.group_name = group_name


def allreduce_bind(inputs: list, group_name: str = "default") -> list:
    """Bind an allreduce over a set of per-actor DAG nodes (one per group
    member). Returns one CollectiveNode per input, each bound to that
    input's actor (ref: ray.experimental.collective.allreduce.bind)."""
    out = []
    for node in inputs:
        if not isinstance(node, ClassMethodNode):
            raise ValueError("allreduce_bind takes actor method nodes")
        out.append(CollectiveNode(node.actor_handle, "allreduce", node, group_name))
    return out


def bind(actor_handle, method_name: str, *args: Any) -> ClassMethodNode:
    return ClassMethodNode(actor_handle, method_name, args)
