"""raylint effect lattice: per-function intrinsic effect inference.

Each function gets a set of *intrinsic* effects — costs its own body
pays on every call — which `flow.py` then propagates to fixpoint through
the package call graph. The lattice is the distilled history of this
repo's hot-path bugs:

  blocking   sleep, lock-wait, blocking ray_tpu_torch.get, file/socket I/O,
             subprocess waits, timed future.result() — anything that
             parks the calling thread (a blocking shm read on the event
             loop's default executor once deadlocked the whole process)
  syscall    a syscall paid once per call — os.urandom / getpid /
             uuid4 / secrets (~288µs of urandom per request was once
             measured in the submit path)
  host-sync  a host-device synchronization — torch.cuda.synchronize(),
             a stream's or event's .synchronize(), and .item()/.tolist()/
             .cpu()/.numpy()/.to("cpu") or float()/int()/bool()/
             np.asarray() of a tensor bound from a torch call (RT017's
             torch legs: the host waits for the card once per call where
             a decode block's budget is one wait per block)
  alloc      registry-churning construction — metrics Counter/Gauge/
             Histogram, fresh trace contexts, serve.batch wrappers,
             queue objects (the RT011/RT015/RT016 class)

Detection is deliberately shallow per function: one AST walk with the
same import-table name resolution the rule engine uses, plus RT017's
forward-flow map of torch-bound names (TorchSyncs, shared with RT017).
Depth comes from propagation, not from per-site cleverness.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass

# ------------------------------------------------------------ the lattice
BLOCKING = "blocking"
SYSCALL = "syscall"
HOST_SYNC = "host-sync"
ALLOC = "alloc"

ALL_EFFECTS = frozenset({BLOCKING, SYSCALL, HOST_SYNC, ALLOC})

# ------------------------------------------------------- context roots
# Root kinds and the effects forbidden on anything reachable from them.
# Rules map 1:1 onto effects (RT020=blocking, RT021=syscall,
# RT022=host-sync, RT023=alloc); a rule fires for a root only when the
# root kind forbids that rule's effect.
ROOT_FORBIDS: dict[str, frozenset] = {
    # a callback handed to loop.call_soon/_threadsafe/call_later runs ON
    # the event loop: blocking it stalls every coroutine in the process
    "event-loop": frozenset({BLOCKING}),
    # the shm fast-lane pumps: per-record cost IS the product
    "fast-pump": frozenset({BLOCKING, SYSCALL, ALLOC}),
    # tunnel record-exec paths: the cross-node fast lane's pump twins
    "tunnel-exec": frozenset({BLOCKING, SYSCALL, ALLOC}),
    # serve request handlers: per-request cost at serve QPS
    "serve-handler": frozenset({BLOCKING, SYSCALL, ALLOC}),
    # functions that queue work on the card without reading it back: the
    # inference_mode/no_grad decode and prefill programs, autograd.Function
    # forward/backward, torch.library op kernels, CUDA-graph bodies — a host
    # sync inside the region stalls the queue it exists to keep full
    "device-region": frozenset({HOST_SYNC}),
}

# functions that are roots by NAME, colored from the production system's
# actual hot paths: a plain key matches a function's leaf name, a dotted
# key its whole local qualname ("make_dqn_update.<locals>.update")
NAMED_ROOTS: dict[str, str] = {
    "_fast_pump": "fast-pump",
    "fast_actor_submit_loop": "fast-pump",
    "_tunnel_exec_seq": "tunnel-exec",
    "_tunnel_exec_batch_sync": "tunnel-exec",
    "_tunnel_exec_task_batch": "tunnel-exec",
    "_tunnel_exec_one": "tunnel-exec",
    "_tunnel_exec_record_on_loop": "tunnel-exec",
    "rpc_tunnel_frame": "tunnel-exec",
    "handle_request": "serve-handler",
    "handle_request_streaming": "serve-handler",
    # the device programs whose JAX counterparts are jitted (or lax.scan
    # bodies) but which carry no mark of their own in torch: training
    # steps keep autograd on, so they cannot run under no_grad
    "scatter_pages": "device-region",
    "vtrace_returns": "device-region",
    "ring_attention_local": "device-region",
    "pipeline_spmd_local": "device-region",
    "make_train_step.<locals>.step": "device-region",
    "make_ppo_update.<locals>.update": "device-region",
    "make_appo_update.<locals>.update": "device-region",
    "make_impala_update.<locals>.update": "device-region",
    "make_dqn_update.<locals>.update": "device-region",
    "make_sac_update.<locals>.update": "device-region",
    "make_bc_update.<locals>.update": "device-region",
    "make_cql_update.<locals>.update": "device-region",
}

# ------------------------------------------------------------ edge masks
# Effects that PROPAGATE caller-ward across each call-edge kind. The
# executor distinctions encode the repo's own fix idioms: shipping work
# to a PRIVATE pool (the core client's _store_executor) is the cure for
# blocking, so nothing propagates back; the loop's DEFAULT executor is
# shared with the loop's own machinery, so blocking submitted there still
# starves it.
EDGE_MASKS: dict[str, frozenset] = {
    "call": ALL_EFFECTS,
    "remote": ALL_EFFECTS,        # .remote() dispatch: callee runs per call
    "task": ALL_EFFECTS,          # create_task/ensure_future: runs on loop
    "call_soon": ALL_EFFECTS,     # call_soon[_threadsafe]/call_later
    "default-executor": frozenset({BLOCKING}),  # run_in_executor(None, f)
    "executor": frozenset(),      # private pool submit: isolation by design
    "thread": frozenset(),        # Thread(target=...): its own thread
}

# rule id -> effect it polices
RULE_EFFECT = {
    "RT020": BLOCKING,
    "RT021": SYSCALL,
    "RT022": HOST_SYNC,
    "RT023": ALLOC,
}
EFFECT_RULE = {v: k for k, v in RULE_EFFECT.items()}


# ----------------------------------------------------------- effect sites
@dataclass(frozen=True)
class EffectSite:
    """One intrinsic effect occurrence inside a function body."""
    effect: str
    detail: str   # e.g. "os.urandom()" — line-stable, used in baseline keys
    line: int
    col: int


_SYSCALLS = {
    ("os", "urandom"), ("os", "getpid"), ("os", "getppid"),
    ("uuid", "uuid1"), ("uuid", "uuid4"),
    ("secrets", "token_bytes"), ("secrets", "token_hex"),
    ("secrets", "token_urlsafe"),
}
_SUBPROCESS = {"run", "call", "check_call", "check_output"}
_BLOCKING_ORIGINS = {
    ("time", "sleep"),
    ("os", "fsync"), ("os", "fdatasync"),
    ("socket", "create_connection"),
    ("shutil", "copyfile"), ("shutil", "copytree"),
}
_QUEUE_CTORS = {("queue", "Queue"), ("queue", "SimpleQueue"),
                ("asyncio", "Queue")}
_METRIC_CTORS = {"Counter", "Gauge", "Histogram"}


def _is_framework_get(origin) -> bool:
    """Blocking ray_tpu_torch.get: the public api / client entry points,
    not an unrelated in-package helper that happens to be named get."""
    if not origin or origin[0] != "ray_tpu_torch" or origin[-1] != "get":
        return False
    return len(origin) == 2 or "api" in origin[:-1] or "client" in origin[:-1]


# ------------------------------------------------- torch host-sync legs
# torch.* functions and submodules whose results are no tensor: a name
# bound from them is not a device value
_NOT_TENSOR = {"cuda", "device", "Generator", "finfo", "iinfo", "Size",
               "distributed", "backends", "library", "profiler",
               "manual_seed"}
# tensor methods that give the host a value (the sync legs among them) or
# only read metadata: a name bound from them is not a device value
_HOST_METHODS = {"item", "tolist", "cpu", "numpy", "size", "dim", "numel",
                 "nelement", "ndimension", "stride", "storage_offset",
                 "element_size", "data_ptr", "get_device", "is_contiguous"}
# tensor attributes that are host metadata
_META_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
               "requires_grad", "is_leaf", "names"}
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_SYNC_BUILTINS = ("float", "int", "bool")
_SYNC_NUMPY = ("asarray", "array")


_COMPREHENSIONS = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)


def _target_names(target: ast.AST) -> list[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for elt in target.elts for n in _target_names(elt)]
    return []


def _to_cpu(call: ast.Call, positional: bool = True) -> bool:
    """`.to("cpu")` / `.to(device="cpu")` (also "cpu:0"); with
    positional False only the keyword counts (torch.ones(4, device="cpu"))."""
    dev = call.args[0] if call.args and positional else next(
        (kw.value for kw in call.keywords if kw.arg == "device"), None)
    return (isinstance(dev, ast.Constant) and isinstance(dev.value, str)
            and dev.value.split(":")[0] == "cpu")


class TorchSyncs:
    """RT017's torch legs, shared by the rule and the flow pass's
    host-sync effect: a forward-flow map, within one function, of the
    names that hold device tensors, and which calls make the host wait
    for the card.

    A name holds a device tensor when bound from a torch.* call (not one
    of _NOT_TENSOR's, nor one given device="cpu"), from a tensor method,
    index or arithmetic on such a value, or as the target of a for-loop
    over one; any other binding clears it. The syncs: torch.cuda.synchronize() and, in a module that
    imports torch, any `.synchronize()` (stream, event); .item(),
    .tolist(), .cpu(), .numpy(), .to("cpu") on a device value; float(),
    int(), bool(), np.asarray(), np.array() of one.
    """

    def __init__(self, imports):
        self.imports = imports
        self.uses_torch = any(origin and origin[0] == "torch"
                              for origin in imports.bindings.values())
        self.device: set[str] = set()

    def is_device(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.device
        if isinstance(node, ast.Subscript):
            return self.is_device(node.value)
        if isinstance(node, ast.Attribute):  # .indices, .T, .grad
            return node.attr not in _META_ATTRS and self.is_device(node.value)
        if isinstance(node, ast.UnaryOp):
            return self.is_device(node.operand)
        if isinstance(node, ast.BinOp):
            return self.is_device(node.left) or self.is_device(node.right)
        if isinstance(node, ast.Compare):
            return any(self.is_device(n)
                       for n in (node.left, *node.comparators))
        if not isinstance(node, ast.Call):
            return False
        func = node.func
        origin = self.imports.resolve(func)
        if origin:
            return (origin[0] == "torch" and len(origin) > 1
                    and origin[1] not in _NOT_TENSOR
                    and not origin[-1].startswith(("is_", "get_", "set_"))
                    and not _to_cpu(node, positional=False))
        return (isinstance(func, ast.Attribute)
                and func.attr not in _HOST_METHODS
                and not (func.attr == "to" and _to_cpu(node))
                and self.is_device(func.value))

    def bind(self, target: ast.AST, value: ast.AST):
        """Record `target = value` (or `for target in value`)."""
        names = _target_names(target)
        if self.is_device(value):
            self.device.update(names)
        else:
            self.device.difference_update(names)

    def sync(self, node: ast.Call) -> str | None:
        """A line-stable description of the sync `node` makes, else None."""
        func = node.func
        origin = self.imports.resolve(func)
        if origin == ("torch", "cuda", "synchronize"):
            return "torch.cuda.synchronize()"
        if isinstance(func, ast.Attribute):
            if func.attr == "synchronize" and self.uses_torch:
                return f"{ast.unparse(func.value)}.synchronize()"
            if self.is_device(func.value) and (
                    func.attr in _SYNC_METHODS
                    or (func.attr == "to" and _to_cpu(node))):
                return ast.unparse(node)
        if not node.args or not self.is_device(node.args[0]):
            return None
        if (isinstance(func, ast.Name) and func.id in _SYNC_BUILTINS
                and origin is None):
            return f"{func.id}({ast.unparse(node.args[0])})"
        if origin and origin[0] == "numpy" and origin[-1] in _SYNC_NUMPY:
            return f"np.{origin[-1]}({ast.unparse(node.args[0])})"
        return None


class EffectScanner:
    """Scans ONE function body (nested defs excluded — they are their own
    graph nodes; lambdas included — their deferred bodies are attributed
    to the enclosing function) and yields EffectSites.

    `imports` is any object with a `resolve(node) -> tuple|None` method
    and a `bindings` dict (engine.ImportTable or flow.ModuleImports).
    """

    def __init__(self, imports):
        self.imports = imports
        self.sites: list[EffectSite] = []
        self.torch = TorchSyncs(imports)

    # -- public -------------------------------------------------------------
    def scan(self, fn: ast.AST) -> list[EffectSite]:
        for stmt in fn.body:
            self._walk(stmt)
        return self.sites

    # -- walk ---------------------------------------------------------------
    def _walk(self, node: ast.AST):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # separate graph nodes
        if isinstance(node, (ast.For, ast.AsyncFor)):
            # the iterable is evaluated before its items are bound
            self._walk(node.iter)
            self.torch.bind(node.target, node.iter)
            for stmt in [*node.body, *node.orelse]:
                self._walk(stmt)
            return
        if isinstance(node, _COMPREHENSIONS):
            for gen in node.generators:
                self._walk(gen.iter)
                self.torch.bind(gen.target, gen.iter)
                for cond in gen.ifs:
                    self._walk(cond)
            for part in ((node.key, node.value) if isinstance(node, ast.DictComp)
                         else (node.elt,)):
                self._walk(part)
            return
        if isinstance(node, ast.Call):
            self._check_call(node)
        for child in ast.iter_child_nodes(node):
            self._walk(child)
        # after the value's own calls: `x = x.cpu()` syncs on the old x
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            self.torch.bind(node.targets[0], node.value)

    # -- detectors ----------------------------------------------------------
    def _add(self, node: ast.AST, effect: str, detail: str):
        self.sites.append(EffectSite(effect, detail,
                                     getattr(node, "lineno", 0),
                                     getattr(node, "col_offset", 0)))

    def _check_call(self, node: ast.Call):
        func = node.func
        origin = self.imports.resolve(func)

        # ---- syscall-per-call
        if origin and tuple(origin[-2:]) in _SYSCALLS:
            self._add(node, SYSCALL, f"{'.'.join(origin)}()")
            return

        # ---- blocking
        if origin:
            if tuple(origin[-2:]) in _BLOCKING_ORIGINS:
                self._add(node, BLOCKING, f"{'.'.join(origin)}()")
                return
            if origin[0] == "subprocess" and origin[-1] in _SUBPROCESS:
                self._add(node, BLOCKING, f"subprocess.{origin[-1]}()")
                return
            if _is_framework_get(origin):
                self._add(node, BLOCKING, "ray_tpu_torch.get()")
                return
        if (isinstance(func, ast.Name) and func.id == "open"
                and self.imports.resolve(func) is None):
            self._add(node, BLOCKING, "open()")
            return
        if isinstance(func, ast.Attribute) and origin is None:
            # timed future.result(t): the concurrent.futures blocking-wait
            # idiom (argless .result() on a done asyncio future is the
            # normal callback shape and stays clean)
            if func.attr == "result" and node.args:
                self._add(node, BLOCKING, ".result(timeout)")
                return
            # argless lock.acquire() / thread.join(): unbounded waits
            if func.attr in ("acquire", "join") and not node.args \
                    and not node.keywords:
                self._add(node, BLOCKING, f".{func.attr}()")
                return

        # ---- host-device sync
        detail = self.torch.sync(node)
        if detail is not None:
            self._add(node, HOST_SYNC, detail)
            return

        # ---- alloc-heavy construction
        if origin and origin[0] == "ray_tpu_torch":
            if origin[-1] in _METRIC_CTORS and "metrics" in origin[:-1]:
                self._add(node, ALLOC, f"metrics.{origin[-1]}()")
                return
            if "tracing" in origin[:-1]:
                leaf = origin[-1]
                if leaf in ("inject", "submit_context"):
                    self._add(node, ALLOC, f"tracing.{leaf}()")
                    return
                if leaf == "span" and self._span_fresh_root(node):
                    self._add(node, ALLOC, "tracing.span(fresh root)")
                    return
            if origin[-1] == "batch" and ("serve" in origin[:-1]
                                          or "batching" in origin[:-1]):
                self._add(node, ALLOC, "serve.batch()")
                return
        if origin and tuple(origin[-2:]) in _QUEUE_CTORS:
            self._add(node, ALLOC, f"{'.'.join(origin)}()")
            return

    @staticmethod
    def _span_fresh_root(node: ast.Call) -> bool:
        """tracing.span with a missing/None trace_ctx mints a new root."""
        tc = node.args[1] if len(node.args) >= 2 else None
        if tc is None:
            for kw in node.keywords:
                if kw.arg == "trace_ctx":
                    tc = kw.value
        return tc is None or (isinstance(tc, ast.Constant)
                              and tc.value is None)
