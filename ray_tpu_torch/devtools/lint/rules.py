"""raylint rules RT001-RT019/RT024 + flow-rule registrations RT020-RT023.

Each AST rule is a Rule subclass registered with @register; hooks
receive (node, ctx) from the engine's single AST walk. See
engine.rule_table() for the ID/summary/rationale table rendered by
`ray_tpu_torch lint --rules`. RT020-RT023 are registered here for the rule
table but fire from the interprocedural pass (flow.py), not from hooks.
"""
from __future__ import annotations

import ast
import os

from ray_tpu_torch.devtools.lint.engine import (
    _FRAMEWORK_ROOT,
    Context,
    Rule,
    literal_array_size,
    register,
)

# RT004: below this many elements an inline argument is cheap enough that
# copying it into the task spec beats a store round-trip
LARGE_ARRAY_ELEMENTS = 16384  # raylint: disable=RT018 -- array-size threshold, not a wire flag (RT018 sees this file's lazy schema import)


@register
class BlockingGetInRemote(Rule):
    id = "RT001"
    summary = "blocking get() inside a remote function or actor method"
    rationale = ("a task that blocks on get() holds its worker slot while "
                 "waiting on other tasks; under load this deadlocks the "
                 "scheduler (all slots waiting, none running)")

    def on_call(self, node: ast.Call, ctx: Context):
        if ctx.in_remote and ctx.framework_op(node.func) == "get":
            ctx.report(self, node,
                       "ray_tpu_torch.get() blocks inside a remote "
                       f"{ctx.in_remote.kind.replace('_', ' ')}; pass the "
                       "ObjectRef through instead (it resolves on arrival) "
                       "or restructure into a DAG")


@register
class GetInLoop(Rule):
    id = "RT002"
    summary = "get() called once per iteration instead of batched"
    rationale = ("get() in a loop serialises the cluster: each call waits "
                 "for one ref while the rest sit ready; one batched "
                 "get(refs) overlaps all transfers")

    def on_call(self, node: ast.Call, ctx: Context):
        # fires only when the argument references a for-loop/comprehension
        # target: a while-based poll loop, or wait()-then-get-one
        # streaming, is not a loop over refs and stays clean
        if (ctx.framework_op(node.func) == "get"
                and any(ctx.loops_over(arg)
                        for arg in [*node.args,
                                    *[kw.value for kw in node.keywords]])):
            ctx.report(self, node,
                       "get() once per ref inside a loop; collect the refs "
                       "and call get(refs) once (or use wait() for "
                       "streaming)")


@register
class DiscardedRemoteCall(Rule):
    id = "RT003"
    summary = ".remote() result discarded"
    rationale = ("a dropped ObjectRef can never be get() or wait()ed, so "
                 "task errors vanish and backpressure is impossible")

    def on_expr(self, node: ast.Expr, ctx: Context):
        call = node.value
        if (ctx.uses_framework
                and isinstance(call, ast.Call)
                and isinstance(call.func, ast.Attribute)
                and call.func.attr == "remote"):
            ctx.report(self, node,
                       ".remote() result discarded; keep the ObjectRef "
                       "(even fire-and-forget tasks need their errors "
                       "surfaced via wait())")


@register
class LargeArrayArgument(Rule):
    id = "RT004"
    summary = "large numpy/torch array passed inline to .remote() instead of put()"
    rationale = ("inline arguments are copied into every task spec; a "
                 "put() ref is written to the object store once and "
                 "shared zero-copy by every consumer")

    def on_call(self, node: ast.Call, ctx: Context):
        if not (ctx.uses_framework
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "remote"):
            return
        for arg in [*node.args, *[kw.value for kw in node.keywords]]:
            size = literal_array_size(arg, ctx)
            if size is None and isinstance(arg, ast.Name):
                size = ctx.array_bindings.get(arg.id)
            if size is not None and size >= LARGE_ARRAY_ELEMENTS:
                ctx.report(self, arg,
                           f"array of {size} elements passed inline to "
                           ".remote(); put() it once and pass the ref")


@register
class MutableDefaultOnRemote(Rule):
    id = "RT005"
    summary = "mutable default argument on a remote function/actor method"
    rationale = ("the default is evaluated once per worker process and "
                 "shared across invocations, so state leaks between tasks "
                 "on the same worker but not across workers — "
                 "nondeterminism that only appears at scale")

    _MUTABLE_CTORS = {"list", "dict", "set", "bytearray"}

    def _is_mutable(self, node: ast.AST) -> bool:
        if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                             ast.DictComp, ast.SetComp)):
            return True
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in self._MUTABLE_CTORS)

    def _check(self, node, ctx: Context):
        for default in [*node.args.defaults,
                        *[d for d in node.args.kw_defaults if d is not None]]:
            if self._is_mutable(default):
                ctx.report(self, default,
                           f"mutable default on remote {node.name}(); use "
                           "None and construct inside the body")

    def on_functiondef(self, node: ast.FunctionDef, ctx: Context):
        if (ctx.remote_decorator(node) is not None
                or getattr(node, "_rt_actor_method", False)):
            self._check(node, ctx)

    on_asyncfunctiondef = on_functiondef


@register
class DivergentCollectiveOrder(Rule):
    id = "RT006"
    summary = "collective call order diverges across branches"
    rationale = ("collectives are rendezvous points: if one replica takes "
                 "the if-branch and another the else, they post different "
                 "op sequences and every participant hangs forever")

    def on_if(self, node: ast.If, ctx: Context):
        if not ctx.in_remote or getattr(node, "_rt006_covered", False):
            return
        body_ops = self._collective_seq(node.body, ctx)
        else_ops = self._collective_seq(node.orelse, ctx)
        if body_ops != else_ops:
            ctx.report(self, node,
                       f"collective sequence diverges across branches "
                       f"({body_ops or 'none'} vs {else_ops or 'none'}); "
                       "hoist the collectives out of the branch or make "
                       "the condition replica-uniform")
            # one finding per divergent chain: the nested ifs (including
            # elifs, which parse as orelse=[If]) lie on the already-
            # reported divergent paths, so their own reports would be
            # duplicates of this one
            for branch in (node.body, node.orelse):
                for stmt in branch:
                    for sub in ast.walk(stmt):
                        if isinstance(sub, ast.If):
                            sub._rt006_covered = True

    def _collective_seq(self, stmts, ctx: Context) -> list[str]:
        ops: list[str] = []
        for stmt in stmts:
            self._collect(stmt, ctx, ops)
        return ops

    def _collect(self, node: ast.AST, ctx: Context, ops: list[str]):
        if isinstance(node, ast.If):
            # the test executes on every path that reaches this if, so
            # collectives in it belong to the enclosing sequence; the
            # branches are their own rendezvous check (on_if visits the
            # nested if too): when they agree the sequence counts once,
            # when they diverge the nested if reports and cascading the
            # outer comparison would only duplicate the finding
            self._collect(node.test, ctx, ops)
            ops.extend(self._collective_seq(node.body, ctx))
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # a nested def's body doesn't execute at this point
        if isinstance(node, ast.Call):
            op = ctx.collective_op(node.func)
            if op:
                ops.append(op)
        for child in ast.iter_child_nodes(node):
            self._collect(child, ctx, ops)


@register
class BareExceptAroundGet(Rule):
    id = "RT007"
    summary = "bare except swallowing errors around get()/wait()"
    rationale = ("get() re-raises remote task exceptions; a bare except "
                 "that doesn't re-raise turns a worker crash into silent "
                 "data loss")

    def on_try(self, node, ctx: Context):
        if not self._calls_get_or_wait(node.body, ctx):
            return
        for handler in node.handlers:
            if self._is_catch_all(handler) and not self._reraises(handler):
                ctx.report(self, handler,
                           "bare except around get()/wait(); catch specific "
                           "exceptions or re-raise so remote failures "
                           "propagate")

    on_trystar = on_try

    def _calls_get_or_wait(self, stmts, ctx: Context) -> bool:
        for stmt in stmts:
            for sub in ast.walk(stmt):
                if (isinstance(sub, ast.Call)
                        and ctx.framework_op(sub.func) in ("get", "wait")):
                    return True
        return False

    def _is_catch_all(self, handler: ast.ExceptHandler) -> bool:
        t = handler.type
        if t is None:
            return True
        return isinstance(t, ast.Name) and t.id == "BaseException"

    def _reraises(self, handler: ast.ExceptHandler) -> bool:
        return any(isinstance(sub, ast.Raise)
                   for stmt in handler.body for sub in ast.walk(stmt))


@register
class SleepInRemoteWithoutRetry(Rule):
    id = "RT008"
    summary = "time.sleep in a remote function without max_retries"
    rationale = ("a sleeping task pins its worker slot; without "
                 "max_retries a node failure during the sleep loses the "
                 "task silently instead of rescheduling it")

    def on_call(self, node: ast.Call, ctx: Context):
        frame = ctx.in_remote
        if (frame is not None and frame.kind == "task"
                and "max_retries" not in frame.decorator_kwargs
                and ctx.is_time_sleep(node.func)):
            ctx.report(self, node,
                       "time.sleep() in a remote task declared without "
                       "max_retries; add @remote(max_retries=...) or poll "
                       "via wait(timeout=...)")


@register
class OptionsRemoteInLoop(Rule):
    id = "RT009"
    summary = ".options(...).remote(...) inside a loop body"
    rationale = ("each .options() call forks a fresh handle and re-derives "
                 "its submission template (resources, normalized scheduling "
                 "strategy, placement target) per iteration, defeating the "
                 "per-handle template cache; hoist the .options() handle "
                 "out of the loop and call .remote() on it")

    def on_call(self, node: ast.Call, ctx: Context):
        if not ctx.uses_framework or not ctx.loop_depth:
            return
        f = node.func
        if not (isinstance(f, ast.Attribute) and f.attr == "remote"):
            return
        inner = f.value
        if (isinstance(inner, ast.Call)
                and isinstance(inner.func, ast.Attribute)
                and inner.func.attr == "options"):
            ctx.report(self, node,
                       ".options(...).remote(...) in a loop re-derives a "
                       "submission template every iteration; hoist "
                       "`h = fn.options(...)` above the loop and call "
                       "h.remote() inside it")


@register
class BlockingGetInAsync(Rule):
    id = "RT010"
    summary = "blocking get() inside an async def body"
    rationale = ("ray_tpu_torch.get() blocks its thread until the result lands; "
                 "inside a coroutine that thread IS the event loop, so "
                 "every other coroutine — including the completion "
                 "machinery that would resolve the ref — stalls behind it "
                 "(an async get path exists: await the ref)")

    def on_call(self, node: ast.Call, ctx: Context):
        if ctx.in_async and ctx.framework_op(node.func) == "get":
            ctx.report(self, node,
                       "blocking ray_tpu_torch.get() inside an async def stalls "
                       "the event loop; await the ObjectRef(s) directly "
                       "(or asyncio.gather them) instead")


@register
class SilentExceptionSwallow(Rule):
    id = "RT012"
    summary = "bare `except Exception: pass` (no logging, no re-raise)"
    rationale = ("an except-all whose whole body is `pass` eats every "
                 "failure signal on that path — real faults AND injected "
                 "chaos faults (devtools/chaos) vanish without a trace; "
                 "narrow the handler to the exception the site actually "
                 "expects, or log at debug before swallowing")

    def on_try(self, node, ctx: Context):
        for handler in node.handlers:
            if self._catch_all(handler) and self._only_pass(handler):
                caught = "except" if handler.type is None else \
                    f"except {handler.type.id}"
                ctx.report(self, handler,
                           f"`{caught}: pass` swallows every failure "
                           "silently; catch the specific expected "
                           "exception or log at debug before swallowing")

    on_trystar = on_try

    def _catch_all(self, handler: ast.ExceptHandler) -> bool:
        t = handler.type
        if t is None:
            return True
        return isinstance(t, ast.Name) and t.id in ("Exception",
                                                    "BaseException")

    def _only_pass(self, handler: ast.ExceptHandler) -> bool:
        return (len(handler.body) == 1
                and isinstance(handler.body[0], ast.Pass))


@register
class ConstantSleepRetryLoop(Rule):
    id = "RT013"
    summary = "retry loop sleeps a constant with no backoff/jitter"
    rationale = ("a loop that catches a failure and sleeps a fixed "
                 "literal hammers the struggling dependency at a fixed "
                 "cadence: every caller retries in lockstep (synchronized "
                 "herd) and the interval never widens to let the fault "
                 "clear; compute the delay from the attempt number "
                 "(exponential backoff) and jitter it")

    _SLEEPS = {("time", "sleep"), ("asyncio", "sleep")}

    def on_try(self, node, ctx: Context):
        # fires on the canonical retry shape: a try INSIDE a loop whose
        # except handler sleeps a literal constant. Sleeps on the loop's
        # normal path (polling) are deliberate pacing, not retry backoff,
        # and stay clean.
        if not ctx.loop_depth:
            return
        for handler in node.handlers:
            seen: set[int] = set()  # an awaited sleep walks as Await AND Call
            for stmt in handler.body:
                for sub in ast.walk(stmt):
                    call = sub.value if isinstance(sub, ast.Await) else sub
                    if id(call) in seen:
                        continue
                    seen.add(id(call))
                    if (isinstance(call, ast.Call)
                            and ctx.imports.resolve(call.func) in self._SLEEPS
                            and call.args
                            and isinstance(call.args[0], ast.Constant)
                            and isinstance(call.args[0].value, (int, float))):
                        ctx.report(self, call,
                                   "retry loop sleeps a constant "
                                   f"{call.args[0].value!r}s on failure; "
                                   "derive the delay from the attempt "
                                   "number (exponential backoff) and add "
                                   "jitter so retries neither hammer nor "
                                   "synchronize")

    on_trystar = on_try


_METRIC_CTORS = {"Counter", "Gauge", "Histogram"}


@register
class MetricConstructedPerCall(Rule):
    id = "RT011"
    summary = "Counter/Gauge/Histogram constructed inside a function or loop body"
    rationale = ("every metric construction registers in the process-wide "
                 "registry under its name: per-call construction churns "
                 "the registry (the old object with its accumulated "
                 "values is silently replaced and its history lost) and "
                 "leaks a dict entry per unique name; metrics are "
                 "module-level singletons by design")

    def on_call(self, node: ast.Call, ctx: Context):
        if not ctx.func_depth and not ctx.loop_depth:
            return
        origin = ctx.imports.resolve(node.func)
        if (origin and origin[0] == _FRAMEWORK_ROOT
                and origin[-1] in _METRIC_CTORS
                and "metrics" in origin[:-1]):
            where = "loop" if ctx.loop_depth else "function"
            ctx.report(self, node,
                       f"{origin[-1]}(...) constructed in a {where} body "
                       "re-registers in the global metrics registry every "
                       "call (accumulated values silently reset); hoist "
                       "the metric to module level")


@register
class MetricConstructedOnHotPath(Rule):
    id = "RT019"
    summary = "Counter/Gauge/Histogram constructed inside a hot-path root function"
    rationale = ("the rollup plane's per-task budget (<1µs, the "
                 "metrics_overhead_us bench arm) assumes hot paths only "
                 "touch pre-built metric cells; constructing a metric "
                 "inside a fast-lane pump, tunnel exec path, or serve "
                 "handler takes the registry lock and churns the name "
                 "table once per record — RT011's per-call class, but on "
                 "the paths where it costs throughput, caught without "
                 "the --flow pass")

    def on_call(self, node: ast.Call, ctx: Context):
        name = ctx.func_name
        if name is None:
            return
        from ray_tpu_torch.devtools.lint.effects import NAMED_ROOTS

        root_kind = NAMED_ROOTS.get(name)
        if root_kind is None:
            return
        origin = ctx.imports.resolve(node.func)
        if (origin and origin[0] == _FRAMEWORK_ROOT
                and origin[-1] in _METRIC_CTORS
                and "metrics" in origin[:-1]):
            ctx.report(self, node,
                       f"{origin[-1]}(...) constructed inside {name}() — a "
                       f"{root_kind} root: metrics are module-level "
                       "singletons; hot paths must only inc()/observe() "
                       "pre-built cells (per-record construction blows the "
                       "<1µs/task metrics budget)")


_SHARDED_PRODUCERS = {"put_sharded", "reshard"}


@register
class ShardedRefMaterializedOnDriver(Rule):
    id = "RT014"
    summary = "driver-side materialization of a ShardedObjectRef"
    rationale = ("a ShardedObjectRef is a manifest of per-host shm "
                 "shards; ray_tpu_torch.get()/np.asarray() on one outside a "
                 "worker gathers every shard's bytes through this one "
                 "process — exactly the driver funnel the sharded plane "
                 "exists to avoid; use get_sharded() (device-local "
                 "assembly) or pass the ref to a @remote(in_specs=...) "
                 "task so shards stay on their nodes")

    def __init__(self):
        self._sharded: set[str] = set()

    def on_functiondef(self, node: ast.FunctionDef, ctx: Context):
        # per-function scope: a name bound from put_sharded in one
        # function must not taint a same-named parameter or binding in
        # a later function (the engine's array_bindings save/restore
        # idiom, done rule-locally; nested defs trade a rare false
        # negative for no false positives)
        self._sharded.clear()

    on_asyncfunctiondef = on_functiondef

    def on_assign(self, node: ast.Assign, ctx: Context):
        # simple forward flow: names bound from put_sharded()/reshard()
        # calls (resolved through the import table, so rt.put_sharded,
        # ray_tpu_torch.sharded.reshard and bare imports all count) are
        # ShardedObjectRefs until rebound
        if len(node.targets) != 1 or not isinstance(node.targets[0],
                                                    ast.Name):
            return
        name = node.targets[0].id
        if isinstance(node.value, ast.Call):
            origin = ctx.imports.resolve(node.value.func)
            if (origin and origin[0] == _FRAMEWORK_ROOT
                    and origin[-1] in _SHARDED_PRODUCERS):
                self._sharded.add(name)
                return
        self._sharded.discard(name)

    def on_call(self, node: ast.Call, ctx: Context):
        if not self._sharded or ctx.in_remote:
            return  # inside a task/actor method the shards ARE local
        op = ctx.framework_op(node.func)
        numpy_op = ctx.is_numpy_ctor(node.func)
        if op != "get" and numpy_op not in ("asarray", "array"):
            return
        for arg in node.args:
            if isinstance(arg, ast.Name) and arg.id in self._sharded:
                fn = ("ray_tpu_torch.get" if op == "get"
                      else f"np.{numpy_op}")
                ctx.report(self, node,
                           f"{fn}({arg.id}) materializes a "
                           "ShardedObjectRef on the driver (every shard "
                           "funnels through this process); use "
                           "get_sharded() for device-local assembly or "
                           "consume it in a @remote(in_specs=...) task")
                return


@register
class BatchQueueConfiguredPerCall(Rule):
    id = "RT015"
    summary = ("serve.batch configured inside a request-path function "
               "body")
    rationale = ("@serve.batch builds ONE coalescing queue per wrapped "
                 "function: applying it (or calling serve.batch(fn, "
                 "max_batch_size=..., batch_wait_timeout_s=...)) inside "
                 "a handler body re-creates the wrapper — and therefore "
                 "a fresh empty queue — on every request, so no two "
                 "requests ever share a queue and batching silently "
                 "degenerates to batch-size-1 calls; declare the "
                 "batched method at class/module level")

    #: one-time setup bodies: building a batch wrapper here (e.g. with
    #: instance-derived knobs) creates ONE queue for the object's
    #: lifetime — the llm.serving LLMServer shape — not one per request
    _SETUP_FNS = ("__init__", "__post_init__", "reconfigure")

    def on_call(self, node: ast.Call, ctx: Context):
        # decorators/defaults are walked in the ENCLOSING scope (see
        # engine._walk_function), so a class-level @serve.batch(...) on
        # a method sits at func_depth 0 and stays clean; only a call
        # evaluated inside some function body — per request — fires
        if not ctx.func_depth or ctx.func_name in self._SETUP_FNS:
            return
        origin = ctx.imports.resolve(node.func)
        if not (origin and origin[0] == _FRAMEWORK_ROOT and origin[-1] == "batch"
                and ("serve" in origin[:-1] or "batching" in origin[:-1])):
            return
        knobs = [kw.arg for kw in node.keywords
                 if kw.arg in ("max_batch_size", "batch_wait_timeout_s")]
        detail = (f" (with {', '.join(knobs)} literals)"
                  if knobs and all(
                      isinstance(kw.value, ast.Constant)
                      for kw in node.keywords if kw.arg in knobs)
                  else "")
        ctx.report(self, node,
                   "serve.batch(...) evaluated inside a function body"
                   f"{detail} re-creates the batch queue per call, "
                   "defeating request coalescing; hoist the batched "
                   "method to class/module level")


@register
class HostSyncInDecodeLoop(Rule):
    id = "RT017"
    summary = ("host-device sync inside a request-path loop body")
    rationale = ("the decode loop exists to keep K steps queued on the "
                 "card per host round trip; a torch.cuda.synchronize(), "
                 "a stream's .synchronize(), or .item()/.tolist()/.cpu()/"
                 ".numpy()/.to(\"cpu\")/float()/int()/bool()/np.asarray() "
                 "of a CUDA tensor inside the loop body makes the host "
                 "wait for the card every ITERATION where the engine "
                 "budget is one wait per BLOCK. Copy once after the loop "
                 "(or once per block, as the engine's _HostCopy does: one "
                 "non-blocking copy per block read in _emit_block), and "
                 "keep the (token, position) carry on the card between "
                 "dispatches")

    def __init__(self):
        self._torch = None
        # calls already checked from on_assign (see there)
        self._seen: set[int] = set()

    def _syncs(self, ctx: Context):
        from ray_tpu_torch.devtools.lint.effects import TorchSyncs

        if self._torch is None:
            self._torch = TorchSyncs(ctx.imports)
        return self._torch

    def on_functiondef(self, node: ast.FunctionDef, ctx: Context):
        # per-function forward flow, the RT014 binding idiom: names bound
        # from torch calls are device tensors until rebound
        self._syncs(ctx).device.clear()

    on_asyncfunctiondef = on_functiondef

    def on_for(self, node: ast.For, ctx: Context):
        self._syncs(ctx).bind(node.target, node.iter)

    on_asyncfor = on_for

    def on_listcomp(self, node, ctx: Context):
        for gen in node.generators:
            self._syncs(ctx).bind(gen.target, gen.iter)

    on_setcomp = on_dictcomp = on_generatorexp = on_listcomp

    def on_assign(self, node: ast.Assign, ctx: Context):
        if len(node.targets) != 1:
            return
        # the hooks see the statement before its value's calls: check
        # those against the bindings they run under (`x = x.cpu()` syncs
        # on the old x), then rebind. Calls under a lambda or a
        # comprehension run in another loop context and are left to
        # on_call.
        stack = [node.value]
        while stack:
            sub = stack.pop()
            if isinstance(sub, (ast.Lambda, ast.ListComp, ast.SetComp,
                                ast.DictComp, ast.GeneratorExp)):
                continue
            if isinstance(sub, ast.Call):
                self._seen.add(id(sub))
                self._check(sub, ctx)
            stack.extend(ast.iter_child_nodes(sub))
        self._syncs(ctx).bind(node.targets[0], node.value)

    def on_call(self, node: ast.Call, ctx: Context):
        if id(node) not in self._seen:
            self._check(node, ctx)

    def _check(self, node: ast.Call, ctx: Context):
        if not ctx.loop_depth:
            return
        detail = self._syncs(ctx).sync(node)
        if detail is not None:
            ctx.report(self, node,
                       f"{detail} in a loop body makes the host wait for "
                       "the card every iteration; copy once per block (or "
                       "after the loop) instead")


@register
class SpanContextRederivedInLoop(Rule):
    id = "RT016"
    summary = ("fresh trace context constructed inside a request-path "
               "loop body")
    rationale = ("tracing.span(name, None, ...) / tracing.inject() / "
                 "tracing.submit_context() START a trace when no context "
                 "is given: inside a loop body each iteration mints a "
                 "NEW root (fresh trace_id, fresh head-sampling draw), "
                 "so one logical request shatters into N single-span "
                 "traces the assembler can never stitch — the RT011 "
                 "metric-in-loop shape, applied to spans. Capture the "
                 "context ONCE outside the loop (tracing.current() / "
                 "submit_context()) and pass it to every per-item span, "
                 "the way the worker pumps batch-stamp their records")

    def on_call(self, node: ast.Call, ctx: Context):
        if not ctx.loop_depth:
            return
        origin = ctx.imports.resolve(node.func)
        if not (origin and origin[0] == _FRAMEWORK_ROOT
                and "tracing" in origin[:-1]):
            return
        leaf = origin[-1]
        if leaf in ("inject", "submit_context"):
            ctx.report(self, node,
                       f"tracing.{leaf}() in a loop body re-derives the "
                       "trace context per iteration (a fresh ROOT trace "
                       "each time the contextvar is unset); hoist the "
                       "capture above the loop and reuse it")
            return
        if leaf != "span":
            return
        # the trace_ctx argument (2nd positional): missing or a literal
        # None means "start a fresh trace here" — per iteration
        tc = node.args[1] if len(node.args) >= 2 else None
        if tc is None:
            for kw in node.keywords:
                if kw.arg == "trace_ctx":
                    tc = kw.value
        if tc is None or (isinstance(tc, ast.Constant) and tc.value is None):
            ctx.report(self, node,
                       "tracing.span(...) opened in a loop body without "
                       "a trace context starts a NEW trace per "
                       "iteration; capture the parent context once "
                       "outside the loop and pass it explicitly")


# ---------------------------------------------------- RT018: schema drift
# the wire-bearing core modules: a raw record-prefix / status-flag literal
# in these files (or any file importing the fastpath/tunnel/schema
# modules) must exist in utils/schema.py's catalogs, or it is the
# shipped-but-uncataloged bug class
_WIRE_FILES = {"fastpath.py", "tunnel.py", "worker.py", "raylet.py",
               "core_client.py"}
_WIRE_IMPORTS = {(_FRAMEWORK_ROOT, "core", "fastpath"),
                 (_FRAMEWORK_ROOT, "core", "tunnel"),
                 (_FRAMEWORK_ROOT, "utils", "schema")}
# candidate flag literals: power-of-two ints in the reply-flag byte range
_FLAG_LO, _FLAG_HI = 0x100, 0x8000

_catalog_cache: tuple | None = None


def _wire_catalog() -> tuple:
    """(prefix chars, flag values) from utils/schema.py — imported lazily
    (pure-data module) so the linter stays importable standalone."""
    global _catalog_cache
    if _catalog_cache is None:
        from ray_tpu_torch.utils import schema

        _catalog_cache = (
            frozenset(schema.RECORD_PREFIXES),
            frozenset(f["value"] for f in schema.RECORD_FLAGS.values()),
        )
    return _catalog_cache


def _is_prefix_literal(node: ast.AST) -> str | None:
    """The single-uppercase-ASCII bytes literal shape (b"Q") wire record
    prefixes are written as."""
    if (isinstance(node, ast.Constant) and isinstance(node.value, bytes)
            and len(node.value) == 1 and node.value.isalpha()
            and node.value.isupper()):
        return node.value.decode("ascii")
    return None


@register
class WireSchemaLiteralDrift(Rule):
    id = "RT018"
    summary = ("wire record prefix / status-flag literal absent from the "
               "utils/schema.py catalog")
    rationale = ("every record prefix byte and reply status flag on the "
                 "wire must be cataloged in schema.RECORD_PREFIXES / "
                 "RECORD_FLAGS — the catalog is what test_wire_schema.py "
                 "machine-checks against the native header, so an "
                 "uncataloged literal ships a wire entry the version "
                 "gate and the docs never heard of (two such literals "
                 "shipped before the catalog and each cost a debugging "
                 "cycle); add the "
                 "catalog row in the same commit as the literal")

    def __init__(self):
        self._scoped: bool | None = None

    def _in_scope(self, ctx: Context) -> bool:
        if self._scoped is None:
            parts = os.path.normpath(ctx.path).split(os.sep)
            self._scoped = (
                (len(parts) >= 2 and parts[-2] == "core"
                 and parts[-1] in _WIRE_FILES)
                or any(origin[:3] in _WIRE_IMPORTS
                       for origin in ctx.imports.bindings.values()))
        return self._scoped

    def _check_prefix(self, node: ast.AST, ctx: Context):
        ch = _is_prefix_literal(node)
        if ch is None:
            return
        prefixes, _ = _wire_catalog()
        if ch not in prefixes:
            ctx.report(self, node,
                       f'record prefix b"{ch}" is not in '
                       "schema.RECORD_PREFIXES — catalog the new record "
                       "type (with its since-version) before it ships")

    # prefix bytes appear in frame construction (b"Q" + header + body)
    def on_binop(self, node: ast.BinOp, ctx: Context):
        if not self._in_scope(ctx):
            return
        if isinstance(node.op, ast.Add):
            for side in (node.left, node.right):
                self._check_prefix(side, ctx)
            return
        # flag literals appear in bitwise composition (status | 0x800)
        if isinstance(node.op, (ast.BitOr, ast.BitAnd)):
            for side in (node.left, node.right):
                self._check_flag_literal(side, ctx)

    def _check_flag_literal(self, node: ast.AST, ctx: Context):
        if (isinstance(node, ast.Constant) and isinstance(node.value, int)
                and _FLAG_LO <= node.value <= _FLAG_HI
                and node.value & (node.value - 1) == 0
                and node.value not in _wire_catalog()[1]):
            ctx.report(self, node,
                       f"status flag {node.value:#x} is not in "
                       "schema.RECORD_FLAGS — catalog the flag "
                       "(value + since-version) before it ships")

    # ...and in augmented form (status |= 0x800, status &= 0x800)
    def on_augassign(self, node: ast.AugAssign, ctx: Context):
        if not self._in_scope(ctx):
            return
        if isinstance(node.op, (ast.BitOr, ast.BitAnd)):
            self._check_flag_literal(node.value, ctx)

    # ...and in dispatch (kind == b"Q", kind in (b"A", b"C"))
    def on_compare(self, node: ast.Compare, ctx: Context):
        if not self._in_scope(ctx):
            return
        for comp in (node.left, *node.comparators):
            self._check_prefix(comp, ctx)
            if isinstance(comp, (ast.Tuple, ast.List, ast.Set)):
                for elt in comp.elts:
                    self._check_prefix(elt, ctx)

    # module-level NAMED_FLAG = 0x800 defining an uncataloged flag
    def on_assign(self, node: ast.Assign, ctx: Context):
        if not self._in_scope(ctx) or ctx.func_depth:
            return
        if len(node.targets) != 1 or not isinstance(node.targets[0],
                                                    ast.Name):
            return
        name = node.targets[0].id
        if not (name.isupper() and not name.startswith("_")):
            return
        v = node.value
        if (isinstance(v, ast.Constant) and isinstance(v.value, int)
                and _FLAG_LO <= v.value <= _FLAG_HI
                and v.value & (v.value - 1) == 0):
            _, flags = _wire_catalog()
            if v.value not in flags:
                ctx.report(self, node,
                           f"{name} = {v.value:#x} defines a status flag "
                           "absent from schema.RECORD_FLAGS — catalog it "
                           "(value + since-version) in the same commit")


# stream producers: attribute calls that return an incremental stream —
# the handle-level planes (.stream() per-item refs, .stream_chunks() "G"
# chunk records, .stream_deltas() producer) and the router legs beneath
# them. The attribute shape is unresolvable through imports (the receiver
# is a handle in a local), so RT024 gates on uses_framework like RT003.
_STREAM_PRODUCERS = {"stream", "stream_chunks", "stream_deltas",
                     "route_streaming", "route_streaming_async",
                     "route_stream_chunks"}


@register
class WholeStreamMaterialized(Rule):
    id = "RT024"
    summary = ("whole stream materialized into a list inside a function "
               "body")
    rationale = ("the streaming plane exists so chunks reach the consumer "
                 "as they are produced — TTFC tracks the FIRST decode "
                 "block and memory stays one chunk deep; `[x async for x "
                 "in stream]` or `list(stream)` buffers every chunk "
                 "before the caller sees one, so time-to-first-chunk "
                 "silently becomes total generation latency and the "
                 "buffer grows with max_tokens — a unary call with "
                 "streaming overhead; consume incrementally (async for) "
                 "or call the unary method")

    def __init__(self):
        self._streams: set[str] = set()

    def on_functiondef(self, node: ast.FunctionDef, ctx: Context):
        # per-function forward flow, the RT014 binding idiom: names bound
        # from stream-producer calls are streams until rebound
        self._streams.clear()

    on_asyncfunctiondef = on_functiondef

    def _is_producer(self, node: ast.AST, ctx: Context) -> bool:
        return (ctx.uses_framework
                and isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _STREAM_PRODUCERS)

    def on_assign(self, node: ast.Assign, ctx: Context):
        if len(node.targets) != 1 or not isinstance(node.targets[0],
                                                    ast.Name):
            return
        name = node.targets[0].id
        if self._is_producer(node.value, ctx):
            self._streams.add(name)
        else:
            self._streams.discard(name)

    def _check_source(self, it: ast.AST, node: ast.AST, how: str,
                      ctx: Context) -> bool:
        if isinstance(it, ast.Name) and it.id in self._streams:
            src = it.id
        elif self._is_producer(it, ctx):
            src = f".{it.func.attr}(...)"
        else:
            return False
        ctx.report(self, node,
                   f"{how} over the stream {src} buffers every chunk "
                   "before the caller sees the first one (TTFC becomes "
                   "total latency, memory grows with the generation); "
                   "consume it incrementally with `async for` / `for`, "
                   "or use the unary method")
        return True

    def on_listcomp(self, node, ctx: Context):
        if not ctx.func_depth:
            return
        for gen in node.generators:
            if self._check_source(gen.iter, node, "a comprehension", ctx):
                return

    on_setcomp = on_listcomp

    def on_call(self, node: ast.Call, ctx: Context):
        func = node.func
        if (not ctx.func_depth or not node.args
                or not (isinstance(func, ast.Name) and func.id == "list"
                        and ctx.imports.resolve(func) is None)):
            return
        self._check_source(node.args[0], node, "list()", ctx)


# ------------------------------------------- RT020-RT023: flow-pass rules
# Registered so `--rules` documents them and select/ignore validate, but
# they carry no on_* hooks: findings come from the interprocedural pass
# (ray_tpu_torch.devtools.lint.flow, `ray_tpu_torch lint --flow`), which reports the
# full root -> ... -> effect-site call chain per finding.
@register
class BlockingReachableFromHotRoot(Rule):
    id = "RT020"
    summary = ("blocking call reachable from an event-loop / hot-path "
               "root (flow pass)")
    rationale = ("a sleep, lock-wait, blocking get, file/socket read, or "
                 "subprocess wait anywhere in the call graph of an event-"
                 "loop callback or fast-lane pump parks the thread every "
                 "other callback shares — the class where one "
                 "blocking shm read on the default executor deadlocked "
                 "the whole process; RT001/RT010 catch the textually-"
                 "local case, this rule catches it any number of helper "
                 "hops away")


@register
class SyscallReachableFromHotRoot(Rule):
    id = "RT021"
    summary = ("per-call syscall reachable from a fast-lane / serve root "
               "(flow pass)")
    rationale = ("os.urandom / getpid / uuid4 / secrets cost a syscall "
                 "per invocation: on the submit fast path or a serve "
                 "handler that is a fixed per-record tax (~288µs of "
                 "urandom per request was once measured) — hoist the "
                 "entropy/identity read out of the hot path or cache it "
                 "per worker")


@register
class HostSyncReachableFromDeviceRegion(Rule):
    id = "RT022"
    summary = ("host-device sync reachable from a device region "
               "(flow pass)")
    rationale = ("torch.cuda.synchronize / .item() / .cpu() / float() on "
                 "a CUDA tensor reachable from a device region (an "
                 "inference_mode or no_grad program, an autograd.Function's "
                 "forward/backward, a torch.library kernel, a CUDA-graph "
                 "body, a named training step) drains the queue of work "
                 "the region exists to keep full — RT017's idiom "
                 "generalized across helper calls")


@register
class AllocReachableFromHotRoot(Rule):
    id = "RT023"
    summary = ("registry-churning construction reachable from a hot root "
               "(flow pass)")
    rationale = ("metrics Counter/Gauge/Histogram, fresh trace roots, "
                 "serve.batch wrappers, and queue objects are build-once "
                 "objects: constructing one anywhere under a fast-lane "
                 "pump or serve handler churns registries and allocators "
                 "per record — the RT011/RT015/RT016 class, caught "
                 "through call hops")
