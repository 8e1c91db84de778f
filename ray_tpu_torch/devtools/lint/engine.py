"""raylint engine: AST walk, framework-name resolution, rule dispatch.

The linter is framework-aware: rules don't pattern-match on bare
identifiers, they resolve names through the module's import table so
`rt.get(...)`, `ray_tpu_torch.core.api.get(...)` and `from ray_tpu_torch
import get; get(...)` all canonicalise to the same `get` op, while an unrelated
`cache.get(...)` resolves to nothing.

Suppression: a finding is dropped when its physical line carries
`# raylint: disable=RT001[,RT002|all]`, or the file carries
`# raylint: disable-file=RT001` anywhere (conventionally the header).
"""
from __future__ import annotations

import ast
import io
import json
import math
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Iterable, Sequence

# ------------------------------------------------------------------ findings
@dataclass(frozen=True)
class Finding:
    rule_id: str
    message: str
    path: str
    line: int
    col: int

    def as_dict(self) -> dict:
        # stable key order for JSON output (tested by test_json_stability)
        return {
            "rule": self.rule_id,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule_id} {self.message}"


PARSE_RULE_ID = "RT000"  # synthetic rule for files that fail to parse

# ------------------------------------------------------------------ registry
RULES: dict[str, type] = {}


def register(cls):
    """Class decorator adding a Rule subclass to the global registry."""
    if cls.id in RULES:
        raise ValueError(f"duplicate rule id {cls.id}")
    RULES[cls.id] = cls
    return cls


class Rule:
    """Base rule. Subclasses set id/summary/rationale and implement any of
    the `on_<nodetype>` hooks (on_call, on_functiondef, on_expr, on_if,
    on_try); the engine dispatches during a single AST walk."""

    id: str = ""
    summary: str = ""
    rationale: str = ""


def rule_table() -> list[dict]:
    return [
        {"id": rid, "summary": cls.summary, "rationale": cls.rationale}
        for rid, cls in sorted(RULES.items())
    ]


# ------------------------------------------------------------- import table
_FRAMEWORK_ROOT = "ray_tpu_torch"
_NUMPY_ROOT = ("numpy",)
_TORCH_ROOT = ("torch",)


class ImportTable:
    """Maps local names to fully-dotted origin paths.

    `import ray_tpu_torch as rt`     -> rt: ("ray_tpu_torch",)
    `from ray_tpu_torch import get`  -> get: ("ray_tpu_torch", "get")
    `import numpy.random as npr`     -> npr: ("numpy", "random")
    `import a.b.c`                -> a: ("a",)   (attribute walk supplies b.c)
    """

    def __init__(self):
        self.bindings: dict[str, tuple[str, ...]] = {}

    def collect(self, tree: ast.AST):
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    parts = tuple(alias.name.split("."))
                    if alias.asname:
                        self.bindings[alias.asname] = parts
                    else:
                        self.bindings[parts[0]] = parts[:1]
            elif isinstance(node, ast.ImportFrom):
                if node.level or not node.module:
                    continue  # relative imports: origin unknown, stay silent
                base = tuple(node.module.split("."))
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    self.bindings[alias.asname or alias.name] = base + (alias.name,)

    def resolve(self, node: ast.AST) -> tuple[str, ...] | None:
        """Resolve a Name/Attribute chain to a dotted origin path."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        origin = self.bindings.get(node.id)
        if origin is None:
            return None
        return origin + tuple(reversed(parts))


# ------------------------------------------------------------------ context
@dataclass
class RemoteFrame:
    node: ast.AST
    kind: str  # "task" | "actor_method"
    decorator_kwargs: frozenset = frozenset()


@dataclass
class Context:
    path: str
    imports: ImportTable
    findings: list[Finding] = field(default_factory=list)
    remote_stack: list[RemoteFrame] = field(default_factory=list)
    # target-name sets of the enclosing for-loops/comprehensions; RT002
    # fires only when a get() argument references one of these (a while
    # poll loop or wait()-then-get-one streaming is NOT a loop over refs)
    for_targets: list[set] = field(default_factory=list)
    # name -> element count, for numpy/torch arrays bound in the current scope
    # (simple forward-flow map used by RT004's closure-capture check)
    array_bindings: dict[str, int] = field(default_factory=dict)
    # nesting depth of enclosing loop BODIES (for/while/comprehension)
    # within the current function scope; unlike for_targets this also
    # counts while-loops — RT009 fires on any per-iteration re-derivation
    loop_depth: int = 0
    # True while walking the body of an `async def` (reset inside nested
    # sync defs and lambdas: their bodies run on whatever thread calls
    # them, not necessarily the event loop) — RT010's blocking-call scope
    in_async: bool = False
    # nesting depth of enclosing function/lambda BODIES; unlike
    # loop_depth this survives into nested defs — RT011 fires on any
    # construction that re-runs per call rather than once at import
    func_depth: int = 0
    # name of the innermost enclosing def (None at module/class scope;
    # lambdas keep the enclosing def's name) — RT015 exempts one-time
    # setup bodies like __init__ by name
    func_name: str | None = None

    # -- reporting ----------------------------------------------------------
    def report(self, rule: Rule, node: ast.AST, message: str):
        self.findings.append(Finding(
            rule_id=rule.id, message=message, path=self.path,
            line=getattr(node, "lineno", 0), col=getattr(node, "col_offset", 0),
        ))

    # -- framework queries --------------------------------------------------
    @property
    def uses_framework(self) -> bool:
        """True when the module imports ray_tpu_torch at all. Gates the rules
        that match on the `.remote()` attribute shape (unresolvable
        through the import table — the callee is a task/actor handle in a
        local variable), so an unrelated library's `.remote()` in a module
        that never touches ray_tpu_torch stays clean."""
        return any(origin[0] == _FRAMEWORK_ROOT
                   for origin in self.imports.bindings.values())

    @property
    def in_remote(self) -> RemoteFrame | None:
        return self.remote_stack[-1] if self.remote_stack else None

    def loops_over(self, node: ast.AST) -> bool:
        """True when `node`'s subtree references a target bound by an
        enclosing for-loop or comprehension."""
        if not self.for_targets:
            return False
        bound = set().union(*self.for_targets)
        return any(isinstance(sub, ast.Name) and sub.id in bound
                   for sub in ast.walk(node))

    def framework_op(self, func: ast.AST) -> str | None:
        """Canonical op name ("get"/"put"/"wait"/"remote") for a call target
        that resolves into the ray_tpu_torch API, else None."""
        origin = self.imports.resolve(func)
        if not origin or origin[0] != _FRAMEWORK_ROOT:
            return None
        if origin[-1] in ("get", "put", "wait", "remote"):
            return origin[-1]
        return None

    def collective_op(self, func: ast.AST) -> str | None:
        """Op name for a call into ray_tpu_torch.collective (allreduce, barrier,
        ...), else None."""
        origin = self.imports.resolve(func)
        if not origin or origin[0] != _FRAMEWORK_ROOT:
            return None
        if "collective" in origin[:-1]:
            return origin[-1]
        return None

    def is_numpy_ctor(self, func: ast.AST) -> str | None:
        origin = self.imports.resolve(func)
        if not origin or origin[: len(_NUMPY_ROOT)] != _NUMPY_ROOT:
            return None
        return origin[-1]

    def array_ctor(self, func: ast.AST) -> tuple[str, str] | None:
        """("numpy"|"torch", function name) for a call into numpy or
        torch (RT004's array roots), else None."""
        origin = self.imports.resolve(func)
        if not origin:
            return None
        for root in (_NUMPY_ROOT, _TORCH_ROOT):
            if origin[: len(root)] == root:
                return root[0], origin[-1]
        return None

    def is_time_sleep(self, func: ast.AST) -> bool:
        return self.imports.resolve(func) == ("time", "sleep")

    def remote_decorator(self, node: ast.AST) -> frozenset | None:
        """If `node` (Function/ClassDef) carries a framework @remote
        decorator, return the decorator-call kwarg names (empty frozenset
        for the bare form); else None."""
        for deco in getattr(node, "decorator_list", []):
            if isinstance(deco, ast.Call):
                if self.framework_op(deco.func) == "remote":
                    return frozenset(
                        kw.arg for kw in deco.keywords if kw.arg)
            elif self.framework_op(deco) == "remote":
                return frozenset()
        return None


# ------------------------------------------------------------------- walker
_LOOP_TYPES = (ast.For, ast.AsyncFor, ast.While)
_COMP_TYPES = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)


class Walker:
    """Single-pass AST walk with manual recursion for the node types that
    change context (defs, classes, loops, comprehensions), dispatching each
    node to every enabled rule's `on_<type>` hook."""

    def __init__(self, ctx: Context, rules: Sequence[Rule]):
        self.ctx = ctx
        self.rules = rules
        self._hooks: dict[str, list] = {}

    def _dispatch(self, node: ast.AST):
        key = type(node).__name__.lower()
        hooks = self._hooks.get(key)
        if hooks is None:
            hooks = [h for rule in self.rules
                     if (h := getattr(rule, f"on_{key}", None))]
            self._hooks[key] = hooks
        for hook in hooks:
            hook(node, self.ctx)

    def walk(self, node: ast.AST):
        self._dispatch(node)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._walk_function(node)
        elif isinstance(node, ast.Lambda):
            self._walk_lambda(node)
        elif isinstance(node, ast.ClassDef):
            self._walk_class(node)
        elif isinstance(node, _LOOP_TYPES):
            self._walk_loop(node)
        elif isinstance(node, _COMP_TYPES):
            self._walk_comprehension(node)
        else:
            if isinstance(node, ast.Assign):
                self._record_array_binding(node)
            for child in ast.iter_child_nodes(node):
                self.walk(child)

    # -- context-bearing node types ----------------------------------------
    def _walk_function(self, node):
        ctx = self.ctx
        deco_kwargs = ctx.remote_decorator(node)
        frame = None
        if deco_kwargs is not None:
            frame = RemoteFrame(node, "task", deco_kwargs)
        elif getattr(node, "_rt_actor_method", False):
            frame = RemoteFrame(node, "actor_method")
        # decorators and defaults evaluate in the enclosing scope
        for deco in node.decorator_list:
            self.walk(deco)
        for default in [*node.args.defaults, *node.args.kw_defaults]:
            if default is not None:
                self.walk(default)
        if frame is not None:
            ctx.remote_stack.append(frame)
        saved_arrays = dict(ctx.array_bindings)
        saved_targets = ctx.for_targets
        saved_depth = ctx.loop_depth
        saved_async = ctx.in_async
        saved_name = ctx.func_name
        ctx.for_targets = []  # a nested def body doesn't run per-iteration
        ctx.loop_depth = 0
        ctx.in_async = isinstance(node, ast.AsyncFunctionDef)
        ctx.func_depth += 1
        ctx.func_name = node.name
        for stmt in node.body:
            self.walk(stmt)
        ctx.func_depth -= 1
        ctx.func_name = saved_name
        ctx.for_targets = saved_targets
        ctx.loop_depth = saved_depth
        ctx.in_async = saved_async
        ctx.array_bindings = saved_arrays
        if frame is not None:
            ctx.remote_stack.pop()

    def _walk_lambda(self, node: ast.Lambda):
        ctx = self.ctx
        # defaults evaluate eagerly in the enclosing scope; the body is
        # deferred and doesn't run per-iteration of any enclosing loop
        for default in [*node.args.defaults, *node.args.kw_defaults]:
            if default is not None:
                self.walk(default)
        saved_targets = ctx.for_targets
        saved_depth = ctx.loop_depth
        saved_async = ctx.in_async
        ctx.for_targets = []
        ctx.loop_depth = 0
        ctx.in_async = False  # deferred body: caller's thread, not the loop
        ctx.func_depth += 1
        self.walk(node.body)
        ctx.func_depth -= 1
        ctx.for_targets = saved_targets
        ctx.loop_depth = saved_depth
        ctx.in_async = saved_async

    def _walk_class(self, node: ast.ClassDef):
        is_actor = self.ctx.remote_decorator(node) is not None
        for deco in node.decorator_list:
            self.walk(deco)
        for stmt in node.body:
            if is_actor and isinstance(stmt, (ast.FunctionDef,
                                              ast.AsyncFunctionDef)):
                stmt._rt_actor_method = True
            self.walk(stmt)

    def _walk_loop(self, node):
        ctx = self.ctx
        if isinstance(node, (ast.For, ast.AsyncFor)):
            self.walk(node.iter)  # evaluated once, outside the loop
            self.walk(node.target)
            ctx.for_targets.append(_target_names(node.target))
            ctx.loop_depth += 1
            for stmt in node.body:
                self.walk(stmt)
            ctx.loop_depth -= 1
            ctx.for_targets.pop()
        else:  # While: no bound targets, but still a per-iteration body
            self.walk(node.test)
            ctx.loop_depth += 1
            for stmt in node.body:
                self.walk(stmt)
            ctx.loop_depth -= 1
        for stmt in node.orelse:
            self.walk(stmt)

    def _walk_comprehension(self, node):
        ctx = self.ctx
        gens = node.generators
        self.walk(gens[0].iter)  # first iterable evaluates once
        ctx.for_targets.append(
            set().union(*[_target_names(g.target) for g in gens]))
        ctx.loop_depth += 1
        for gen in gens:
            self.walk(gen.target)
            if gen is not gens[0]:
                self.walk(gen.iter)
            for cond in gen.ifs:
                self.walk(cond)
        if isinstance(node, ast.DictComp):
            self.walk(node.key)
            self.walk(node.value)
        else:
            self.walk(node.elt)
        ctx.loop_depth -= 1
        ctx.for_targets.pop()

    # -- RT004 dataflow -----------------------------------------------------
    def _record_array_binding(self, node: ast.Assign):
        if len(node.targets) != 1 or not isinstance(node.targets[0], ast.Name):
            return
        size = literal_array_size(node.value, self.ctx)
        if size is not None:
            self.ctx.array_bindings[node.targets[0].id] = size
        else:
            self.ctx.array_bindings.pop(node.targets[0].id, None)


def _target_names(target: ast.AST) -> set:
    return {sub.id for sub in ast.walk(target) if isinstance(sub, ast.Name)}


# --------------------------------------------------- RT004 size estimation
_SIZED_CTORS = {"zeros", "ones", "full", "empty", "zeros_like", "ones_like"}
_TORCH_SIZED_CTORS = {"zeros", "ones", "empty", "full", "rand", "randn"}


def literal_array_size(node: ast.AST, ctx: Context) -> int | None:
    """Element count of a numpy or torch constructor call whose shape is
    written as literals; None when it isn't such a call or the size is not
    static."""
    if not isinstance(node, ast.Call):
        return None
    found = ctx.array_ctor(node.func)
    if found is None or not node.args:
        return None
    root, ctor = found
    if ctor == "arange":
        vals = [_literal_int(a) for a in node.args[:3]]
        if any(v is None for v in vals):
            return None
        if len(vals) == 1:
            start, stop, step = 0, vals[0], 1
        elif len(vals) == 2:
            start, stop, step = vals[0], vals[1], 1
        else:
            start, stop, step = vals
        if step == 0:
            return None
        return max(0, math.ceil((stop - start) / step))
    if root == "torch" and ctor in _TORCH_SIZED_CTORS:
        # torch.zeros(4096, 4096) is torch.zeros((4096, 4096)); full's
        # second argument is the fill value
        if len(node.args) == 1 or ctor == "full":
            return _literal_shape_size(node.args[0])
        return _literal_shape_size(ast.Tuple(elts=node.args))
    if root == "numpy" and ctor in _SIZED_CTORS:
        return _literal_shape_size(node.args[0])
    return None


def _literal_int(node: ast.AST) -> int | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    return None


def _literal_shape_size(node: ast.AST) -> int | None:
    if isinstance(node, (ast.Tuple, ast.List)):
        total = 1
        for elt in node.elts:
            dim = _literal_int(elt)
            if dim is None:
                return None
            total *= dim
        return total
    return _literal_int(node)


# -------------------------------------------------------------- suppression
_SUPPRESS_RE = re.compile(
    r"#\s*raylint:\s*disable(-file)?\s*=\s*"
    r"((?:RT\d+|all)(?:\s*,\s*(?:RT\d+|all))*)")


def parse_suppressions(source: str) -> tuple[dict[int, set], set]:
    """Returns (line -> rule-ids suppressed on that line, file-wide ids).
    The token `all` suppresses every rule.

    Only real COMMENT tokens count: a directive quoted inside a string or
    docstring (e.g. documentation of the syntax itself) must not become a
    live suppression."""
    per_line: dict[int, set] = {}
    file_wide: set = set()
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return per_line, file_wide  # unparseable: RT000 already reported
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        ids = {t.strip() for t in m.group(2).split(",") if t.strip()}
        if m.group(1):
            file_wide |= ids
        else:
            per_line.setdefault(tok.start[0], set()).update(ids)
    return per_line, file_wide


def _suppressed(f: Finding, per_line: dict[int, set], file_wide: set) -> bool:
    ids = per_line.get(f.line, set()) | file_wide
    return f.rule_id in ids or "all" in ids


# ----------------------------------------------------------------- running
def _instantiate(select: Iterable[str] | None = None,
                 ignore: Iterable[str] | None = None) -> list[Rule]:
    unknown = (set(select or ()) | set(ignore or ())) - set(RULES)
    if unknown:
        raise ValueError(f"unknown rule ids: {sorted(unknown)}")
    wanted = set(select) if select else set(RULES)
    if ignore:
        wanted -= set(ignore)
    if not wanted:
        # a zero-rule run reporting "0 findings" would be a green gate
        # that checked nothing
        raise ValueError("select/ignore leave no rules enabled")
    return [RULES[rid]() for rid in sorted(wanted)]


def lint_source(source: str, path: str = "<string>", *,
                select=None, ignore=None) -> list[Finding]:
    """Lint one source string; returns unsuppressed findings, sorted."""
    import ray_tpu_torch.devtools.lint.rules  # noqa: F401  (registers RT001-RT024)

    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(PARSE_RULE_ID, f"syntax error: {e.msg}", path,
                        e.lineno or 0, (e.offset or 1) - 1)]
    imports = ImportTable()
    imports.collect(tree)
    ctx = Context(path=path, imports=imports)
    Walker(ctx, _instantiate(select, ignore)).walk(tree)
    per_line, file_wide = parse_suppressions(source)
    kept = [f for f in ctx.findings if not _suppressed(f, per_line, file_wide)]
    return sorted(kept, key=lambda f: (f.path, f.line, f.col, f.rule_id))


def iter_python_files(paths: Iterable[str]) -> list[str]:
    paths = list(paths)
    out = []
    for path in paths:
        if os.path.isdir(path):
            for dirpath, dirnames, filenames in os.walk(path):
                # prune only cache/VCS dirs: skipping a broader name like
                # "build" could silently exclude real source from the gate
                dirnames[:] = sorted(
                    d for d in dirnames
                    if d not in ("__pycache__", ".git"))
                out.extend(os.path.join(dirpath, f)
                           for f in sorted(filenames) if f.endswith(".py"))
        elif os.path.isfile(path):
            out.append(path)  # explicit file arg: lint it, .py or not
        else:
            # a typo'd path silently reporting "0 findings" would leave a
            # CI gate green while linting nothing
            raise FileNotFoundError(f"{path}: no such file or directory")
    if not out:
        # same CI-gate reasoning: a renamed/emptied package must not
        # report a green "0 findings" over zero linted files
        raise FileNotFoundError(
            f"no python files found under: {', '.join(paths)}")
    return out


def lint_paths(paths: Iterable[str], *, select=None, ignore=None) -> list[Finding]:
    findings: list[Finding] = []
    for fp in iter_python_files(paths):
        with open(fp, encoding="utf-8") as f:
            findings.extend(lint_source(f.read(), fp,
                                        select=select, ignore=ignore))
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule_id))


def to_json(findings: Sequence[Finding]) -> str:
    return json.dumps([f.as_dict() for f in findings], indent=2,
                      sort_keys=False)
