"""raylint interprocedural pass: call-graph coloring for hot-path effects.

RT001-RT017 catch hot-path anti-patterns only when the offending call
sits textually inside the hot function — one helper hop and they are
blind. This pass closes that hole:

  1. a package-wide call graph over the modules being linted — direct
     calls, method calls (class-attribute resolution: `self.meth`,
     `self.attr.meth` via `self.attr = ClassName(...)` in any method,
     local `x = ClassName(...)` forward flow, inheritance walk),
     asyncio callback edges (call_soon/_threadsafe/call_later,
     create_task/ensure_future), executor-submit edges
     (run_in_executor/submit, the default executor distinguished from
     private pools), thread targets, functools.partial unwrapping, and
     `fn.remote()` dispatch edges;
  2. effect inference per function (effects.EffectScanner) propagated
     to fixpoint through the graph, each edge kind masking the effects
     that traverse it (effects.EDGE_MASKS);
  3. context roots coloring the graph — named hot functions
     (effects.NAMED_ROOTS), every call_soon-family callback, and every
     device region: functions decorated with torch.inference_mode() or
     torch.no_grad(), forward/backward of torch.autograd.Function
     subclasses, kernels handed to torch.library (Library.impl,
     register_autograd), callables passed to make_graphed_callables and
     functions called under `with torch.cuda.graph(...)` — each with a
     forbidden-effect set (effects.ROOT_FORBIDS).

A finding (RT020-RT023) fires when a forbidden effect is REACHABLE from
a colored root, and reports the full call chain root -> ... -> effect
site. Findings anchor at the effect site (the line you fix or
`# raylint: disable=RT02x` — the engine's per-line suppressions apply),
and carry a line-stable key `rule:sink_qualname:detail` consumed by the
`.raylint_torch_baseline.json` mechanism so the self-check gate stays
adoptable as the package grows (a name of its own: the JAX package's
gate reads `.raylint_baseline.json`, and neither reads the other's).
"""
from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field

from ray_tpu_torch.devtools.lint import effects as fx
from ray_tpu_torch.devtools.lint.engine import (
    Finding,
    iter_python_files,
    parse_suppressions,
)

_CALL_SOON = {"call_soon", "call_soon_threadsafe"}
_CALL_LATER = {"call_later", "call_at"}
_TASK_CTORS = {"create_task", "ensure_future"}
# decorators that run a function with autograd off: its body only queues
# work on the card (the counterparts of JAX's jitted programs)
_DEVICE_DECORATORS = {("torch", "inference_mode"), ("torch", "no_grad")}
_AUTOGRAD_FUNCTION = ("autograd", "Function")
_GRAPHED = ("cuda", "make_graphed_callables")
_CUDA_GRAPH = ("cuda", "graph")


# ------------------------------------------------------------- module model
class ModuleImports:
    """engine.ImportTable semantics plus relative-import resolution: the
    engine stays silent on `from . import api` (origin unknown for a
    lone file), but the flow pass knows each module's dotted name, so
    in-package relative imports resolve to absolute origins."""

    def __init__(self, module_parts: tuple, is_package: bool):
        self.bindings: dict[str, tuple] = {}
        self._pkg = module_parts if is_package else module_parts[:-1]

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
                if node.level:
                    base = self._pkg
                    if node.level > 1:
                        cut = len(base) - (node.level - 1)
                        if cut < 0:
                            continue
                        base = base[:cut]
                    if node.module:
                        base = base + tuple(node.module.split("."))
                elif node.module:
                    base = tuple(node.module.split("."))
                else:
                    continue
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    self.bindings[alias.asname or alias.name] = \
                        base + (alias.name,)

    def resolve(self, node: ast.AST):
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        origin = self.bindings.get(node.id)
        if origin is None:
            return None
        return origin + tuple(reversed(parts))


@dataclass
class FuncInfo:
    qualname: str            # fully dotted: "pkg.mod:Class.meth"
    local_name: str          # leaf name
    module: "ModuleInfo"
    node: ast.AST
    path: str
    line: int
    is_async: bool
    class_name: str | None = None
    edges: list = field(default_factory=list)     # list[CallEdge]
    sites: list = field(default_factory=list)     # list[fx.EffectSite]
    root_kind: str | None = None
    root_cause: str = ""     # how it got colored, for finding messages


@dataclass
class CallEdge:
    caller: FuncInfo
    callee: FuncInfo
    kind: str    # key into effects.EDGE_MASKS
    line: int    # call-site line in the caller's file


@dataclass
class ClassInfo:
    name: str
    module: "ModuleInfo"
    bases: list = field(default_factory=list)        # raw origin tuples
    methods: dict = field(default_factory=dict)      # name -> FuncInfo
    attr_classes: dict = field(default_factory=dict)  # self.X -> origin


@dataclass
class ModuleInfo:
    name: str                # dotted
    path: str
    imports: ModuleImports = None
    functions: dict = field(default_factory=dict)    # local qualname -> Func
    classes: dict = field(default_factory=dict)      # name -> ClassInfo
    body: list = field(default_factory=list)         # module-level stmts
    libraries: set = field(default_factory=set)      # torch.library.Library names


def _module_name_parts(path: str) -> tuple[tuple, bool]:
    """Dotted module parts for a file, walking up through __init__.py
    package markers; (parts, is_package)."""
    path = os.path.abspath(path)
    base = os.path.basename(path)
    is_pkg = base == "__init__.py"
    parts = [] if is_pkg else [os.path.splitext(base)[0]]
    d = os.path.dirname(path)
    while os.path.isfile(os.path.join(d, "__init__.py")):
        parts.append(os.path.basename(d))
        d = os.path.dirname(d)
    if not parts:  # a bare __init__.py with no package parent
        parts = [os.path.splitext(base)[0]]
    return tuple(reversed(parts)), is_pkg


# ---------------------------------------------------------------- the graph
class CallGraph:
    def __init__(self):
        self.modules: dict[str, ModuleInfo] = {}
        self.functions: dict[str, FuncInfo] = {}   # fully dotted qualname
        self.roots: list[FuncInfo] = []

    # -- construction -------------------------------------------------------
    @classmethod
    def build(cls, paths) -> "CallGraph":
        g = cls()
        for fp in iter_python_files(paths):
            g._index_file(fp)
        g._seed_attr_classes()
        for mod in g.modules.values():
            g._color_module_level(mod)
            g._collect_edges_and_effects(mod)
        g._finish_roots()
        return g

    def _seed_attr_classes(self):
        """self.X = ClassName(...) in any method registers X's class on
        the owning ClassInfo, enabling `self.X.meth()` resolution."""
        for mod in self.modules.values():
            for ci in mod.classes.values():
                for meth in ci.methods.values():
                    for sub in ast.walk(meth.node):
                        if not isinstance(sub, ast.Assign) \
                                or len(sub.targets) != 1:
                            continue
                        t = sub.targets[0]
                        if not (isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"
                                and isinstance(sub.value, ast.Call)):
                            continue
                        fn2 = sub.value.func
                        target = None
                        if isinstance(fn2, ast.Name) \
                                and fn2.id in mod.classes:
                            target = mod.classes[fn2.id]
                        else:
                            origin = mod.imports.resolve(fn2)
                            if origin:
                                target = self.resolve_class(origin)
                        if target is not None \
                                and t.attr not in ci.attr_classes:
                            ci.attr_classes[t.attr] = target

    def _index_file(self, path: str):
        with open(path, encoding="utf-8") as f:
            source = f.read()
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError:
            return  # the AST pass already reports RT000
        parts, is_pkg = _module_name_parts(path)
        mod = ModuleInfo(name=".".join(parts), path=path)
        mod.imports = ModuleImports(parts, is_pkg)
        mod.imports.collect(tree)
        mod.body = tree.body
        for stmt in tree.body:
            # _LIB = torch.library.Library(...): _LIB.impl(...) registers
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and isinstance(stmt.value, ast.Call)):
                origin = mod.imports.resolve(stmt.value.func)
                if origin and tuple(origin[-2:]) == ("library", "Library"):
                    mod.libraries.add(stmt.targets[0].id)
        self.modules[mod.name] = mod
        self._index_scope(mod, tree.body, prefix="", class_name=None)

    def _index_scope(self, mod: ModuleInfo, stmts, prefix: str,
                     class_name: str | None):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                local = prefix + stmt.name
                fn = FuncInfo(
                    qualname=f"{mod.name}:{local}", local_name=stmt.name,
                    module=mod, node=stmt, path=mod.path, line=stmt.lineno,
                    is_async=isinstance(stmt, ast.AsyncFunctionDef),
                    class_name=class_name)
                mod.functions[local] = fn
                self.functions[fn.qualname] = fn
                if class_name and prefix == f"{class_name}.":
                    mod.classes[class_name].methods[stmt.name] = fn
                self._check_device_marks(mod, fn)
                # nested defs: their own nodes, one more prefix level
                self._index_scope(mod, stmt.body,
                                  prefix=local + ".<locals>.",
                                  class_name=None)
            elif isinstance(stmt, ast.ClassDef) and class_name is None \
                    and not prefix:
                ci = ClassInfo(name=stmt.name, module=mod)
                for b in stmt.bases:
                    origin = mod.imports.resolve(b)
                    if origin is None and isinstance(b, ast.Name):
                        origin = tuple(mod.name.split(".")) + (b.id,)
                    if origin:
                        ci.bases.append(origin)
                mod.classes[stmt.name] = ci
                self._index_scope(mod, stmt.body, prefix=f"{stmt.name}.",
                                  class_name=stmt.name)

    def _check_device_marks(self, mod: ModuleInfo, fn: FuncInfo):
        for deco in getattr(fn.node, "decorator_list", []):
            target = deco.func if isinstance(deco, ast.Call) else deco
            origin = mod.imports.resolve(target)
            if origin and tuple(origin[-2:]) in _DEVICE_DECORATORS:
                self._color(fn, "device-region", f"@{'.'.join(origin)}")
        if fn.class_name and fn.local_name in ("forward", "backward") and any(
                tuple(b[-2:]) == _AUTOGRAD_FUNCTION
                for b in mod.classes[fn.class_name].bases):
            self._color(fn, "device-region",
                        f"autograd.Function {fn.local_name}")

    def _color_module_level(self, mod: ModuleInfo):
        """Device regions registered by module-level statements (the
        torch.library registrations sit at import time, outside any
        function the call graph visits)."""
        stack = list(mod.body)
        while stack:
            sub = stack.pop()
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef, ast.Lambda)):
                continue  # bodies: the per-function visitor's
            stack.extend(ast.iter_child_nodes(sub))
            if isinstance(sub, ast.Call):
                for ref, cause in device_targets(sub, mod):
                    origin = mod.imports.resolve(ref)
                    target = (self.resolve_func(origin) if origin
                              else mod.functions.get(getattr(ref, "id", "")))
                    if target is not None:
                        self._color(target, "device-region",
                                    f"{cause} at {_rel(mod.path)}:{sub.lineno}")

    def _color(self, fn: FuncInfo, kind: str, cause: str):
        if fn.root_kind is None:
            fn.root_kind = kind
            fn.root_cause = cause

    # -- cross-module resolution --------------------------------------------
    def resolve_func(self, origin, depth: int = 0) -> FuncInfo | None:
        """Origin tuple -> FuncInfo, chasing package __init__ re-exports."""
        if not origin or depth > 6:
            return None
        for i in range(len(origin) - 1, 0, -1):
            mod = self.modules.get(".".join(origin[:i]))
            if mod is None:
                continue
            rest = origin[i:]
            if len(rest) == 1:
                if rest[0] in mod.functions:
                    return mod.functions[rest[0]]
                if rest[0] in mod.classes:
                    return self.lookup_method(mod.classes[rest[0]],
                                              "__init__")
            elif len(rest) == 2 and rest[0] in mod.classes:
                return self.lookup_method(mod.classes[rest[0]], rest[1])
            # re-export chase through this module's import table
            tgt = mod.imports.bindings.get(rest[0])
            if tgt and tgt != origin:
                return self.resolve_func(tgt + rest[1:], depth + 1)
            return None
        return None

    def resolve_class(self, origin, depth: int = 0) -> ClassInfo | None:
        if not origin or depth > 6:
            return None
        for i in range(len(origin) - 1, 0, -1):
            mod = self.modules.get(".".join(origin[:i]))
            if mod is None:
                continue
            rest = origin[i:]
            if len(rest) == 1:
                if rest[0] in mod.classes:
                    return mod.classes[rest[0]]
                tgt = mod.imports.bindings.get(rest[0])
                if tgt and tgt != origin:
                    return self.resolve_class(tgt, depth + 1)
            return None
        return None

    def lookup_method(self, ci: ClassInfo, name: str,
                      depth: int = 0) -> FuncInfo | None:
        if name in ci.methods:
            return ci.methods[name]
        if depth > 6:
            return None
        for base in ci.bases:
            bc = self.resolve_class(base)
            if bc is not None:
                m = self.lookup_method(bc, name, depth + 1)
                if m is not None:
                    return m
        return None

    # -- per-function edge/effect collection --------------------------------
    def _collect_edges_and_effects(self, mod: ModuleInfo):
        for local, fn in mod.functions.items():
            scanner = fx.EffectScanner(mod.imports)
            fn.sites = scanner.scan(fn.node)
            _FunctionVisitor(self, mod, fn).run()

    def _finish_roots(self):
        for fn in self.functions.values():
            local = fn.qualname.split(":", 1)[1]
            for name in (local, fn.local_name):
                if name in fx.NAMED_ROOTS:
                    self._color(fn, fx.NAMED_ROOTS[name],
                                f"named hot path '{name}'")
        # every call_soon-family callee runs ON the event loop
        for fn in self.functions.values():
            for e in fn.edges:
                if e.kind == "call_soon":
                    self._color(e.callee, "event-loop",
                                f"callback registered at "
                                f"{_rel(e.caller.path)}:{e.line}")
        self.roots = sorted((f for f in self.functions.values()
                             if f.root_kind), key=lambda f: f.qualname)

    # -- analysis -----------------------------------------------------------
    def findings(self) -> list["FlowFinding"]:
        """BFS each colored root per forbidden effect; one finding per
        (rule, site), keeping the shortest chain (ties: root name)."""
        best: dict[tuple, tuple] = {}  # (rule, path, line, col, detail) ->
        #                                (chain_len, root_qualname, finding)
        for root in self.roots:
            for effect in sorted(fx.ROOT_FORBIDS[root.root_kind]):
                self._bfs(root, effect, best)
        return sorted((v[2] for v in best.values()),
                      key=lambda f: (f.path, f.line, f.col, f.rule_id))

    def _bfs(self, root: FuncInfo, effect: str, best: dict):
        rule = fx.EFFECT_RULE[effect]
        parent: dict[str, tuple] = {root.qualname: None}
        queue = [root]
        while queue:
            fn = queue.pop(0)
            for site in fn.sites:
                if site.effect == effect:
                    self._emit(rule, root, fn, site, parent, best)
            for e in sorted(fn.edges,
                            key=lambda e: (e.callee.qualname, e.line)):
                if effect not in fx.EDGE_MASKS[e.kind]:
                    continue
                if e.callee.qualname in parent:
                    continue
                parent[e.callee.qualname] = (fn.qualname, e)
                queue.append(e.callee)

    def _emit(self, rule: str, root: FuncInfo, sink: FuncInfo,
              site: fx.EffectSite, parent: dict, best: dict):
        # chain: root-first hop list, each with the call site that leads in
        hops = []
        q = sink.qualname
        while q is not None:
            entry = parent[q]
            fn = self.functions[q]
            if entry is None:
                hops.append(f"{q} [{root.root_kind} root: {root.root_cause}]")
            else:
                _, e = entry
                hops.append(f"{q} [{e.kind} at {_rel(e.caller.path)}:{e.line}]")
            q = entry[0] if entry else None
        hops.reverse()
        hops.append(f"{site.detail} [{_rel(sink.path)}:{site.line}]")
        key = f"{rule}:{sink.qualname}:{site.detail}"
        n_calls = len(hops) - 2  # call hops between root and sink function
        via = (f" via {n_calls} call hop{'s' if n_calls != 1 else ''}"
               if n_calls else " directly in the root")
        f = FlowFinding(
            rule_id=rule,
            message=(f"{fx.RULE_EFFECT[rule]} effect {site.detail} reachable "
                     f"from {root.root_kind} root {root.qualname}{via}"),
            path=sink.path, line=site.line, col=site.col,
            chain=tuple(hops), key=key)
        bkey = (rule, sink.path, site.line, site.col, site.detail)
        cand = (len(hops), root.qualname, f)
        if bkey not in best or cand[:2] < best[bkey][:2]:
            best[bkey] = cand


def device_targets(call: ast.Call, mod: ModuleInfo) -> list[tuple]:
    """(function reference, cause) for each function `call` makes a
    device region: torch.cuda.make_graphed_callables(fn | (fns...)),
    torch.library.register_autograd(name, backward, setup_context=...)
    and Library.impl(name, kernel, key) on a module-level Library."""
    func = call.func
    origin = mod.imports.resolve(func)
    suffix = tuple(origin[-2:]) if origin else ()
    if suffix == _GRAPHED and call.args:
        first = call.args[0]
        refs = (first.elts if isinstance(first, (ast.Tuple, ast.List))
                else [first])
        return [(r, "make_graphed_callables") for r in refs]
    if suffix == ("library", "register_autograd"):
        refs = [*call.args[1:2], *[kw.value for kw in call.keywords
                                   if kw.arg == "setup_context"]]
        return [(r, "torch.library.register_autograd") for r in refs]
    if (isinstance(func, ast.Attribute) and func.attr == "impl"
            and isinstance(func.value, ast.Name)
            and func.value.id in mod.libraries and len(call.args) >= 2):
        return [(call.args[1], "Library.impl")]
    return []


def _rel(path: str) -> str:
    try:
        rel = os.path.relpath(path)
    except ValueError:
        return path
    return rel if not rel.startswith("..") else path


# ------------------------------------------------- per-function visitation
class _FunctionVisitor:
    """Collects call edges out of one function body. Walks statements in
    order so local forward flow (`x = ClassName(...)`, `f = self._step`)
    is visible to later calls; skips nested def/class bodies (their own
    graph nodes) but inlines lambda bodies into the enclosing function."""

    def __init__(self, graph: CallGraph, mod: ModuleInfo, fn: FuncInfo):
        self.g = graph
        self.mod = mod
        self.fn = fn
        self.local_types: dict[str, ClassInfo] = {}
        self.local_funcs: dict[str, FuncInfo] = {}
        self.shadowed: set[str] = {
            a.arg for a in [*fn.node.args.args, *fn.node.args.kwonlyargs,
                            *fn.node.args.posonlyargs,
                            *filter(None, [fn.node.args.vararg,
                                           fn.node.args.kwarg])]}
        # nested defs are callable by bare name from the enclosing body
        nest = f"{fn.qualname.split(':', 1)[1]}.<locals>."
        for local, f2 in mod.functions.items():
            if local.startswith(nest) and "." not in local[len(nest):]:
                self.local_funcs[f2.local_name] = f2

    def run(self):
        for stmt in self.fn.node.body:
            self._walk(stmt)

    # -- traversal ----------------------------------------------------------
    def _walk(self, node: ast.AST):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            self._check_cuda_graph(node)
        if isinstance(node, ast.Assign):
            self._track_assign(node)
        if isinstance(node, ast.Call):
            self._check_call(node)
        if isinstance(node, ast.Lambda):
            self._walk(node.body)
            return
        for child in ast.iter_child_nodes(node):
            self._walk(child)

    def _check_cuda_graph(self, node):
        """Functions called in the body of `with torch.cuda.graph(g):`
        are captured into a CUDA graph: device regions."""
        if not any(isinstance(item.context_expr, ast.Call)
                   and (o := self.mod.imports.resolve(item.context_expr.func))
                   and tuple(o[-2:]) == _CUDA_GRAPH for item in node.items):
            return
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Call):
                    target = self._func_ref(sub.func)
                    if target is not None:
                        self.g._color(target, "device-region",
                                      f"torch.cuda.graph at "
                                      f"{_rel(self.fn.path)}:{node.lineno}")

    def _track_assign(self, node: ast.Assign):
        if len(node.targets) != 1 or not isinstance(node.targets[0], ast.Name):
            return
        name = node.targets[0].id
        self.shadowed.add(name)
        self.local_types.pop(name, None)
        self.local_funcs.pop(name, None)
        v = node.value
        if isinstance(v, ast.Call):
            # x = ClassName(...): forward type flow for x.meth() edges
            ci = self._class_of_ctor(v.func)
            if ci is not None:
                self.local_types[name] = ci
                return
        # x = self._helper / x = mod.func: callable alias
        target = self._func_ref(v)
        if target is not None:
            self.local_funcs[name] = target

    def _class_of_ctor(self, func: ast.AST) -> ClassInfo | None:
        if isinstance(func, ast.Name) and func.id in self.mod.classes \
                and func.id not in self.shadowed:
            return self.mod.classes[func.id]
        origin = self.mod.imports.resolve(func)
        if origin:
            return self.g.resolve_class(origin)
        return None

    # -- call handling ------------------------------------------------------
    def _edge(self, target: FuncInfo | None, kind: str, line: int):
        if target is not None:
            self.fn.edges.append(CallEdge(self.fn, target, kind, line))

    def _check_call(self, node: ast.Call):
        func = node.func

        if isinstance(func, ast.Attribute):
            attr = func.attr
            # asyncio callback registration edges
            if attr in _CALL_SOON and node.args:
                self._edge(self._func_ref(node.args[0]), "call_soon",
                           node.lineno)
                return
            if attr in _CALL_LATER and len(node.args) >= 2:
                self._edge(self._func_ref(node.args[1]), "call_soon",
                           node.lineno)
                return
            if attr in _TASK_CTORS and node.args:
                self._edge(self._coro_ref(node.args[0]), "task", node.lineno)
                return
            if attr == "run_in_executor" and len(node.args) >= 2:
                default = (isinstance(node.args[0], ast.Constant)
                           and node.args[0].value is None)
                self._edge(self._func_ref(node.args[1]),
                           "default-executor" if default else "executor",
                           node.lineno)
                return
            if attr == "submit" and node.args:
                target = self._func_ref(node.args[0])
                if target is not None:
                    self._edge(target, "executor", node.lineno)
                    return
            if attr == "remote":
                base = func.value
                if (isinstance(base, ast.Call)
                        and isinstance(base.func, ast.Attribute)
                        and base.func.attr == "options"):
                    base = base.func.value  # f.options(...).remote(...)
                self._edge(self._func_ref(base), "remote", node.lineno)
                # fall through: argument callbacks still scanned below

        # Thread(target=...) edges
        origin = self.mod.imports.resolve(func)
        if origin and tuple(origin[-2:]) == ("threading", "Thread"):
            for kw in node.keywords:
                if kw.arg == "target":
                    self._edge(self._func_ref(kw.value), "thread",
                               node.lineno)
            return

        # device regions handed to torch (graphed callables, library ops)
        for ref, cause in device_targets(node, self.mod):
            target = self._func_ref(ref)
            if target is not None:
                self.g._color(target, "device-region",
                              f"{cause} at {_rel(self.fn.path)}:{node.lineno}")

        # plain direct/method call
        self._edge(self._func_ref(func), "call", node.lineno)

    # -- reference resolution ------------------------------------------------
    def _coro_ref(self, node: ast.AST) -> FuncInfo | None:
        """create_task(coro(...)) or create_task(fn) -> fn."""
        if isinstance(node, ast.Call):
            return self._func_ref(node.func)
        return self._func_ref(node)

    def _func_ref(self, node: ast.AST) -> FuncInfo | None:
        # functools.partial(fn, ...) -> fn
        if isinstance(node, ast.Call):
            origin = self.mod.imports.resolve(node.func)
            if origin and origin[-1] == "partial" and node.args:
                return self._func_ref(node.args[0])
            return None
        if isinstance(node, ast.Name):
            if node.id in self.local_funcs:
                return self.local_funcs[node.id]
            if node.id in self.shadowed:
                return None
            origin = self.mod.imports.resolve(node)
            if origin:
                return self.g.resolve_func(origin)
            # same-module module-level function or class ctor
            fn = self.mod.functions.get(node.id)
            if fn is not None:
                return fn
            ci = self.mod.classes.get(node.id)
            if ci is not None:
                return self.g.lookup_method(ci, "__init__")
            return None
        if not isinstance(node, ast.Attribute):
            return None
        # self.meth / cls.meth
        base = node.value
        if isinstance(base, ast.Name) and base.id in ("self", "cls"):
            ci = self._own_class()
            if ci is not None:
                return self.g.lookup_method(ci, node.attr)
            return None
        # self.attr.meth via __init__-time attribute types
        if (isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id in ("self", "cls")):
            ci = self._own_class()
            if ci is not None:
                target = ci.attr_classes.get(base.attr)
                if target is not None:
                    tc = (target if isinstance(target, ClassInfo)
                          else self.g.resolve_class(target))
                    if tc is not None:
                        return self.g.lookup_method(tc, node.attr)
            return None
        # x.meth where x = ClassName(...) locally
        if isinstance(base, ast.Name) and base.id in self.local_types:
            return self.g.lookup_method(self.local_types[base.id], node.attr)
        # ClassName.meth / module.func / pkg.mod.Class.meth
        if isinstance(base, ast.Name) and base.id in self.mod.classes \
                and base.id not in self.shadowed:
            return self.g.lookup_method(self.mod.classes[base.id], node.attr)
        origin = self.mod.imports.resolve(node)
        if origin:
            return self.g.resolve_func(origin)
        return None

    def _own_class(self) -> ClassInfo | None:
        if self.fn.class_name is None:
            return None
        return self.mod.classes.get(self.fn.class_name)


# ----------------------------------------------------------------- findings
@dataclass(frozen=True)
class FlowFinding(Finding):
    chain: tuple = ()
    key: str = ""

    def as_dict(self) -> dict:
        d = super().as_dict()
        d["chain"] = list(self.chain)  # after message: stable key order
        return d

    def render(self) -> str:
        lines = [super().render()]
        lines += [f"    {'-> ' if i else '   '}{hop}"
                  for i, hop in enumerate(self.chain)]
        return "\n".join(lines)


# ----------------------------------------------------------------- baseline
BASELINE_NAME = ".raylint_torch_baseline.json"


def load_baseline(path: str | None) -> dict[str, str]:
    """key -> reason. Missing file with an explicit path is an error (a
    typo'd baseline silently un-suppressing nothing would green-gate);
    None means 'no baseline'."""
    if path is None:
        return {}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    out = {}
    for entry in data.get("entries", []):
        out[entry["key"]] = entry.get("reason", "")
    return out


def write_baseline(path: str, findings) -> None:
    entries = [{"key": key, "reason": "baselined (pre-existing finding)"}
               for key in sorted({f.key for f in findings})]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1, "entries": entries}, f, indent=2)
        f.write("\n")


# ------------------------------------------------------------------ driver
def analyze_paths(paths, *, baseline: str | None = None,
                  graph: CallGraph | None = None) -> list[FlowFinding]:
    """Run the interprocedural pass; returns unsuppressed findings.

    Suppression: the engine's per-line `# raylint: disable=RT02x` on the
    effect-site line (or disable-file), plus baseline keys."""
    g = graph if graph is not None else CallGraph.build(paths)
    base = load_baseline(baseline)
    kept = []
    sup_cache: dict[str, tuple] = {}
    for f in g.findings():
        if f.key in base:
            continue
        if f.path not in sup_cache:
            try:
                with open(f.path, encoding="utf-8") as fh:
                    sup_cache[f.path] = parse_suppressions(fh.read())
            except OSError:
                sup_cache[f.path] = ({}, set())
        per_line, file_wide = sup_cache[f.path]
        ids = per_line.get(f.line, set()) | file_wide  # raylint: disable=RT002 -- dict.get, not framework get()
        if f.rule_id in ids or "all" in ids:
            continue
        kept.append(f)
    return kept
