"""The port's raylint (``ray_tpu_torch/devtools/lint/``) against the JAX
package's: every case of ``tests/test_lint.py`` translated, plus parity.

Fixtures: the runtime-API fixtures ``tests/lint_fixtures/rtNNN.py`` (all
but RT004's and RT017's) and ``tests/lint_fixtures/flow/`` (but its
``regress_hostsync.py``) import no jax, so the port lints their text with
``ray_tpu`` rewritten to ``ray_tpu_torch`` and must give exactly the JAX
linter's ``(line, rule)`` set on the originals. RT004, RT017 and the flow
pass's device regions are torch's own: their fixtures are under
``tests/torch_lint_fixtures/`` (``rt004.py``, ``rt017.py``, ``flow/``),
where every line expected to fire carries a trailing ``# expect: RTNNN``
marker, so false negatives and false positives both fail. Neither linter
imports its framework, so both run in this one process. Both packages'
rules are imported with this module, before any case runs: a worker that
collects it registers them first, whatever order its cases come in.

Then: the flow pass's device-region roots cover the port's counterparts of
JAX's jit regions in ``llm/engine.py`` and ``llm/generation.py``; the CLI's
rule ids, JSON keys and exit codes equal JAX's, and it loads neither torch
nor jax; the registry refuses a duplicate id whatever ran first; and
``ray_tpu_torch/`` lints clean, the flow pass under 60 s.
"""

import ast
import json
import os
import re
import subprocess
import sys
import time

import pytest

from ray_tpu.devtools.lint import engine as jengine
from ray_tpu.devtools.lint import flow as jflow
from ray_tpu.devtools.lint import lint_source as jlint_source
from ray_tpu.devtools.lint import rules as jrules  # noqa: F401  (JAX's rules, registered at import)
from ray_tpu_torch.devtools.lint import engine, flow, lint_paths, lint_source, rules  # noqa: F401

from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse

# slowest test 14.9 s, no module set-up (the port's modules alone under -n 6);
# the limits are several times that, so one that fires names a stalled test
_module_limit, _test_limit = time_limits(module_s=120, test_s=120)


HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
JAX_FIXTURES = os.path.join(HERE, "lint_fixtures")
JAX_FLOW = os.path.join(JAX_FIXTURES, "flow")
FIXTURES = os.path.join(HERE, "torch_lint_fixtures")
FLOW_FIXTURES = os.path.join(FIXTURES, "flow")
PACKAGE = os.path.join(REPO, "ray_tpu_torch")

AST_RULES = ["RT001", "RT002", "RT003", "RT004", "RT005", "RT006",
             "RT007", "RT008", "RT009", "RT010", "RT011", "RT012",
             "RT013", "RT014", "RT015", "RT016", "RT017", "RT018",
             "RT019", "RT024"]
FLOW_RULES = ["RT020", "RT021", "RT022", "RT023"]
ALL_RULES = sorted(AST_RULES + FLOW_RULES)
TORCH_RULES = ["RT004", "RT017"]  # fixtures of the port's own
RUNTIME_RULES = [r for r in AST_RULES if r not in TORCH_RULES]

_EXPECT_RE = re.compile(r"#\s*expect:\s*([A-Z0-9,\s]+)")
_NAME_RE = re.compile(r"\bray_tpu\b")


def _markers(text: str) -> set:
    expected = set()
    for lineno, line in enumerate(text.splitlines(), start=1):
        m = _EXPECT_RE.search(line)
        if m:
            expected |= {(lineno, rid.strip()) for rid in m.group(1).split(",")}
    return expected


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def _ported(text: str) -> str:
    """A JAX fixture's text as the port's user would write it."""
    return _NAME_RE.sub("ray_tpu_torch", text)


def _fixture(rule_id: str) -> tuple[str, str]:
    """(path, text) of a rule's fixture for the port."""
    name = f"{rule_id.lower()}.py"
    if rule_id in TORCH_RULES:
        path = os.path.join(FIXTURES, name)
        return path, _read(path)
    path = os.path.join(JAX_FIXTURES, name)
    return path, _ported(_read(path))


# ------------------------------------------------------------ rule fixtures
@pytest.mark.parametrize("rule_id", AST_RULES)
def test_rule_fixture(rule_id):
    """Each rule fires on exactly its fixture's marked lines: positives
    found, negatives silent, suppressed lines dropped."""
    path, text = _fixture(rule_id)
    expected = _markers(text)
    assert expected, f"fixture {path} has no # expect markers"
    actual = {(f.line, f.rule_id) for f in lint_source(text, path, select=[rule_id])}
    assert actual == expected


@pytest.mark.parametrize("rule_id", RUNTIME_RULES)
def test_runtime_fixture_matches_jax(rule_id):
    """On the runtime-API fixtures, every rule at once: the port's (line,
    rule) set on the rewritten text equals JAX's on the original."""
    path = os.path.join(JAX_FIXTURES, f"{rule_id.lower()}.py")
    text = _read(path)
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)
    ours = {(f.line, f.rule_id) for f in lint_source(_ported(text), path)}
    theirs = {(f.line, f.rule_id) for f in jlint_source(text, path)}
    assert ours == theirs
    assert rule_id in {r for _, r in ours}


def test_fixtures_cover_every_registered_rule():
    assert sorted(engine.RULES) == ALL_RULES
    assert sorted(engine.RULES) == sorted(jengine.RULES)


def test_registry_rejects_duplicate_ids():
    """The real rules are registered first (imported at the top of this
    file), so a duplicate is refused whatever ran before, and the registry
    keeps the full RT001-RT024 set with the real RT001."""
    real = engine.RULES["RT001"]
    with pytest.raises(ValueError, match="duplicate"):
        @engine.register
        class Dup(engine.Rule):
            id = "RT001"
    assert sorted(engine.RULES) == ALL_RULES
    assert engine.RULES["RT001"] is real is rules.BlockingGetInRemote


def test_unknown_rule_id_rejected():
    with pytest.raises(ValueError, match="unknown rule"):
        lint_source("x = 1", select=["RT999"])
    with pytest.raises(ValueError, match="unknown rule"):
        lint_source("x = 1", ignore=["RT999"])


def test_empty_effective_rule_set_rejected():
    """--select X --ignore X must error, not lint with zero rules."""
    with pytest.raises(ValueError, match="no rules enabled"):
        lint_source("x = 1", select=["RT001"], ignore=["RT001"])


def test_nonexistent_path_raises():
    with pytest.raises(FileNotFoundError, match="no such file"):
        lint_paths(["tests/does_not_exist_anywhere"])


def test_directory_with_no_python_files_raises(tmp_path):
    """An existing-but-empty (or renamed) package must error, not report
    a green '0 findings' over zero linted files."""
    with pytest.raises(FileNotFoundError, match="no python files"):
        lint_paths([str(tmp_path)])


@pytest.mark.parametrize("lib", ["np", "torch"])
def test_arange_size_uses_start_stop_step(lib):
    src = ("import numpy as np\n"
           "import torch\n"
           "import ray_tpu_torch\n"
           "@ray_tpu_torch.remote\n"
           "def f(a):\n"
           "    return a\n"
           f"r1 = f.remote({lib}.arange(0, 100000, 10))\n"   # 10k elems: clean
           f"r2 = f.remote({lib}.arange(90000, 100000))\n"   # 10k elems: clean
           f"r3 = f.remote({lib}.arange(20000))\n")          # 20k elems: fires
    findings = lint_source(src, select=["RT004"])
    assert [(f.line, f.rule_id) for f in findings] == [(9, "RT004")]


def test_torch_shape_forms_count_alike():
    """torch.zeros(a, b) and torch.zeros((a, b)) are one size; np.zeros'
    count is kept."""
    sizes = {}
    for expr in ("torch.zeros(256, 128)", "torch.zeros((256, 128))", "torch.ones([256, 128])",
                 "torch.empty(256, 128)", "torch.randn(256, 128)", "torch.rand((256, 128))",
                 "torch.full((256, 128), 3.0)", "np.zeros((256, 128))"):
        tree = ast.parse(f"import numpy as np\nimport torch\n{expr}\n")
        imports = engine.ImportTable()
        imports.collect(tree)
        ctx = engine.Context(path="<s>", imports=imports)
        sizes[expr] = engine.literal_array_size(tree.body[-1].value, ctx)
    assert set(sizes.values()) == {256 * 128}, sizes


# ------------------------------------------------------------- suppression
def test_file_wide_suppression():
    src = ("# raylint: disable-file=RT003\n"
           "import ray_tpu_torch\n"
           "def f(actor):\n"
           "    actor.step.remote()\n")
    assert lint_source(src) == []


def test_directive_in_docstring_is_not_a_suppression():
    """Documentation that quotes the syntax (docstrings, strings) must not
    become a live suppression — only real comment tokens count."""
    src = ('"""Suppress with `# raylint: disable-file=RT003` anywhere."""\n'
           "import ray_tpu_torch\n"
           "def f(actor):\n"
           "    actor.step.remote()\n")
    assert [f.rule_id for f in lint_source(src)] == ["RT003"]


def test_lambda_body_is_deferred_scope():
    """A get() inside a lambda built in a loop runs later, not
    per-iteration — RT002 must stay silent."""
    src = ("import ray_tpu_torch\n"
           "def f(refs):\n"
           "    return [lambda r=r: ray_tpu_torch.get(r) for r in refs]\n")
    assert lint_source(src) == []


def test_remote_attr_without_framework_import_is_clean():
    """`.remote()` on an unrelated library's object in a module that never
    imports ray_tpu_torch must not fire the attribute-shape rules — nor
    in a module that imports only the JAX package."""
    for header in ("import fabric\n", "import ray_tpu\n"):
        src = header + "def deploy(conn):\n    conn.remote()\n"
        assert lint_source(src) == []


def test_synchronize_attribute_needs_torch():
    """The attribute form `.synchronize()` counts only in a module that
    imports torch (a loop in unrelated code stays clean)."""
    body = ("def f(jobs, barrier):\n"
            "    for j in jobs:\n"
            "        barrier.synchronize()\n")
    assert lint_source("import threading\n" + body, select=["RT017"]) == []
    assert [f.line for f in lint_source("import torch\n" + body, select=["RT017"])] == [4]


def test_disable_all_on_line():
    src = ("import ray_tpu_torch\n"
           "@ray_tpu_torch.remote\n"
           "def f(ref, acc=[]):  # raylint: disable=all\n"
           "    return acc\n")
    assert lint_source(src) == []


def test_suppression_is_rule_specific():
    src = ("import ray_tpu_torch\n"
           "@ray_tpu_torch.remote\n"
           "def f(ref, acc=[]):  # raylint: disable=RT001\n"
           "    return acc\n")
    assert [f.rule_id for f in lint_source(src)] == ["RT005"]


def test_syntax_error_reported_as_rt000():
    findings = lint_source("def broken(:\n", "bad.py")
    assert [f.rule_id for f in findings] == [engine.PARSE_RULE_ID]


# ------------------------------------------------------------- JSON output
def test_json_output_stability():
    """Two runs over the same tree produce byte-identical JSON, sorted by
    (path, line, col, rule), with a fixed key order per finding."""
    first = engine.to_json(lint_paths([FIXTURES]))
    second = engine.to_json(lint_paths([FIXTURES]))
    assert first == second
    rows = json.loads(first)
    assert rows, "fixtures must produce findings"
    for row in rows:
        assert list(row) == ["rule", "path", "line", "col", "message"]
    keys = [(r["path"], r["line"], r["col"], r["rule"]) for r in rows]
    assert keys == sorted(keys)


def test_rule_table_shape():
    table = engine.rule_table()
    assert [row["id"] for row in table] == ALL_RULES
    assert [row["id"] for row in table] == [row["id"] for row in jengine.rule_table()]
    assert all(row["summary"] and row["rationale"] for row in table)


# -------------------------------------------------------------------- CLI
def _run(package, *argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-m", package, "lint", *argv],
        capture_output=True, text=True, cwd=REPO, timeout=120, env=env)


def _run_cli(*argv):
    return _run("ray_tpu_torch", *argv)


def test_cli_findings_exit_one_and_json():
    proc = _run_cli(os.path.join(FIXTURES, "rt017.py"), "--select", "RT017", "--format", "json")
    assert proc.returncode == 1, proc.stderr
    rows = json.loads(proc.stdout)
    assert {r["rule"] for r in rows} == {"RT017"}


def test_cli_clean_file_exits_zero(tmp_path):
    clean = tmp_path / "clean.py"
    clean.write_text("import ray_tpu_torch\n\nref = None\n")
    proc = _run_cli(str(clean))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 findings" in proc.stdout


def test_cli_rules_table():
    proc = _run_cli("--rules")
    assert proc.returncode == 0
    for rid in ALL_RULES:
        assert rid in proc.stdout


def test_cli_unknown_rule_exits_two():
    proc = _run_cli("--select", "RT999", FIXTURES)
    assert proc.returncode == 2
    assert "unknown rule" in proc.stderr


def test_cli_nonexistent_path_exits_two():
    """A typo'd path must error loudly, never report a green '0 findings'."""
    proc = _run_cli("no_such_dir_typo")
    assert proc.returncode == 2
    assert "no such file" in proc.stderr


def test_cli_matches_jax(tmp_path):
    """The same rule ids (--rules, text and JSON), the same JSON keys in
    the same order, and the same exit codes for findings, a clean file,
    bad usage and a missing path, on the same (rewritten) input."""
    ported = tmp_path / "rt001.py"
    ported.write_text(_ported(_read(os.path.join(JAX_FIXTURES, "rt001.py"))))
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")

    def ids(proc):
        return [row["id"] for row in json.loads(proc.stdout)]

    ours, theirs = _run_cli("--rules", "--format", "json"), _run("ray_tpu", "--rules",
                                                                "--format", "json")
    assert ids(ours) == ids(theirs) == ALL_RULES
    assert [list(r) for r in json.loads(ours.stdout)] == [list(r) for r in json.loads(theirs.stdout)]
    ours = _run_cli(str(ported), "--format", "json")
    theirs = _run("ray_tpu", os.path.join(JAX_FIXTURES, "rt001.py"), "--format", "json")
    assert ours.returncode == theirs.returncode == 1
    rows, jrows = json.loads(ours.stdout), json.loads(theirs.stdout)
    assert [list(r) for r in rows] == [list(r) for r in jrows]
    assert [(r["rule"], r["line"]) for r in rows] == [(r["rule"], r["line"]) for r in jrows]
    for argv in ([str(clean)], ["--select", "RT999", str(clean)], ["no_such_dir_typo"],
                 [str(clean), "--flow", "--baseline", str(tmp_path / "none.json")]):
        assert _run_cli(*argv).returncode == _run("ray_tpu", *argv).returncode, argv


def test_cli_loads_neither_torch_nor_jax():
    """`python -m ray_tpu_torch lint --flow` over the package: no torch, no
    jax and nothing of ray_tpu in the process (the analysis is static)."""
    code = ("import runpy, sys\n"
            "sys.argv = ['ray_tpu_torch', 'lint', '--flow']\n"
            "try:\n"
            "    runpy.run_module('ray_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules}\n"
            "             & {'torch', 'jax', 'jaxlib', 'ray_tpu'})\n"
            "print(rc, bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "0 []", out.stdout


# --------------------------------------------------------------- flow pass
@pytest.fixture(scope="module")
def jax_flow_ported(tmp_path_factory):
    """JAX's flow fixture package, rewritten for the port, without its
    jax-only regression; a directory named flow, so module names match."""
    root = tmp_path_factory.mktemp("ported") / "flow"
    root.mkdir()
    for name in sorted(os.listdir(JAX_FLOW)):
        if name.endswith(".py") and name != "regress_hostsync.py":
            (root / name).write_text(_ported(_read(os.path.join(JAX_FLOW, name))))
    return str(root)


def _flow_findings():
    return flow.analyze_paths([FLOW_FIXTURES])


def _by_rule(findings, rule_id):
    return [f for f in findings if f.rule_id == rule_id]


def test_flow_fixtures_hit_exactly_their_markers():
    expected = set()
    for name in sorted(os.listdir(FLOW_FIXTURES)):
        if name.endswith(".py"):
            expected |= {(name, line, rule) for line, rule in
                         _markers(_read(os.path.join(FLOW_FIXTURES, name)))}
    actual = {(os.path.basename(f.path), f.line, f.rule_id) for f in _flow_findings()}
    assert actual == expected


def test_flow_matches_jax_on_runtime_fixtures(jax_flow_ported):
    """On JAX's flow package (but its jax-only host-sync regression) the
    port's flow findings equal JAX's: sites, rules and chains."""
    ours = flow.analyze_paths([jax_flow_ported])
    theirs = [f for f in jflow.analyze_paths([JAX_FLOW])
              if not f.path.endswith("regress_hostsync.py")]

    def key(f, name):
        hops = [re.sub(r"\S*/([\w.]+\.py):", r"\1:", h) for h in f.chain]
        return (os.path.basename(f.path), f.line, f.rule_id, name(f.message), tuple(map(name, hops)))

    assert len(ours) == len(theirs) > 0
    assert sorted(key(f, str) for f in ours) == sorted(
        key(f, lambda s: _NAME_RE.sub("ray_tpu_torch", s)) for f in theirs)


def test_flow_effect_two_hops_deep(jax_flow_ported):
    """os.urandom two module-function hops below a named fast-pump root
    is found, with every hop named in the chain."""
    fs = [f for f in _by_rule(flow.analyze_paths([jax_flow_ported]), "RT021")
          if "flow.hot:_fast_pump" in f.chain[0]]
    assert len(fs) == 1
    chain = fs[0].chain
    assert len(chain) == 4  # root, 2 hops, sink
    assert "stamp_record" in chain[1]
    assert "read_entropy" in chain[2]
    assert "os.urandom()" in chain[3]


def test_flow_effect_through_method_call(jax_flow_ported):
    """Alloc behind Emitter().emit -> self.count -> make_counter: class
    instantiation tracking plus self-method resolution."""
    fs = _by_rule(flow.analyze_paths([jax_flow_ported]), "RT023")
    assert len(fs) == 1
    chain = fs[0].chain
    assert "Emitter.emit" in chain[1]
    assert "Emitter.count" in chain[2]
    assert "metrics.Counter()" in chain[-1]


def test_flow_effect_through_call_soon_threadsafe(jax_flow_ported):
    """A callback registered via loop.call_soon_threadsafe becomes an
    event-loop root; blocking one helper hop below it fires RT020."""
    fs = [f for f in _by_rule(flow.analyze_paths([jax_flow_ported]), "RT020")
          if "_on_ring_doorbell" in f.chain[0]]
    assert len(fs) == 1
    assert "event-loop root" in fs[0].chain[0]
    assert "time.sleep()" in fs[0].chain[-1]


def test_flow_private_executor_submit_is_clean(jax_flow_ported):
    """pool.submit(...) to a private pool is the fix idiom: nothing it
    runs propagates back (no finding rooted at ship_to_private_pool)."""
    assert not any("ship_to_private_pool" in f.chain[0]
                   for f in flow.analyze_paths([jax_flow_ported]))


# the three historical bugs, rewritten for torch: the analyzer must name
# the full chain with >= 2 call hops
def test_flow_regression_urandom_in_submit():
    fs = [f for f in _by_rule(_flow_findings(), "RT021") if "regress_urandom" in f.path]
    assert len(fs) == 1
    chain = fs[0].chain
    assert len(chain) - 2 >= 2  # call hops between root and sink
    assert "fast_actor_submit_loop" in chain[0]
    assert "_pack_submit" in chain[1]
    assert "_fresh_task_id" in chain[2]
    assert "os.urandom()" in chain[3]


def test_flow_regression_blocking_get_on_default_executor():
    fs = [f for f in _by_rule(_flow_findings(), "RT020") if "regress_executor_get" in f.path]
    assert len(fs) == 1
    chain = fs[0].chain
    assert len(chain) - 2 >= 2
    assert "_apply_update" in chain[0] and "event-loop root" in chain[0]
    assert "_fetch_state" in chain[1] and "default-executor" in chain[1]
    assert "_pull_value" in chain[2]
    assert "ray_tpu_torch.get()" in chain[3]


def test_flow_regression_host_sync_under_inference_mode():
    fs = [f for f in _by_rule(_flow_findings(), "RT022") if "regress_hostsync" in f.path]
    assert len(fs) == 1
    chain = fs[0].chain
    assert len(chain) - 2 >= 2
    assert "_decode_step" in chain[0] and "device-region root" in chain[0]
    assert "@torch.inference_mode" in chain[0]
    assert "_track_loss" in chain[1]
    assert "_loss_to_host" in chain[2]
    assert "float(loss)" in chain[3]


@pytest.mark.parametrize("root, cause, sink", [
    ("_ScaleGrad.backward", "autograd.Function backward", "s.cpu()"),
    ("_kernel_cuda", "Library.impl", "torch.cuda.synchronize()"),
    ("evaluate", "@torch.no_grad", "n.item()"),
    ("_graphed_step", "make_graphed_callables", "int(c)"),
    ("_captured_step", "torch.cuda.graph", "bool(torch.any(x))"),
])
def test_flow_device_region_marks(root, cause, sink):
    """Each of torch's device-region marks colors its function, and a host
    sync below it is reported with the mark named in the chain."""
    fs = [f for f in _by_rule(_flow_findings(), "RT022")
          if f.chain[0].startswith(f"flow.regions:{root} ")]
    assert len(fs) == 1
    assert "device-region root" in fs[0].chain[0] and cause in fs[0].chain[0]
    assert sink in fs[0].chain[-1]


def test_device_regions_cover_jax_jit_regions():
    """Every jit-region root of JAX's llm/engine.py and llm/generation.py
    whose name exists in the port is a device-region root there."""
    jax_roots = {f.qualname.split(":", 1)[1]
                 for f in jflow.CallGraph.build([os.path.join(REPO, "ray_tpu")]).roots
                 if f.root_kind == "jit-region"
                 and f.module.name in ("ray_tpu.llm.engine", "ray_tpu.llm.generation")}
    graph = flow.CallGraph.build([PACKAGE])
    ours = {f.qualname.split(":", 1)[1]: f.root_kind for f in graph.functions.values()
            if f.module.name in ("ray_tpu_torch.llm.engine", "ray_tpu_torch.llm.generation")}
    shared = jax_roots & set(ours)
    assert shared >= {"paged_decode_multi", "paged_decode_spec", "paged_decode_verify",
                      "paged_prefill_batch", "paged_prefill_suffix", "generate_tokens"}
    assert {n: ours[n] for n in shared} == {n: "device-region" for n in shared}
    # the renamed counterpart of JAX's _scatter_pages_jit is named
    assert ours["scatter_pages"] == "device-region"


def test_flow_findings_deterministic():
    first = _flow_findings()
    second = _flow_findings()
    assert [f.as_dict() for f in first] == [f.as_dict() for f in second]


def test_flow_json_carries_chain_with_stable_key_order():
    rows = json.loads(engine.to_json(_flow_findings()))
    assert rows
    for row in rows:
        assert list(row) == ["rule", "path", "line", "col", "message", "chain"]
        assert isinstance(row["chain"], list) and len(row["chain"]) >= 2


def test_flow_baseline_round_trip(tmp_path):
    """write_baseline captures every finding; a re-run against the file
    reports zero; removing an entry resurfaces exactly that finding."""
    fs = _flow_findings()
    assert fs
    base = tmp_path / "baseline.json"
    flow.write_baseline(str(base), fs)
    assert flow.analyze_paths([FLOW_FIXTURES], baseline=str(base)) == []
    data = json.loads(base.read_text())
    dropped = data["entries"].pop()
    base.write_text(json.dumps(data))
    kept = flow.analyze_paths([FLOW_FIXTURES], baseline=str(base))
    assert [f.key for f in kept] == [dropped["key"]]


def test_flow_baseline_name_is_the_ports_own():
    """The two packages' gates never read each other's baseline file."""
    assert flow.BASELINE_NAME == ".raylint_torch_baseline.json" != jflow.BASELINE_NAME


def test_flow_missing_baseline_path_errors(tmp_path):
    """A typo'd --baseline must error, not silently un-suppress nothing
    (the green-gate failure mode)."""
    with pytest.raises(OSError):
        flow.analyze_paths([FLOW_FIXTURES], baseline=str(tmp_path / "nope.json"))


def test_flow_sink_line_suppression(tmp_path):
    """# raylint: disable=RT021 on the effect-site line drops every chain
    landing on that sink."""
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "mod.py").write_text(
        "import os\n"
        "def _gen():\n"
        "    return os.urandom(8)  # raylint: disable=RT021 -- amortized\n"
        "def _fast_pump(ring):\n"
        "    return [_gen() for _ in ring]\n")
    assert flow.analyze_paths([str(pkg)]) == []


def test_flow_cli(tmp_path):
    proc = _run_cli(FLOW_FIXTURES, "--flow", "--format", "json")
    assert proc.returncode == 1, proc.stderr
    rows = json.loads(proc.stdout)
    flow_rows = [r for r in rows if r["rule"] in FLOW_RULES]
    assert flow_rows
    for row in flow_rows:
        assert list(row) == ["rule", "path", "line", "col", "message", "chain"]
    # --write-baseline then --flow --baseline: gate goes green
    base = tmp_path / "b.json"
    wb = _run_cli(FLOW_FIXTURES, "--write-baseline", "--baseline", str(base))
    assert wb.returncode == 0, wb.stderr
    clean = _run_cli(FLOW_FIXTURES, "--flow", "--baseline", str(base),
                     "--select", ",".join(FLOW_RULES), "--format", "json")
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert json.loads(clean.stdout) == []


# -------------------------------------------------------------- self-check
def test_self_check():
    """ray_tpu_torch/ lints clean: every violation fixed or explicitly
    suppressed. The flow pass runs with a 0-unsuppressed-findings budget
    and a wall-clock ceiling so the interprocedural gate stays cheap
    enough for tier-1."""
    findings = lint_paths([PACKAGE])
    assert findings == [], "\n" + "\n".join(f.render() for f in findings)
    t0 = time.monotonic()
    flow_findings = flow.analyze_paths([PACKAGE])
    elapsed = time.monotonic() - t0
    assert flow_findings == [], "\n" + "\n".join(f.render() for f in flow_findings)
    assert elapsed < 60, f"flow self-check took {elapsed:.1f}s (ceiling 60s)"
