"""raylint — framework-aware static analysis for ray_tpu_torch programs.

The port's copy of the JAX package's linter. AST-based: resolves names
through each module's import table so rules fire on real ray_tpu_torch
API usage (`get`/`put`/`wait`/`.remote()`/collectives), not on look-alike
identifiers. Run it as `python -m ray_tpu_torch lint <paths>`. It imports
neither torch nor jax: the analysis is static.

Rules (see `ray_tpu_torch lint --rules` for rationale):
  RT001 blocking get() inside a remote function/actor method
  RT002 get() in a loop instead of one batched get(refs)
  RT003 .remote() result discarded
  RT004 large numpy/torch array passed inline instead of put()
  RT005 mutable default argument on a remote function/actor method
  RT006 collective call order diverging across branches
  RT007 bare except swallowing errors around get()/wait()
  RT008 time.sleep in a remote task without max_retries
  ...
  RT017 host-device sync (.item()/.cpu()/float()/synchronize() on a CUDA
        tensor) inside a loop body
  RT018 wire prefix/flag literal absent from the schema catalog
  RT019 metric constructed inside a hot-path root function
  RT024 whole stream materialized into a list on the request path

The interprocedural pass (`ray_tpu_torch lint --flow`, flow.py) adds
RT020-RT023: it builds a package-wide call graph, infers per-function
effects (blocking / syscall / host-sync / alloc — effects.py), and
reports any forbidden effect REACHABLE from a hot-path root (event-loop
callbacks, fast-lane pumps, tunnel exec paths, serve handlers, device
regions: inference_mode/no_grad programs, autograd.Function
forward/backward, torch.library kernels, CUDA-graph bodies) with the full
call chain. Pre-existing findings live in `.raylint_torch_baseline.json`
so the gate stays adoptable.

Suppress a deliberate finding with `# raylint: disable=RT003  -- reason`
on the offending line, or file-wide with `# raylint: disable-file=RT003`.
"""
from ray_tpu_torch.devtools.lint.engine import (  # noqa: F401
    Finding,
    Rule,
    lint_paths,
    lint_source,
    register,
    rule_table,
    to_json,
)
from ray_tpu_torch.devtools.lint.cli import main  # noqa: F401
