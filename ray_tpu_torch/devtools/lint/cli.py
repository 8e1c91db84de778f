"""`ray_tpu_torch lint` CLI: human/JSON output, rule table, exit codes.

Exit codes: 0 no unsuppressed findings, 1 findings reported, 2 bad usage.
"""
from __future__ import annotations

import argparse
import os
import sys

from ray_tpu_torch.devtools.lint import engine

# default target: the installed ray_tpu_torch package itself, not a
# cwd-relative "ray_tpu_torch" that only resolves from the repo root
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def add_lint_parser(sub):
    """Mount the `lint` subcommand on the top-level ray_tpu_torch CLI."""
    p = sub.add_parser("lint",
                       help="framework-aware static analysis (raylint)")
    p.add_argument("paths", nargs="*", default=[_PACKAGE_ROOT],
                   help="files or directories to lint "
                        "(default: the installed ray_tpu_torch package)")
    p.add_argument("--format", choices=["text", "json"], default="text")
    p.add_argument("--select", default=None, metavar="RT001,RT002",
                   help="run only these rules")
    p.add_argument("--ignore", default=None, metavar="RT003",
                   help="skip these rules")
    p.add_argument("--rules", action="store_true",
                   help="print the rule table and exit")
    p.add_argument("--flow", action="store_true",
                   help="also run the interprocedural pass (RT020-RT023: "
                        "call-graph reachability of blocking/syscall/"
                        "host-sync/alloc effects from hot-path roots)")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help="flow-finding baseline file (default: "
                        ".raylint_torch_baseline.json in the cwd when "
                        "present)")
    p.add_argument("--write-baseline", action="store_true",
                   help="write current flow findings to the baseline "
                        "file and exit 0")
    p.set_defaults(fn=cmd_lint)
    return p


def _split(csv: str | None) -> list[str] | None:
    return [tok.strip() for tok in csv.split(",") if tok.strip()] if csv else None


def cmd_lint(args) -> int:
    import ray_tpu_torch.devtools.lint.rules  # noqa: F401  (populate registry)

    if args.rules:
        if args.format == "json":
            import json

            print(json.dumps(engine.rule_table(), indent=2))
        else:
            for row in engine.rule_table():
                print(f"{row['id']}  {row['summary']}")
                print(f"       {row['rationale']}")
        return 0
    try:
        findings = engine.lint_paths(args.paths,
                                     select=_split(args.select),
                                     ignore=_split(args.ignore))
        if args.flow or args.write_baseline:
            from ray_tpu_torch.devtools.lint import flow

            baseline = args.baseline
            if baseline is None and not args.write_baseline \
                    and os.path.isfile(flow.BASELINE_NAME):
                baseline = flow.BASELINE_NAME
            if args.write_baseline:
                out = args.baseline or flow.BASELINE_NAME
                flow.write_baseline(out, flow.analyze_paths(args.paths))
                print(f"raylint: baseline written to {out}")
                return 0
            flow_findings = flow.analyze_paths(args.paths,
                                               baseline=baseline)
            sel, ign = _split(args.select), _split(args.ignore)
            if sel:
                flow_findings = [f for f in flow_findings
                                 if f.rule_id in sel]
            if ign:
                flow_findings = [f for f in flow_findings
                                 if f.rule_id not in ign]
            findings = sorted(
                findings + flow_findings,
                key=lambda f: (f.path, f.line, f.col, f.rule_id))
    except (ValueError, OSError, KeyError) as e:
        print(f"raylint: {e}", file=sys.stderr)
        return 2
    if args.format == "json":
        print(engine.to_json(findings))
    else:
        for f in findings:
            print(f.render())
        n = len(findings)
        print(f"raylint: {n} finding{'s' if n != 1 else ''}")
    return 1 if findings else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="raylint")
    sub = parser.add_subparsers(dest="cmd", required=True)
    add_lint_parser(sub)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main(["lint", *sys.argv[1:]]))
