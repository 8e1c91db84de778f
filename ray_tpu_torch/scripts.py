"""ray_tpu_torch CLI: cluster lifecycle + state inspection.

The port's copy of ``ray_tpu/scripts.py`` (ref:
python/ray/scripts/scripts.py:2734 — `ray start/stop/status` plus the
`ray list/summary/timeline` state commands from util/state/state_cli.py).

    python -m ray_tpu_torch start --head [--num-cpus N] [--num-gpus N] [--autoscale MIN:MAX]
    python -m ray_tpu_torch start --address HOST:PORT      # join as a new node
    python -m ray_tpu_torch status  [--address HOST:PORT]
    python -m ray_tpu_torch list tasks|actors|nodes|objects|pgs
    python -m ray_tpu_torch summary
    python -m ray_tpu_torch timeline --output trace.json
    python -m ray_tpu_torch dashboard [--port 8265]
    python -m ray_tpu_torch job submit|status|logs|list|stop
    python -m ray_tpu_torch serve deploy|status|shutdown
    python -m ray_tpu_torch lint [paths] [--flow] [--format json] [--rules]
    python -m ray_tpu_torch chaos run|validate|events
    python -m ray_tpu_torch stop

``start`` runs ``ray_tpu_torch.core.gcs`` and ``ray_tpu_torch.core.raylet``
as daemons; the raylet counts the node's cards itself through NVML (and
marks their ``accelerator_type``) unless ``--num-gpus`` is given. With
``--autoscale MIN:MAX`` the head also runs the internal
``_autoscaler_monitor`` command: an ``Autoscaler`` over a
``LocalSubprocessProvider`` that starts a raylet on this host while lease
demand is queued and ends it once idle (such a raylet is the monitor's
child, not in the session file; the monitor ends its raylets when ``stop``
ends it). The session file
(``$TMPDIR/ray_tpu_torch/session.json``) and the daemons' logs
(``$TMPDIR/ray_tpu_torch/logs``) sit apart from the JAX package's, so
neither package's ``stop`` reaches the other's cluster.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

SESSION_FILE = os.path.join(tempfile.gettempdir(), "ray_tpu_torch", "session.json")


def _save_session(data: dict):
    os.makedirs(os.path.dirname(SESSION_FILE), exist_ok=True)
    with open(SESSION_FILE, "w") as f:
        json.dump(data, f)


def _load_session() -> dict | None:
    try:
        with open(SESSION_FILE) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None


def _resolve_address(args) -> str:
    addr = getattr(args, "address", None)
    if addr:
        return addr
    sess = _load_session()
    if sess and sess.get("gcs_address"):
        return sess["gcs_address"]
    sys.exit("no running session found; pass --address HOST:PORT or `start --head`")


def _connect(address: str):
    import ray_tpu_torch

    ray_tpu_torch.init(address=address)
    return ray_tpu_torch


# ------------------------------------------------------------------ commands
def cmd_start(args):
    env = dict(os.environ)
    pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = pkg_parent + os.pathsep + env.get("PYTHONPATH", "")
    # daemon children get log files, NOT the CLI's stdio: inherited pipes
    # would keep callers capturing our output blocked forever
    log_dir = os.path.join(tempfile.gettempdir(), "ray_tpu_torch", "logs")
    os.makedirs(log_dir, exist_ok=True)

    def logf(name):
        return open(os.path.join(log_dir, f"{name}-{os.getpid()}.log"), "ab")

    pids = []
    if args.head:
        tmp = tempfile.mkdtemp(prefix="rt_cli_")
        addr_file = os.path.join(tmp, "gcs_addr")
        gcs = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.core.gcs", "--address-file", addr_file,
             *(("--port", str(args.port)) if args.port else ())],
            env=env, stdout=logf("gcs"), stderr=subprocess.STDOUT,
        )
        pids.append(gcs.pid)
        deadline = time.monotonic() + 30
        while not os.path.exists(addr_file):
            if time.monotonic() > deadline:
                sys.exit("GCS did not start")
            time.sleep(0.05)
        gcs_address = open(addr_file).read().strip()
    else:
        if not args.address:
            sys.exit("start needs --head or --address HOST:PORT")
        gcs_address = args.address

    raylet_cmd = [
        sys.executable, "-m", "ray_tpu_torch.core.raylet", "--gcs", gcs_address,
        "--num-cpus", str(args.num_cpus if args.num_cpus is not None
                          else (os.cpu_count() or 1)),
    ]
    if args.num_gpus is not None:
        raylet_cmd += ["--num-gpus", str(args.num_gpus)]
    if args.resources:
        raylet_cmd += ["--resources", args.resources]
    raylet = subprocess.Popen(raylet_cmd, env=env,
                              stdout=logf("raylet"), stderr=subprocess.STDOUT)
    pids.append(raylet.pid)

    autoscaler_note = ""
    if args.head and args.autoscale:
        lo, hi = (int(x) for x in args.autoscale.split(":"))
        mon = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.scripts", "_autoscaler_monitor",
             "--address", gcs_address, "--min-nodes", str(lo), "--max-nodes", str(hi)],
            env=env, stdout=logf("autoscaler"), stderr=subprocess.STDOUT,
        )
        pids.append(mon.pid)
        autoscaler_note = f", autoscaler {lo}:{hi}"

    if args.head:
        _save_session({"gcs_address": gcs_address, "pids": pids})
        print(f"ray_tpu_torch head started at {gcs_address}{autoscaler_note}")
        print(f"  connect:  ray_tpu_torch.init(address={gcs_address!r})")
        print(f"  stop:     python -m ray_tpu_torch stop")
    else:
        sess = _load_session() or {"gcs_address": gcs_address, "pids": []}
        sess["pids"] = sess.get("pids", []) + pids
        _save_session(sess)
        print(f"ray_tpu_torch node joined {gcs_address}")


def cmd_stop(args):
    sess = _load_session()
    if not sess:
        print("no session file; nothing to stop")
        return
    for pid in sess.get("pids", []):
        try:
            os.kill(pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if not any(_pid_alive(p) for p in sess.get("pids", [])):
            break
        time.sleep(0.1)
    for pid in sess.get("pids", []):
        if _pid_alive(pid):
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    try:
        os.unlink(SESSION_FILE)
    except FileNotFoundError:
        pass
    print("stopped")


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except (ProcessLookupError, PermissionError):
        return False


def cmd_serve(args):
    """serve deploy/status/shutdown against a live cluster (ref: the
    reference's `serve` CLI group mounted on `ray`, scripts.py:2734)."""
    rt = _connect(_resolve_address(args))
    from ray_tpu_torch import serve

    try:
        if args.serve_cmd == "deploy":
            handles = serve.deploy_config(args.config)
            for name in handles:
                print(f"deployed application {name!r}")
        elif args.serve_cmd == "status":
            print(json.dumps(serve.status(), indent=2, default=str))
        elif args.serve_cmd == "shutdown":
            serve.shutdown()
            print("serve shut down")
    finally:
        rt.shutdown()


def cmd_status(args):
    rt = _connect(_resolve_address(args))
    nodes = rt.nodes()
    total = rt.cluster_resources()
    avail = rt.available_resources()
    print(f"nodes: {len(nodes)}")
    for n in nodes:
        nid = n["node_id"].hex() if hasattr(n["node_id"], "hex") else n["node_id"]
        print(f"  {nid[:12]}  alive={n['alive']}  queued={n.get('queued_leases', 0)}")
    print("resources (available/total):")
    for k in sorted(total):
        print(f"  {k}: {avail.get(k, 0.0):g}/{total[k]:g}")
    rt.shutdown()


def cmd_list(args):
    from ray_tpu_torch import state

    _connect(_resolve_address(args))
    fn = {
        "tasks": state.list_tasks,
        "actors": state.list_actors,
        "nodes": state.list_nodes,
        "objects": state.list_objects,
        "pgs": state.list_placement_groups,
    }[args.what]
    rows = fn()
    print(json.dumps(rows, indent=2, default=lambda o: o.hex()
                     if hasattr(o, "hex") else str(o)))


def cmd_summary(args):
    from ray_tpu_torch import state

    _connect(_resolve_address(args))
    print(json.dumps(state.summary_tasks(), indent=2))


def cmd_timeline(args):
    from ray_tpu_torch import state

    _connect(_resolve_address(args))
    events = state.timeline(args.output)
    print(f"wrote {len(events)} trace events to {args.output}")


def cmd_dashboard(args):
    from ray_tpu_torch.dashboard import run_dashboard

    _connect(_resolve_address(args))
    print(f"dashboard on http://{args.host}:{args.port}")
    run_dashboard(args.host, args.port)


def cmd_job(args):
    """Job submission CLI (ref: `ray job submit/status/logs/list/stop`).
    With --dashboard-url, goes through the REST API + SDK; otherwise
    connects directly to the cluster (bare-shell mode)."""
    from ray_tpu_torch import job as jobmod

    if getattr(args, "entrypoint", None) is not None:
        if args.entrypoint and args.entrypoint[0] == "--":
            args.entrypoint = args.entrypoint[1:]
        if not args.entrypoint:
            sys.exit("job submit needs an entrypoint, e.g. -- python script.py")
    if getattr(args, "dashboard_url", None):
        client = jobmod.JobSubmissionClient(args.dashboard_url)
        if args.job_cmd == "submit":
            env = {"working_dir": args.working_dir} if args.working_dir else None
            import shlex

            jid = client.submit_job(entrypoint=shlex.join(args.entrypoint),
                                    runtime_env=env)
            print(jid)
            if args.wait:
                while client.get_job_status(jid) not in (
                        "SUCCEEDED", "FAILED", "STOPPED"):
                    time.sleep(0.5)
                info = client.get_job_info(jid)
                print(f"{info['status']}: {info.get('message', '')}")
                sys.exit(0 if info["status"] == "SUCCEEDED" else 1)
        elif args.job_cmd == "status":
            print(json.dumps(client.get_job_info(args.job_id), indent=2))
        elif args.job_cmd == "logs":
            print(client.get_job_logs(args.job_id), end="")
        elif args.job_cmd == "list":
            print(json.dumps(client.list_jobs(), indent=2))
        elif args.job_cmd == "stop":
            print("stopped" if client.stop_job(args.job_id) else "not running")
        return

    _connect(_resolve_address(args))
    if args.job_cmd == "submit":
        env = {"working_dir": args.working_dir} if args.working_dir else None
        import shlex

        jid = jobmod.submit_job(shlex.join(args.entrypoint), runtime_env=env)
        print(jid)
        if args.wait:
            rec = jobmod.wait_job(jid, timeout=3600)
            print(f"{rec['status']}: {rec.get('message', '')}")
            sys.exit(0 if rec["status"] == "SUCCEEDED" else 1)
    elif args.job_cmd == "status":
        print(json.dumps(jobmod.job_status(args.job_id), indent=2))
    elif args.job_cmd == "logs":
        print(jobmod.job_logs(args.job_id), end="")
    elif args.job_cmd == "list":
        print(json.dumps(jobmod.list_jobs(), indent=2))
    elif args.job_cmd == "stop":
        print("stopped" if jobmod.stop_job(args.job_id) else "not running")


def cmd_autoscaler_monitor(args):
    """Internal: run the autoscaler reconciler (launched by start --head)."""
    from ray_tpu_torch.autoscaler import Autoscaler, AutoscalerConfig, LocalSubprocessProvider

    host, port = args.address.rsplit(":", 1)
    provider = LocalSubprocessProvider(args.address)
    scaler = Autoscaler(
        (host, int(port)), provider,
        AutoscalerConfig(min_nodes=args.min_nodes, max_nodes=args.max_nodes),
    )
    stop_evt = {"stop": False}

    def _term(signum, frame):
        stop_evt["stop"] = True

    # `stop` sends SIGTERM: the provider's raylet children must die with
    # the monitor, or they (and a card worker's context) outlive the GCS.
    # They go first, and the reconciler's thread (a daemon) gets 1 s: it
    # may sit in a reconnect to the stopped GCS for up to 10 s, and `stop`
    # SIGKILLs a monitor still up after 5 s
    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    scaler.start()
    try:
        while not stop_evt["stop"]:
            time.sleep(0.2)
    finally:
        provider.shutdown()
        scaler.stop(timeout=1.0)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="ray_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("start", help="start a head node or join a cluster")
    p.add_argument("--head", action="store_true")
    p.add_argument("--address", default=None)
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--num-gpus", type=float, default=None,
                   help="cards to offer (default: the raylet counts them)")
    p.add_argument("--resources", default="")
    p.add_argument("--autoscale", default=None, metavar="MIN:MAX")
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("stop", help="stop the local session")
    p.set_defaults(fn=cmd_stop)

    p = sub.add_parser("status", help="cluster nodes + resources")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("list", help="list cluster state")
    p.add_argument("what", choices=["tasks", "actors", "nodes", "objects", "pgs"])
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("summary", help="task summary by name/state")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_summary)

    p = sub.add_parser("timeline", help="export chrome trace")
    p.add_argument("--output", default=os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch_timeline.json"))
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_timeline)

    p = sub.add_parser("dashboard", help="serve the web dashboard")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8265)
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_dashboard)

    p = sub.add_parser("job", help="submit and manage cluster jobs")
    jsub = p.add_subparsers(dest="job_cmd", required=True)
    js = jsub.add_parser("submit")
    js.add_argument("--address", default=None)
    js.add_argument("--dashboard-url", default=None)
    js.add_argument("--working-dir", default=None)
    js.add_argument("--wait", action="store_true",
                    help="block until the job finishes; exit 0 on success")
    js.add_argument("entrypoint", nargs=argparse.REMAINDER,
                    help="command to run, e.g. -- python script.py")
    js.set_defaults(fn=cmd_job)
    for verb in ("status", "logs", "stop"):
        jp = jsub.add_parser(verb)
        jp.add_argument("job_id")
        jp.add_argument("--address", default=None)
        jp.add_argument("--dashboard-url", default=None)
        jp.set_defaults(fn=cmd_job)
    jp = jsub.add_parser("list")
    jp.add_argument("--address", default=None)
    jp.add_argument("--dashboard-url", default=None)
    jp.set_defaults(fn=cmd_job)

    p = sub.add_parser("serve", help="deploy and manage serve applications")
    ssub = p.add_subparsers(dest="serve_cmd", required=True)
    sp = ssub.add_parser("deploy", help="deploy apps from a YAML config")
    sp.add_argument("config", help="path to a ServeDeploySchema YAML")
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_serve)
    sp = ssub.add_parser("status")
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_serve)
    sp = ssub.add_parser("shutdown")
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_serve)

    from ray_tpu_torch.devtools.lint.cli import add_lint_parser, cmd_lint

    lp = add_lint_parser(sub)
    # cmd_lint returns an exit code rather than printing-and-returning;
    # adapt it to the `args.fn(args)` convention the other commands use
    lp.set_defaults(fn=lambda args: sys.exit(cmd_lint(args)))

    from ray_tpu_torch.devtools.chaos.cli import add_chaos_parser, cmd_chaos

    cp = add_chaos_parser(sub)
    cp.set_defaults(fn=lambda args: sys.exit(cmd_chaos(args)))

    p = sub.add_parser("_autoscaler_monitor")
    p.add_argument("--address", required=True)
    p.add_argument("--min-nodes", type=int, default=1)
    p.add_argument("--max-nodes", type=int, default=4)
    p.set_defaults(fn=cmd_autoscaler_monitor)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
