"""One scripted workload through a package's ``util.multiprocessing.Pool``,
for ``tests/test_torch_multiprocessing.py``. Not a test module.

    python tests/_torch_multiprocessing_jax.py <out.json> [ray_tpu|ray_tpu_torch]

Starts a fresh runtime of the named package (JAX's ``ray_tpu`` by
default) in this process and writes what ``map`` (auto and explicit
chunks, an empty input), ``starmap``, ``apply``, ``apply_async`` (with its
callback), ``map_async`` (with its callback), ``imap``, ``imap_unordered``
(sorted), ``imap`` over an unbounded generator, a pool initializer, a
task's exception and a closed pool give. The test runs it for both
packages, each in a process of its own, and compares the two.
"""
import faulthandler
import importlib
import itertools
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def square(x):
    return x * x


def add(a, b):
    return a + b


def set_marker(v):
    import builtins

    builtins._rt_mp_parity_marker = v


def read_marker(_):
    import builtins

    return getattr(builtins, "_rt_mp_parity_marker", None)


def fails(x):
    if x == 3:
        raise ValueError(f"bad item {x}")
    return x


def workload(mp) -> dict:
    out: dict = {}
    with mp.Pool(processes=3, initializer=set_marker, initargs=(7,)) as p:
        out["map"] = p.map(square, range(20))
        out["map_chunks_3"] = p.map(square, range(10), chunksize=3)
        out["map_empty"] = p.map(square, [])
        out["starmap"] = p.starmap(add, [(1, 2), (3, 4), (5, 6)])
        out["apply"] = p.apply(add, (2, 3))
        got = []
        r = p.apply_async(add, (4, 5), callback=got.append)
        out["apply_async"] = [r.get(timeout=120), r.ready(), r.successful(), got]
        got_map = []
        out["map_async"] = [p.map_async(square, range(5), callback=got_map.append).get(120),
                            got_map]
        out["imap"] = list(p.imap(square, range(7), chunksize=2))
        out["imap_unordered"] = sorted(p.imap_unordered(square, range(7)))
        out["imap_unbounded"] = list(itertools.islice(p.imap(square, itertools.count(),
                                                             chunksize=2), 5))
        out["initializer"] = sorted(set(p.map(read_marker, range(6))))
        try:
            p.map(fails, range(6))
            out["error"] = None
        except Exception as e:  # the task's error, wrapped by the runtime
            out["error"] = ["ValueError" in str(e), "bad item 3" in str(e)]
    try:
        p.map(square, [1])
        out["closed"] = None
    except ValueError as e:
        out["closed"] = str(e)
    return out


def main() -> int:
    faulthandler.dump_traceback_later(110, exit=True)
    package = sys.argv[2] if len(sys.argv) > 2 else "ray_tpu"
    # idle leases go back after 0.5 s: each Pool method's tasks lease
    # workers of their own, and leases held idle would make the next wait
    os.environ["RT_WORKER_LEASE_TIMEOUT_S"] = "0.5"
    sys.path.insert(0, ROOT)
    rt = importlib.import_module(package)
    mp = importlib.import_module(f"{package}.util.multiprocessing")
    rt.init(num_cpus=8)
    try:
        out = workload(mp)
    finally:
        rt.shutdown()
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
