#!/usr/bin/env python3
"""What a fresh process pays for ``import torch`` on this host, without and
with a bytecode cache (``chip_smoke.keep_bytecode``'s).

    python3 chip_import_probe.py

Each reading is a new interpreter, timed from its start to its exit:
``import torch`` twice as the environment has it, three times with
PYTHONDONTWRITEBYTECODE unset and PYTHONPYCACHEPREFIX at a cache of its
own under the git-ignored ``ray_tpu_torch/_build/`` (the first writes the
cache), and ``import torch`` plus a first CUDA tensor once each way. Then
the modules whose own import time is largest with the cache
(``-X importtime``). Prints one JSON line with the seconds, the two
environment variables and whether torch's package directory holds a
``__pycache__``; exits non-zero without a CUDA device.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
IMPORT = "import torch"
FIRST_TENSOR = ("import torch; torch.ones(1, device='cuda'); "
                "torch.cuda.synchronize()")


def run(code: str, env: dict, *flags: str) -> tuple[float, str]:
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, *flags, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    return time.perf_counter() - t0, out.stderr


def top_self(importtime: str, n: int = 8) -> list:
    """The ``n`` modules with the most self time in ``-X importtime``'s
    report, as [module, self s, cumulative s]."""
    rows = []
    for line in importtime.splitlines():
        parts = line.split("|")
        if not line.startswith("import time:") or len(parts) != 3:
            continue
        try:
            own, cum = int(parts[0].split(":")[1]), int(parts[1])
        except ValueError:
            continue  # the header
        rows.append([parts[2].strip(), own / 1e6, cum / 1e6])
    return sorted(rows, key=lambda r: -r[1])[:n]


def main() -> int:
    probe = subprocess.run([sys.executable, "-c", "import os, torch; print(os.path.dirname("
                            "torch.__file__)); print(torch.cuda.is_available())"],
                           capture_output=True, text=True, timeout=300)
    torch_dir, cuda = (probe.stdout.split() + ["", ""])[:2]
    if probe.returncode != 0 or cuda != "True":
        print("chip_import_probe: no CUDA device", file=sys.stderr)
        return 2
    as_is = dict(os.environ)
    cache = os.path.join(HERE, "ray_tpu_torch", "_build", "pycache_probe")
    os.makedirs(cache, exist_ok=True)
    cached = {k: v for k, v in os.environ.items() if k != "PYTHONDONTWRITEBYTECODE"}
    cached["PYTHONPYCACHEPREFIX"] = cache
    out = {
        "PYTHONDONTWRITEBYTECODE": os.environ.get("PYTHONDONTWRITEBYTECODE"),
        "PYTHONPYCACHEPREFIX": os.environ.get("PYTHONPYCACHEPREFIX"),
        "torch_has_pycache": os.path.isdir(os.path.join(torch_dir, "__pycache__")),
        "import_s": [run(IMPORT, as_is)[0] for _ in range(2)],
        "import_cached_s": [run(IMPORT, cached)[0] for _ in range(3)],
        "first_tensor_s": run(FIRST_TENSOR, as_is)[0],
        "first_tensor_cached_s": run(FIRST_TENSOR, cached)[0],
        "top_self_cached": top_self(run(IMPORT, cached, "-X", "importtime")[1]),
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
