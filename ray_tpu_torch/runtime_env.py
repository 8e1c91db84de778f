"""Runtime environments: ship the driver's code directory to workers.

Counterpart of the reference runtime-env subsystem (ref:
python/ray/_private/runtime_env/working_dir.py — zip+hash upload,
worker-side download/extract/sys.path; env_vars plugin; pip.py / uv.py
package plugins; plugin.py's RuntimeEnvPlugin ABC). The GCS KV is the
package store (the reference's GCS-backed package URI role):

    ray_tpu_torch.init(runtime_env={
        "working_dir": "./my_project",        # zipped -> GCS -> workers
        "env_vars": {"TOKENIZERS_PARALLELISM": "false"},
        "py_modules": ["./libs/extra_pkg"],   # each added to sys.path
        "pip": ["somepkg==1.2", "/path/to/local.whl"],  # venv-per-env
        "uv": [...],                          # same, via uv's resolver
    })

Workers apply the env before the first user code runs: extract packages
to a content-addressed cache, prepend to sys.path, chdir into
working_dir, export env_vars; pip/uv requirement sets build a venv keyed
by the requirement digest (built once per node, shared by every worker
and cross-checked through a GCS-KV record of the requirement set).

Additional fields are pluggable: subclass :class:`RuntimeEnvPlugin` and
:func:`register_plugin` it (the reference's plugin.py extension point).
"""
from __future__ import annotations

import hashlib
import io
import os
import subprocess
import sys
import tempfile
import zipfile

_EXCLUDE_DIRS = {".git", "__pycache__", ".venv", "node_modules", ".eggs"}
MAX_PACKAGE_BYTES = 100 * 1024 * 1024  # reference default working_dir cap


def _zip_dir(path: str) -> bytes:
    buf = io.BytesIO()
    total = 0
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(path):
            dirs[:] = [d for d in dirs if d not in _EXCLUDE_DIRS]
            for fname in files:
                full = os.path.join(root, fname)
                rel = os.path.relpath(full, path)
                total += os.path.getsize(full)
                if total > MAX_PACKAGE_BYTES:
                    raise ValueError(
                        f"working_dir {path!r} exceeds "
                        f"{MAX_PACKAGE_BYTES >> 20}MB (pare it down or use "
                        "py_modules for just the code)"
                    )
                zf.write(full, rel)
    return buf.getvalue()


def package_runtime_env(env: dict, kv_put) -> dict:
    """Driver side: zip+upload dirs once (content-addressed), return the
    descriptor that travels in task/actor specs.

    kv_put(key, blob) stores a package (GCS KV ns=runtime_env_packages)."""
    desc: dict = {}
    if env.get("env_vars"):
        desc["env_vars"] = {str(k): str(v) for k, v in env["env_vars"].items()}
    for field, many in (("working_dir", False), ("py_modules", True)):
        src = env.get(field)
        if not src:
            continue
        paths = src if many else [src]
        hashes = []
        for p in paths:
            p = os.path.abspath(os.path.expanduser(p))
            if os.path.isdir(p):
                blob = _zip_dir(p)
            elif (field == "py_modules" and os.path.isfile(p)
                    and p.endswith(".py")):
                # single-module shorthand (ref: py_modules.py accepts
                # files): a one-entry zip keeps the extract path uniform
                import io as _io
                import zipfile as _zf

                buf = _io.BytesIO()
                with _zf.ZipFile(buf, "w", _zf.ZIP_DEFLATED) as z:
                    z.write(p, os.path.basename(p))
                blob = buf.getvalue()
            else:
                raise ValueError(
                    f"runtime_env {field}: {p!r} is not a directory"
                    + (" or .py file" if field == "py_modules" else ""))
            digest = hashlib.sha1(blob).hexdigest()
            kv_put(digest, blob)
            hashes.append(digest)
        desc[field] = hashes if many else hashes[0]
    for name, plugin in _PLUGINS.items():
        if env.get(name) is not None:
            desc[name] = plugin.package(env[name], kv_put)
    unknown = (set(env) - {"working_dir", "py_modules", "env_vars"}
               - set(_PLUGINS))
    if unknown:
        raise ValueError(f"unsupported runtime_env fields: {sorted(unknown)}")
    return desc


def _cache_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "ray_tpu_torch", "runtime_envs")


def _extract_package(digest: str, blob: bytes) -> str:
    """Content-addressed extraction (idempotent across workers)."""
    dest = os.path.join(_cache_dir(), digest)
    done = dest + ".done"
    if os.path.exists(done):
        return dest
    tmp = dest + f".tmp{os.getpid()}"
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        zf.extractall(tmp)
    try:
        os.replace(tmp, dest)  # atomic claim; losers fall through
    except OSError:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    open(done, "w").close()
    return dest


def apply_runtime_env(desc: dict, kv_get) -> None:
    """Worker side: materialize the descriptor before user code runs.
    kv_get(key) fetches a package blob."""
    for k, v in desc.get("env_vars", {}).items():
        os.environ[k] = v
    for digest in desc.get("py_modules", []):
        path = _materialize(digest, kv_get)
        if path not in sys.path:
            sys.path.insert(0, path)
    wd = desc.get("working_dir")
    if wd:
        path = _materialize(wd, kv_get)
        if path not in sys.path:
            sys.path.insert(0, path)
        os.chdir(path)
    for name, plugin in _PLUGINS.items():
        if desc.get(name) is not None:
            plugin.apply(desc[name], kv_get)


def _materialize(digest: str, kv_get) -> str:
    dest = os.path.join(_cache_dir(), digest)
    if os.path.exists(dest + ".done"):
        return dest
    blob = kv_get(digest)
    if blob is None:
        raise RuntimeError(f"runtime_env package {digest} missing from the GCS")
    return _extract_package(digest, blob)


# ------------------------------------------------------------ plugin system
class RuntimeEnvPlugin:
    """Extension point for additional runtime_env fields (ref:
    _private/runtime_env/plugin.py RuntimeEnvPlugin).

    ``package`` runs driver-side once per submission (normalize the user
    value, upload anything big through ``kv_put``); ``apply`` runs in the
    worker before user code (materialize, mutate sys.path/os.environ)."""

    name: str = ""

    def package(self, value, kv_put):
        return value

    def apply(self, value, kv_get) -> None:
        raise NotImplementedError


_PLUGINS: dict[str, RuntimeEnvPlugin] = {}


def register_plugin(plugin: RuntimeEnvPlugin) -> None:
    if not plugin.name:
        raise ValueError("plugin needs a name")
    _PLUGINS[plugin.name] = plugin


def plugin_blob_keys(desc: dict) -> list[str]:
    """KV keys a worker must prefetch to apply this descriptor's plugin
    fields (wheel payloads shipped by content)."""
    keys = []
    for name in _PLUGINS:
        value = desc.get(name)
        if isinstance(value, dict):
            for r in value.get("requirements", []):
                if isinstance(r, str) and r.startswith("@WHEEL:"):
                    keys.append("whl-" + r.split(":", 2)[1])
    return keys


class _PipPlugin(RuntimeEnvPlugin):
    """Venv-per-requirement-set package installs (ref:
    _private/runtime_env/pip.py; the uv subclass mirrors uv.py).

    The descriptor carries the normalized requirement list plus a digest
    of (requirements, python version, tool). Workers build ONE venv per
    digest under the node-local cache — concurrent workers serialize on
    an exclusive lock file and reuse the finished build — then splice the
    venv's site-packages into ``sys.path`` (workers are long-lived
    processes; re-exec'ing under the venv python would drop their live
    raylet registration). ``--system-site-packages`` keeps the base
    environment (torch et al.) visible beneath the env's packages. The
    requirement set is also recorded in the GCS KV under the digest so
    any node can reconstruct the env from the descriptor alone."""

    name = "pip"
    tool = "pip"

    def package(self, value, kv_put):
        raw = value.get("packages") if isinstance(value, dict) else value
        raw = [str(r) for r in (raw or [])]
        if not raw:
            raise ValueError(f"runtime_env {self.name}: empty requirement list")
        reqs = []
        for r in raw:
            p = os.path.abspath(os.path.expanduser(r))
            if os.path.isfile(p):
                # local wheel/sdist: ship by CONTENT — the path means
                # nothing on other nodes, and hashing bytes (not the path
                # string) means a rebuilt wheel gets a fresh venv
                with open(p, "rb") as f:
                    blob = f.read()
                d = hashlib.sha1(blob).hexdigest()
                kv_put(f"whl-{d}", blob)
                reqs.append(f"@WHEEL:{d}:{os.path.basename(p)}")
            else:
                reqs.append(r)
        digest = hashlib.sha1(
            ("\n".join(sorted(reqs)) + sys.version + self.tool).encode()
        ).hexdigest()
        kv_put(f"reqs-{digest}", "\n".join(reqs).encode())
        return {"requirements": reqs, "digest": digest}

    def apply(self, value, kv_get) -> None:
        venv_dir = os.path.join(_cache_dir(), "venvs", value["digest"])
        done = venv_dir + ".done"
        if not os.path.exists(done):
            self._build(venv_dir, done, value["requirements"], kv_get)
        self._activate(venv_dir)

    # ------------------------------------------------------------- build
    def _build(self, venv_dir: str, done: str, reqs: list[str],
               kv_get) -> None:
        import fcntl

        os.makedirs(os.path.dirname(venv_dir), exist_ok=True)
        with open(venv_dir + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if os.path.exists(done):  # another worker built it meanwhile
                return
            import venv as venv_mod

            # no ensurepip (it costs ~10s): installs run through the BASE
            # interpreter's pip targeting the venv via --python
            venv_mod.create(venv_dir, with_pip=False,
                            system_site_packages=True, clear=True)
            lines = []
            for r in reqs:
                if r.startswith("@WHEEL:"):
                    _, d, fname = r.split(":", 2)
                    blob = kv_get(f"whl-{d}")
                    if blob is None:
                        raise RuntimeError(
                            f"runtime_env wheel whl-{d} missing from GCS")
                    wpath = os.path.join(venv_dir, fname)
                    with open(wpath, "wb") as f:
                        f.write(blob)
                    lines.append(wpath)
                else:
                    lines.append(r)
            req_file = os.path.join(venv_dir, "requirements.txt")
            with open(req_file, "w") as f:
                f.write("\n".join(lines) + "\n")
            py = os.path.join(venv_dir, "bin", "python")
            cmd = self._install_cmd(py, req_file)
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"runtime_env {self.name} install failed "
                    f"({' '.join(cmd)}):\n{proc.stderr[-2000:]}")
            open(done, "w").close()

    def _install_cmd(self, venv_python: str, req_file: str) -> list[str]:
        return [sys.executable, "-m", "pip", "--python", venv_python,
                "install", "--no-input", "-r", req_file]

    # ---------------------------------------------------------- activate
    def _activate(self, venv_dir: str) -> None:
        import glob

        sites = glob.glob(os.path.join(
            venv_dir, "lib", "python*", "site-packages"))
        for sp in sites:
            if sp not in sys.path:
                sys.path.insert(0, sp)
        os.environ["VIRTUAL_ENV"] = venv_dir
        os.environ["PATH"] = (os.path.join(venv_dir, "bin") + os.pathsep
                              + os.environ.get("PATH", ""))


class _CondaPlugin(RuntimeEnvPlugin):
    """Conda environments (ref: _private/runtime_env/conda.py).

    value = an existing env name (activate its site-packages) or an
    environment dict ({"dependencies": [...]}, the environment.yml
    shape) built once per content digest. Hard-gated on a conda binary:
    a host without conda fails at PACKAGE time (driver side, loudly)
    rather than half-applying on a worker."""

    name = "conda"

    def _conda(self) -> str:
        import shutil

        exe = shutil.which("conda") or shutil.which("mamba")
        if exe is None:
            raise RuntimeError(
                "runtime_env conda: no conda/mamba binary on PATH "
                "(install one, or use the pip/uv runtime_env instead)")
        return exe

    def package(self, value, kv_put):
        self._conda()  # fail driver-side when conda is absent
        if isinstance(value, str):
            return {"env_name": value}
        if isinstance(value, dict):
            import json as _json

            spec = _json.dumps(value, sort_keys=True)
            digest = hashlib.sha1(spec.encode()).hexdigest()
            kv_put(f"conda-{digest}", spec.encode())
            return {"spec_digest": digest}
        raise ValueError("runtime_env conda: expected env name or dict")

    def apply(self, value, kv_get) -> None:
        import glob
        import json as _json

        conda = self._conda()
        if "env_name" in value:
            out = subprocess.run([conda, "env", "list", "--json"],
                                 capture_output=True, text=True)
            envs = _json.loads(out.stdout or "{}").get("envs", [])
            prefix = next((e for e in envs
                           if os.path.basename(e) == value["env_name"]),
                          None)
            if prefix is None:
                raise RuntimeError(
                    f"runtime_env conda: env {value['env_name']!r} not found")
        else:
            digest = value["spec_digest"]
            prefix = os.path.join(_cache_dir(), "conda", digest)
            done = prefix + ".done"
            if not os.path.exists(done):
                import fcntl

                os.makedirs(os.path.dirname(prefix), exist_ok=True)
                with open(prefix + ".lock", "w") as lock:
                    fcntl.flock(lock, fcntl.LOCK_EX)
                    if not os.path.exists(done):
                        blob = kv_get(f"conda-{digest}")
                        if blob is None:
                            raise RuntimeError(
                                f"runtime_env conda spec {digest} missing")
                        spec_file = prefix + ".yml"
                        import yaml

                        with open(spec_file, "w") as f:
                            yaml.safe_dump(_json.loads(blob), f)
                        proc = subprocess.run(
                            [conda, "env", "create", "-p", prefix,
                             "-f", spec_file, "--yes"],
                            capture_output=True, text=True)
                        if proc.returncode != 0:
                            raise RuntimeError(
                                "runtime_env conda create failed:\n"
                                + proc.stderr[-2000:])
                        open(done, "w").close()
        sites = glob.glob(os.path.join(
            prefix, "lib", "python*", "site-packages"))
        for sp in sites:
            if sp not in sys.path:
                sys.path.insert(0, sp)
        os.environ["CONDA_PREFIX"] = prefix
        os.environ["PATH"] = (os.path.join(prefix, "bin") + os.pathsep
                              + os.environ.get("PATH", ""))


class _ImageUriPlugin(RuntimeEnvPlugin):
    """image_uri placeholder (ref: _private/runtime_env/image_uri.py runs
    workers inside a podman container). Worker-in-container needs raylet
    spawn integration, not a sys.path splice — reject loudly instead of
    silently ignoring the field."""

    name = "image_uri"

    def package(self, value, kv_put):
        raise NotImplementedError(
            "runtime_env image_uri is not supported by this runtime: "
            "workers run as host processes (use pip/uv/conda envs, or run "
            "the whole node inside the image)")

    def apply(self, value, kv_get) -> None:  # pragma: no cover
        raise NotImplementedError


class _UvPlugin(_PipPlugin):
    """uv-resolved variant (ref: _private/runtime_env/uv.py). Falls back
    to pip when no uv binary is on PATH."""

    name = "uv"
    tool = "uv"

    def _install_cmd(self, venv_python: str, req_file: str) -> list[str]:
        import shutil

        uv = shutil.which("uv")
        if uv is None:
            return [sys.executable, "-m", "pip", "--python", venv_python,
                    "install", "--no-input", "-r", req_file]
        return [uv, "pip", "install", "--python", venv_python,
                "-r", req_file]


register_plugin(_PipPlugin())
register_plugin(_UvPlugin())
register_plugin(_CondaPlugin())
register_plugin(_ImageUriPlugin())
