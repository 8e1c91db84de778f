"""Native library loader: builds the C++ store on first use and ctypes-wraps it.

The shared library is compiled from ``src/*.cc`` with g++ into
``ray_tpu_torch/_native/build/`` keyed by a source hash, so editing the C++
transparently rebuilds. No pip/pybind dependency: plain ``extern "C"`` +
ctypes, with Python mapping the same /dev/shm file for zero-copy views.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_HERE, "src")
_BUILD_DIR = os.path.join(_HERE, "build")

_lib = None
_lib_lock = threading.Lock()


def _source_files() -> list[str]:
    # rt_cpp_* is the standalone C++ worker runtime (see build_cpp_worker),
    # not part of the in-process store library
    return sorted(
        os.path.join(_SRC_DIR, f)
        for f in os.listdir(_SRC_DIR)
        if f.endswith(".cc") and not f.startswith("rt_cpp")
    )


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in _source_files():
        # one-time lazy build: get_lib() caches the CDLL, so this
        # file read never recurs per call
        with open(path, "rb") as f:  # raylint: disable=RT020 -- one-time build
            h.update(f.read())
    return h.hexdigest()[:16]


def _build() -> str:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tag = _source_hash()
    so_path = os.path.join(_BUILD_DIR, f"libray_tpu_torch_native_{tag}.so")
    if os.path.exists(so_path):
        return so_path
    tmp = so_path + f".tmp{os.getpid()}"  # raylint: disable=RT021 -- once per rebuild, not per call
    cmd = [
        "g++", "-O2", "-g", "-std=c++17", "-shared", "-fPIC",
        "-o", tmp, *_source_files(), "-lpthread", "-lrt",
    ]
    subprocess.run(cmd, check=True, capture_output=True)  # raylint: disable=RT020 -- one-time compile behind the get_lib() cache
    os.replace(tmp, so_path)  # atomic: concurrent builders race safely
    return so_path


def _build_cpp_binary(sources: list[str], runtime_cc: str, prefix: str,
                      out_path: str | None) -> str:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    runtime = os.path.join(_SRC_DIR, runtime_cc)
    headers = [os.path.join(_SRC_DIR, h)
               for h in ("picklite.h", "rt_cpp_api.h", "rt_wire.h",
                         "rt_cpp_client.h")]
    h = hashlib.sha256()
    for p in [*sources, runtime, *headers]:
        with open(p, "rb") as f:
            h.update(f.read())
    tag = h.hexdigest()[:16]
    out = out_path or os.path.join(_BUILD_DIR, f"{prefix}_{tag}")
    if os.path.exists(out):
        if out_path is None:
            return out  # hash is in the name: existing == current
        # explicit out_path: the name carries no hash, so check the sidecar
        try:
            with open(out + ".hash") as f:
                if f.read().strip() == tag:
                    return out
        except OSError:
            pass  # no/unreadable sidecar: rebuild
    tmp = out + f".tmp{os.getpid()}"
    proc = subprocess.run(
        ["g++", "-std=c++17", "-O2", "-I", _SRC_DIR, "-o", tmp,
         *sources, runtime, "-pthread"],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        # this compiles user-authored code: surface the diagnostics
        raise RuntimeError(
            f"C++ build failed (g++ exit {proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, out)
    if out_path is not None:
        with open(out + ".hash", "w") as f:
            f.write(tag)
    return out


def build_cpp_worker(sources: list[str], out_path: str | None = None) -> str:
    """Compile a C++ worker binary: user RT_REMOTE sources + the rt runtime
    (rt_cpp_worker.cc / rt_cpp_api.h / picklite.h). Hash-keyed like the
    store build; returns the binary path for RT_CPP_WORKER."""
    return _build_cpp_binary(sources, "rt_cpp_worker.cc", "rt_cpp_worker", out_path)


def build_cpp_client(sources: list[str], out_path: str | None = None) -> str:
    """Compile a C++ driver binary against the rt client runtime
    (rt_cpp_client.cc): connect to a cluster and submit C++ tasks."""
    return _build_cpp_binary(sources, "rt_cpp_client.cc", "rt_cpp_client", out_path)


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            u64 = ctypes.c_uint64
            p64 = ctypes.POINTER(u64)
            lib.rt_store_create.restype = ctypes.c_void_p
            lib.rt_store_create.argtypes = [ctypes.c_char_p, u64]
            lib.rt_store_connect.restype = ctypes.c_void_p
            lib.rt_store_connect.argtypes = [ctypes.c_char_p]
            lib.rt_store_close.argtypes = [ctypes.c_void_p]
            lib.rt_store_destroy.argtypes = [ctypes.c_char_p]
            lib.rt_store_capacity.restype = u64
            lib.rt_store_capacity.argtypes = [ctypes.c_void_p]
            lib.rt_store_bytes_in_use.restype = u64
            lib.rt_store_bytes_in_use.argtypes = [ctypes.c_void_p]
            lib.rt_store_list_spillable.restype = ctypes.c_int
            lib.rt_store_list_spillable.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, p64, ctypes.c_int]
            lib.rt_copy_nt.restype = None
            lib.rt_copy_nt.argtypes = [ctypes.c_void_p, ctypes.c_void_p, u64]
            lib.rt_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p, u64, p64]
            lib.rt_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.rt_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, p64, p64]
            lib.rt_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.rt_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.rt_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.rt_chan_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p, u64, ctypes.c_uint32, p64]
            lib.rt_chan_data.argtypes = [ctypes.c_void_p, ctypes.c_char_p, p64, p64]
            lib.rt_chan_write_acquire.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
            lib.rt_chan_write_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p, u64]
            lib.rt_chan_read_acquire.argtypes = [ctypes.c_void_p, ctypes.c_char_p, u64, ctypes.c_int64, p64, p64]
            lib.rt_chan_read_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.rt_chan_close.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            # task rings (fast-path transport)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i64 = ctypes.c_int64
            lib.rt_ring_pair_create.restype = ctypes.c_void_p
            lib.rt_ring_pair_create.argtypes = [ctypes.c_char_p, u64]
            lib.rt_ring_pair_open.restype = ctypes.c_void_p
            lib.rt_ring_pair_open.argtypes = [ctypes.c_char_p]
            lib.rt_ring_push.restype = ctypes.c_int
            lib.rt_ring_push.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, u64, i64]
            lib.rt_ring_push_raw.restype = ctypes.c_int
            lib.rt_ring_push_raw.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, u64, i64]
            lib.rt_ring_push_batch.restype = i64
            lib.rt_ring_push_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, u64, i64]
            lib.rt_ring_pop_batch.restype = i64
            lib.rt_ring_pop_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_int, u8p, u64, i64]
            lib.rt_ring_pending.restype = u64
            lib.rt_ring_pending.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.rt_ring_stats.restype = ctypes.c_int
            lib.rt_ring_stats.argtypes = [
                ctypes.c_void_p, ctypes.c_int, p64, ctypes.c_int]
            lib.rt_store_stats.restype = ctypes.c_int
            lib.rt_store_stats.argtypes = [ctypes.c_void_p, p64, ctypes.c_int]
            lib.rt_ring_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.rt_ring_closed.restype = ctypes.c_int
            lib.rt_ring_closed.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.rt_ring_pair_close.argtypes = [ctypes.c_void_p]
            lib.rt_ring_pair_destroy.argtypes = [ctypes.c_char_p]
            # chaos fault arms (devtools/chaos): runtime re-arm of the
            # env-gated counters in ring.cc / store.cc
            lib.rt_ring_chaos_set.restype = None
            lib.rt_ring_chaos_set.argtypes = [u64, u64]
            lib.rt_store_chaos_set.restype = None
            lib.rt_store_chaos_set.argtypes = [u64]
            # GCS state engine (gcs_core.cc)
            cp = ctypes.c_char_p
            lib.rt_gcs_open.restype = ctypes.c_void_p
            lib.rt_gcs_open.argtypes = [cp]
            lib.rt_gcs_close.argtypes = [ctypes.c_void_p]
            lib.rt_gcs_had_snapshot.restype = ctypes.c_int
            lib.rt_gcs_had_snapshot.argtypes = [ctypes.c_void_p]
            lib.rt_gcs_wal_records.restype = u64
            lib.rt_gcs_wal_records.argtypes = [ctypes.c_void_p]
            lib.rt_gcs_kv_put.restype = ctypes.c_int
            lib.rt_gcs_kv_put.argtypes = [
                ctypes.c_void_p, cp, u64, cp, u64, cp, u64,
                ctypes.c_int, ctypes.c_int]
            lib.rt_gcs_kv_get.restype = ctypes.c_int
            lib.rt_gcs_kv_get.argtypes = [
                ctypes.c_void_p, cp, u64, cp, u64, u8p, u64, p64]
            lib.rt_gcs_kv_del.restype = ctypes.c_int
            lib.rt_gcs_kv_del.argtypes = [
                ctypes.c_void_p, cp, u64, cp, u64, ctypes.c_int]
            lib.rt_gcs_kv_exists.restype = ctypes.c_int
            lib.rt_gcs_kv_exists.argtypes = [
                ctypes.c_void_p, cp, u64, cp, u64]
            lib.rt_gcs_kv_keys.restype = ctypes.c_int
            lib.rt_gcs_kv_keys.argtypes = [
                ctypes.c_void_p, cp, u64, cp, u64, u8p, u64, p64]
            lib.rt_gcs_kv_count.restype = u64
            lib.rt_gcs_kv_count.argtypes = [ctypes.c_void_p, cp, u64]
            lib.rt_gcs_journal_aux.restype = None
            lib.rt_gcs_journal_aux.argtypes = [ctypes.c_void_p, cp, u64]
            lib.rt_gcs_wal_ok.restype = ctypes.c_int
            lib.rt_gcs_wal_ok.argtypes = [ctypes.c_void_p]
            lib.rt_gcs_set_fsync.restype = None
            lib.rt_gcs_set_fsync.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.rt_gcs_wal_sync.restype = ctypes.c_int
            lib.rt_gcs_wal_sync.argtypes = [ctypes.c_void_p]
            lib.rt_gcs_snapshot_aux.restype = ctypes.c_int
            lib.rt_gcs_snapshot_aux.argtypes = [ctypes.c_void_p, u8p, u64, p64]
            lib.rt_gcs_aux_count.restype = u64
            lib.rt_gcs_aux_count.argtypes = [ctypes.c_void_p]
            lib.rt_gcs_aux_get.restype = ctypes.c_int
            lib.rt_gcs_aux_get.argtypes = [ctypes.c_void_p, u64, u8p, u64, p64]
            lib.rt_gcs_snapshot.restype = ctypes.c_int
            lib.rt_gcs_snapshot.argtypes = [ctypes.c_void_p, cp, u64, cp]
            # RPC mux (mux.cc)
            lib.rt_mux_create.restype = ctypes.c_void_p
            lib.rt_mux_create.argtypes = [
                cp, ctypes.c_uint16, ctypes.POINTER(ctypes.c_uint16),
                ctypes.POINTER(ctypes.c_int)]
            lib.rt_mux_recv_batch.restype = i64
            lib.rt_mux_recv_batch.argtypes = [ctypes.c_void_p, u8p, u64]
            lib.rt_mux_send.restype = ctypes.c_int
            lib.rt_mux_send.argtypes = [ctypes.c_void_p, u64, cp, u64]
            lib.rt_mux_close_conn.argtypes = [ctypes.c_void_p, u64]
            lib.rt_mux_release.argtypes = [ctypes.c_void_p, u64]
            lib.rt_mux_port.restype = ctypes.c_uint16
            lib.rt_mux_port.argtypes = [ctypes.c_void_p]
            lib.rt_mux_stop.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib
