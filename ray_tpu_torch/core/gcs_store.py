"""ctypes face of the native GCS state engine (_native/src/gcs_core.cc).

The GCS server keeps every table byte in C++ — KV maps, the write-ahead
journal, snapshot/recovery — and Python only dispatches RPCs and runs
policy (ref: src/ray/gcs/gcs_server/store_client/redis_store_client.cc +
gcs_table_storage.h role). All calls release the GIL for the native
operation.

Values are tag-encoded so arbitrary Python objects survive the byte
store: b"\\x00" + raw bytes for the common case (the wire contract is
bytes), b"\\x01" + pickle for anything else.
"""

from __future__ import annotations

import ctypes
import pickle
from typing import Any

from ray_tpu_torch import _native

_GET_BUF = 256 * 1024  # initial copy-out buffer; grows on -9


class NativeGcsStore:
    def __init__(self, persist_path: str | None):
        self._lib = _native.get_lib()
        self._h = self._lib.rt_gcs_open(
            persist_path.encode() if persist_path else b"")
        if not self._h:
            raise OSError("could not open native gcs store")
        self._buf = ctypes.create_string_buffer(_GET_BUF)
        self._len = ctypes.c_uint64(0)

    # ------------------------------------------------------------- helpers
    @staticmethod
    def _enc(value: Any) -> bytes:
        if isinstance(value, bytes):
            return b"\x00" + value
        if isinstance(value, bytearray):
            return b"\x00" + bytes(value)
        return b"\x01" + pickle.dumps(value)

    @staticmethod
    def _dec(blob: bytes) -> Any:
        if blob[:1] == b"\x00":
            return blob[1:]
        return pickle.loads(blob[1:])

    def _copy_call(self, fn, *args) -> bytes | None:
        """Run a copy-out API, growing the buffer on -9 (too small)."""
        while True:
            st = fn(self._h, *args,
                    ctypes.cast(self._buf, ctypes.POINTER(ctypes.c_uint8)),
                    len(self._buf), ctypes.byref(self._len))
            if st == 0:
                return self._buf.raw[: self._len.value]
            if st == -9:
                self._buf = ctypes.create_string_buffer(
                    max(self._len.value, len(self._buf) * 2))
                continue
            return None

    # ------------------------------------------------------------------ kv
    def put(self, ns: str, key: str, value: Any, *, overwrite: bool = True,
            journal: bool = True) -> bool:
        v = self._enc(value)
        k = key.encode()
        n = ns.encode()
        return bool(self._lib.rt_gcs_kv_put(
            self._h, n, len(n), k, len(k), v, len(v),
            1 if overwrite else 0, 1 if journal else 0))

    def get(self, ns: str, key: str) -> Any | None:
        k = key.encode()
        n = ns.encode()
        blob = self._copy_call(self._lib.rt_gcs_kv_get, n, len(n), k, len(k))
        return None if blob is None else self._dec(blob)

    def multi_get(self, ns: str, keys: list[str]) -> dict[str, Any]:
        return {k: self.get(ns, k) for k in keys}

    def delete(self, ns: str, key: str, *, journal: bool = True) -> bool:
        k = key.encode()
        n = ns.encode()
        return bool(self._lib.rt_gcs_kv_del(
            self._h, n, len(n), k, len(k), 1 if journal else 0))

    def exists(self, ns: str, key: str) -> bool:
        k = key.encode()
        n = ns.encode()
        return bool(self._lib.rt_gcs_kv_exists(self._h, n, len(n), k, len(k)))

    def keys(self, ns: str, prefix: str = "") -> list[str]:
        n = ns.encode()
        p = prefix.encode()
        packed = self._copy_call(
            self._lib.rt_gcs_kv_keys, n, len(n), p, len(p))
        out: list[str] = []
        if not packed:
            return out
        import struct

        off = 0
        while off + 4 <= len(packed):
            (ln,) = struct.unpack_from("<I", packed, off)
            out.append(packed[off + 4: off + 4 + ln].decode())
            off += 4 + ln
        return out

    def count(self, ns: str) -> int:
        n = ns.encode()
        return int(self._lib.rt_gcs_kv_count(self._h, n, len(n)))

    # ------------------------------------------------------- journal + snap
    def journal_aux(self, payload: bytes) -> None:
        self._lib.rt_gcs_journal_aux(self._h, payload, len(payload))

    @property
    def wal_ok(self) -> bool:
        return bool(self._lib.rt_gcs_wal_ok(self._h))

    def set_fsync(self, on: bool) -> None:
        """Opt-in machine-crash durability: snapshot writes fsync before
        the rename (+ directory fsync after), and wal_sync() becomes the
        group-commit gate for journaled table writes."""
        self._lib.rt_gcs_set_fsync(self._h, 1 if on else 0)

    def wal_sync(self) -> bool:
        """fdatasync records appended since the last sync (no-op when the
        WAL is clean). Releases the GIL for the disk sync."""
        return self._lib.rt_gcs_wal_sync(self._h) == 0

    @property
    def had_snapshot(self) -> bool:
        return bool(self._lib.rt_gcs_had_snapshot(self._h))

    @property
    def wal_records(self) -> int:
        """Records applied during open()'s WAL replay."""
        return int(self._lib.rt_gcs_wal_records(self._h))

    def snapshot(self, aux: bytes, *, skip_ns: str = "metrics") -> bool:
        return self._lib.rt_gcs_snapshot(
            self._h, aux, len(aux), skip_ns.encode()) == 0

    def recovered_snapshot_aux(self) -> bytes:
        return self._copy_call(self._lib.rt_gcs_snapshot_aux) or b""

    def recovered_aux_records(self) -> list[bytes]:
        out = []
        for i in range(int(self._lib.rt_gcs_aux_count(self._h))):
            blob = self._copy_call(self._lib.rt_gcs_aux_get, i)
            if blob is not None:
                out.append(blob)
        return out

    def close(self) -> None:
        if self._h:
            self._lib.rt_gcs_close(self._h)
            self._h = None
