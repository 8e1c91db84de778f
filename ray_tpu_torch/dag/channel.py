"""Serialized-value wrapper over the native mutable shm channels.

Counterpart of ``ray_tpu/dag/channel.py``: the Python face of the C++
versioned 1-writer-N-reader channel cells of the port's store
(``core/object_store.py``; the reference's mutable-object protocol,
ref: src/ray/core_worker/experimental_mutable_object_manager.h:44,
python/ray/experimental/channel/shared_memory_channel.py:151).

One ShmChannel = one fixed-size cell; write() blocks until every reader of
the previous version released (depth-1 backpressure — exactly the reference's
default), read() blocks for the next version. Values are serialized with the
zero-copy pickle5 layout (``utils/serialization.py``); on read the payload
is copied out of the cell before release, so a returned array never aliases
a buffer the writer is about to overwrite. A CUDA tensor crosses as its
host bytes and is restored on the reader's current card; a reader with no
CUDA device raises rather than receive a CPU tensor.
"""

from __future__ import annotations

from ray_tpu_torch.core.object_store import ChannelClosedError
from ray_tpu_torch.utils import serialization
from ray_tpu_torch.utils.ids import ObjectID


class ChannelClosed(Exception):
    pass


class ShmChannel:
    def __init__(self, store, chan_id: ObjectID, *, size: int = 8 << 20,
                 num_readers: int = 1, create: bool = False):
        self.store = store
        self.chan_id = chan_id
        self.size = size
        if create:
            store.channel_create(chan_id, size, num_readers)
        self._last_read_version = 0

    def write(self, value, timeout_ms: int = -1) -> None:
        meta, buffers = serialization.dumps_with_buffers(value)
        need = serialization.total_size(meta, buffers)
        if need > self.size:
            raise ValueError(
                f"value of {need} bytes exceeds channel capacity {self.size}; "
                f"recompile with a larger buffer_size_bytes"
            )
        try:
            buf = self.store.channel_write_acquire(self.chan_id, timeout_ms)
            serialization.pack_into(meta, buffers, buf)
            self.store.channel_write_release(self.chan_id, need)
        except ChannelClosedError:
            raise ChannelClosed(str(self.chan_id)) from None

    def read(self, timeout_ms: int = -1):
        """Returns the next version's value (copies out of the cell)."""
        try:
            payload, version = self.store.channel_read_acquire(
                self.chan_id, self._last_read_version, timeout_ms
            )
            try:
                value = serialization.unpack(bytes(payload))
            finally:
                self.store.channel_read_release(self.chan_id)
        except ChannelClosedError:
            raise ChannelClosed(str(self.chan_id)) from None
        self._last_read_version = version
        return value

    def close(self) -> None:
        self.store.channel_close(self.chan_id)
