"""The binding of the native tar-shard reader (``shard_loader.cpp``).

The port's copy of ``NativeShardReader`` (``ln3diff_tpu/native/build.py:47-100``):
the source is built with g++ by ``ops/_build.py`` into the git-ignored
``ln3diff_tpu_torch/_build/`` at first use, as the mesh stage's sources
are, and loaded with ``ctypes``.  A build that fails raises with the
compiler's log.
"""

from __future__ import annotations

import ctypes

from ..ops import _build


def get_shard_loader():
    """The loaded ``shard_loader`` library with its signatures set."""
    lib = _build.LIBRARIES.get('shard_loader')
    lib.ln_loader_create.restype = ctypes.c_void_p
    lib.ln_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int]
    lib.ln_loader_next_size.restype = ctypes.c_int64
    lib.ln_loader_next_size.argtypes = [ctypes.c_void_p]
    lib.ln_loader_next_copy.restype = None
    lib.ln_loader_next_copy.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_char)]
    lib.ln_loader_destroy.restype = None
    lib.ln_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


class NativeShardReader:
    """Iterate the (name, bytes) entries of tar shards in order, read
    ahead by a background thread into a queue of ``queue_cap`` entries;
    with ``loop`` the shard list repeats without end."""

    def __init__(self, paths, queue_cap: int = 256, loop: bool = False):
        self._h = None
        self._lib = get_shard_loader()
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        self._h = self._lib.ln_loader_create(arr, len(paths), queue_cap,
                                             1 if loop else 0)

    def __iter__(self):
        return self

    def __next__(self):
        size = self._lib.ln_loader_next_size(self._h)
        if size < 0:
            raise StopIteration
        buf = ctypes.create_string_buffer(size)
        self._lib.ln_loader_next_copy(self._h, buf)
        raw = buf.raw
        name_len = int.from_bytes(raw[:4], 'little')
        name = raw[4:4 + name_len].decode()
        data_len = int.from_bytes(raw[4 + name_len:12 + name_len], 'little')
        data = raw[12 + name_len:12 + name_len + data_len]
        return name, data

    def close(self):
        if self._h is not None:
            self._lib.ln_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
