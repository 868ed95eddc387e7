"""
The stage files' ``.npz`` writer: ``np.savez_compressed``'s file, with
each member deflated in chunks on a pool of host threads.

``zipfile`` writes the container as numpy has it (members ``<name>.npy``
in the given order, ``ZIP_DEFLATED``, a zip64 extra field on every
member, CRC-32 and sizes, the central directory) and
``np.lib.format.write_array`` each member's bytes, so a member inflates
to numpy's bytes exactly.  Only the deflate stream differs: a member
longer than :data:`CHUNK` bytes is cut into chunks of that size, each
deflated at zlib's default level (numpy's) on the shared pool, primed
with the previous chunk's last 32 KiB as its dictionary, every chunk but
the last ending in a sync flush (pigz's scheme).  The chunks, joined in
order, are one valid raw deflate stream, a few bytes a chunk longer than
a serial one.  zlib lets go of the interpreter lock while it deflates,
so the chunks run on as many cores as the pool has.  A member of one
chunk, or a pool of one worker, is one stream, numpy's own.
"""

from __future__ import annotations

import collections
import os
import threading
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: bytes of a member's stream a chunk deflates: from 256 KiB to 4 MiB the
#: rate ties on an 8-core H100 host, and from 1 MiB on the file is within
#: 1e-5 of numpy's size (``tools/bench_npz_writer.py``)
CHUNK = 1 << 20
#: the deflate window: how much of the previous chunk primes the next
WINDOW = 1 << 15
#: the most deflate workers a process takes: the rate grows by a worker's
#: ≈ 15 MB/s up to a host's cores, and 8 is one card's share of a
#: four-card host's 32 cores
MAX_WORKERS = 8

_pool_lock = threading.Lock()
_shared = None


def shared_pool():
    """``(executor, workers)``: the deflate pool every stage file shares,
    made at its first use.  Its size is the cores this process may run
    on less one (the launch loop's), at most :data:`MAX_WORKERS`; with
    one worker there is no pool (``executor`` None).  Only rank 0 writes
    stage files (``parallel.is_io_process``), so a host's ranks do not
    share these cores out among several writers."""
    global _shared
    with _pool_lock:
        if _shared is None:
            cores = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
                     else os.cpu_count() or 1)
            n = max(1, min(MAX_WORKERS, cores - 1))
            _shared = (ThreadPoolExecutor(n, thread_name_prefix="npz_deflate") if n > 1
                       else None, n)
        return _shared


def _deflate(data: bytes, zdict: bytes, final: bool) -> bytes:
    """One chunk of a raw deflate stream, primed with ``zdict``."""
    c = zlib.compressobj(zlib.Z_DEFAULT_COMPRESSION, zlib.DEFLATED, -zlib.MAX_WBITS,
                         **({"zdict": zdict} if zdict else {}))
    return c.compress(data) + c.flush(zlib.Z_FINISH if final else zlib.Z_SYNC_FLUSH)


class _ChunkedDeflate:
    """A member's compressor as ``zipfile`` calls it (``compress``, then
    ``flush``): whole chunks go to the pool as they fill, at most twice
    the workers in flight, and come back in order.  The last chunk waits
    for ``flush``, so that it alone ends the stream."""

    def __init__(self, executor, workers: int):
        self._executor = executor
        self._limit = 2 * workers
        self._buf = bytearray()
        self._zdict = b""
        self._inflight = collections.deque()
        self._failed = False
        self.chunks = 0

    def _drain(self, keep: int) -> bytes:
        out = []
        try:
            while len(self._inflight) > keep:
                out.append(self._inflight.popleft().result())
        except BaseException:
            self._failed = True
            for f in self._inflight:
                f.cancel()
            self._inflight.clear()
            raise
        return b"".join(out)

    def _submit(self, data: bytes, final: bool) -> bytes:
        done = self._drain(self._limit - 1)
        self._inflight.append(self._executor.submit(_deflate, data, self._zdict, final))
        self._zdict = data[-WINDOW:]
        self.chunks += 1
        return done

    def compress(self, data) -> bytes:
        self._buf += data
        out = []
        while len(self._buf) > CHUNK:
            out.append(self._submit(bytes(self._buf[:CHUNK]), final=False))
            del self._buf[:CHUNK]
        return b"".join(out)

    def flush(self) -> bytes:
        if self._failed:       # the write is being abandoned
            return b""
        done = self._submit(bytes(self._buf), final=True)
        self._buf = bytearray()
        return done + self._drain(0)


def savez_deflated(file, arrays: dict) -> int:
    """Write ``arrays`` to ``file`` (a path or a binary file open for
    writing) as ``np.savez_compressed(file, **arrays)`` does, deflating
    each member on :func:`shared_pool`.  Returns the bytes of the arrays
    that were deflated as more than one chunk on more than one worker."""
    executor, workers = shared_pool()
    pooled = 0
    with zipfile.ZipFile(file, mode="w", compression=zipfile.ZIP_DEFLATED,
                         allowZip64=True) as zipf:
        for key, val in arrays.items():
            val = np.asanyarray(val)
            # numpy forces zip64 on every member (numpy gh-10776)
            with zipf.open(key + ".npy", "w", force_zip64=True) as fid:
                chunked = None
                if executor is not None:
                    if not hasattr(fid, "_compressor"):
                        raise RuntimeError("zipfile's member writer has no _compressor to "
                                           "replace")
                    chunked = fid._compressor = _ChunkedDeflate(executor, workers)
                np.lib.format.write_array(fid, val, allow_pickle=True)
            if chunked is not None and chunked.chunks > 1:
                pooled += val.nbytes
    return pooled
