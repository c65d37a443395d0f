"""Threaded double-buffered batch prefetcher.

The port's copy of ``seam_match_rcnn_tpu/data/prefetch.py`` (the port imports
nothing of the JAX package): a worker thread decodes the next items of an
iterable while the device computes on the current one; ``depth`` items are
kept in flight (double buffering by default).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, TypeVar

T = TypeVar("T")
_SENTINEL = object()


class Prefetcher:
    """Iterator over ``iterable`` with a decode-ahead worker thread.

    Exhaustion-safe (``__next__`` after the end keeps raising
    StopIteration instead of blocking on the dead worker) and
    abandonment-safe: ``close()`` — also wired into ``__del__`` and
    context-manager exit — unblocks and retires the worker, so an
    exception in the consuming epoch loop doesn't leak a thread pinning
    ``depth`` decoded batches.
    """

    def __init__(self, iterable: Iterable[T], depth: int = 2,
                 transform: Optional[Callable] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._transform = transform
        self._err: Optional[BaseException] = None
        self._done = False
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, args=(iter(iterable),), daemon=True
        )
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that aborts when close() is requested."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, it: Iterator[T]):
        try:
            for item in it:
                if self._stop.is_set():
                    return
                if self._transform is not None:
                    item = self._transform(item)
                if not self._put(item):
                    return
        except BaseException as e:  # propagate to consumer
            self._err = e
        finally:
            self._put(_SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        item = self._q.get()
        if item is _SENTINEL:
            self._done = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        """Stop the worker and drop buffered batches (idempotent)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
        self._done = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover - GC timing dependent
        try:
            self._stop.set()
        except Exception:
            pass


def prefetch(iterable: Iterable[T], depth: int = 2,
             transform: Optional[Callable] = None) -> Prefetcher:
    return Prefetcher(iterable, depth=depth, transform=transform)
