"""Background batch prefetching (counterpart of :mod:`music_tpu.data.prefetch`).

One producer thread keeps a small queue of batches ahead of the training
loop, so host-side batch assembly (the window gather, and on a CUDA device
the pinned host-to-device copy) overlaps the device's step.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_DONE = object()


class PrefetchBatches(Iterator[T]):
    """Iterate ``source`` on a daemon thread, keeping up to ``depth``
    batches ready.  Exceptions in the producer re-raise at the consumer's
    next step; early consumer exit (``close``/GC) stops the producer."""

    def __init__(self, source: Iterable[T], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, args=(iter(source),), daemon=True)
        self._thread.start()

    def _produce(self, it):
        try:
            for item in it:
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            self._q.put(_DONE)
        except BaseException as e:  # re-raised on the consumer side
            self._q.put(e)

    def __iter__(self):
        return self

    def __next__(self) -> T:
        item = self._q.get()
        if item is _DONE:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self):
        self._stop.set()

    def __del__(self):
        self._stop.set()
