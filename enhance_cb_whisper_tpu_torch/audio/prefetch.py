"""Host↔device pipelining: background prefetch of host-side work (a
stdlib-only copy of enhance_cb_whisper_tpu/audio/prefetch.py).

While the device scores or transcribes item N, a worker thread loads and
prepares item N+1.  :class:`PrefetchIterator` wraps any iterable with a
bounded queue fed from a daemon thread — exceptions propagate to the
consumer at the matching position.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


class PrefetchIterator(Iterator[T]):
    def __init__(self, iterable: Iterable[T], depth: int = 2):
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._iterable = iterable
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for item in self._iterable:
                # bounded put: an abandoned consumer (early break —
                # close()) must not leave this thread blocked forever
                # holding a batch
                while not self._stop.is_set():
                    try:
                        self._queue.put(("item", item), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # re-raised on the consumer side
            self._queue.put(("error", e))
        finally:
            if not self._stop.is_set():
                self._queue.put(("done", _SENTINEL))

    def close(self):
        """Stop the worker (consumer breaks early, e.g. Lightning-style
        ``limit_train_batches``); drains so the worker unblocks."""
        self._stop.set()
        self._exhausted = True
        while not self._queue.empty():
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=1.0)

    def __iter__(self):
        return self

    def __next__(self) -> T:
        # the 'done'/'error' sentinel is consumed exactly once — remember
        # exhaustion so later __next__ calls (a second for-loop, zip,
        # itertools.chain) raise StopIteration instead of blocking forever
        # on the empty queue
        if getattr(self, "_exhausted", False):
            raise StopIteration
        kind, payload = self._queue.get()
        if kind == "item":
            return payload
        self._exhausted = True
        if kind == "error":
            raise payload
        raise StopIteration


def prefetch(iterable: Iterable[T], depth: int = 2) -> Iterator[T]:
    return PrefetchIterator(iterable, depth)
