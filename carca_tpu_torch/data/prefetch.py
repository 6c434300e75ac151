"""Background-thread batch prefetching (counterpart of
``carca_tpu/data/prefetch.py``): one daemon thread keeps a bounded queue of
host batches full while the main thread queues device steps."""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch(iterable: Iterable[T], depth: int = 3) -> Iterator[T]:
    """Iterate ``iterable`` on a daemon thread through a queue of at most
    ``depth`` items; the producer's exceptions reach the consumer. A
    consumer that stops early releases the producer (it checks a stop flag
    between bounded puts)."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    err: list = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker() -> None:
        try:
            for item in iterable:
                if not put(item):
                    return
        except BaseException as e:  # handed to the consumer
            err.append(e)
        finally:
            put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
        t.join()
        if err:
            raise err[0]
    finally:
        stop.set()
