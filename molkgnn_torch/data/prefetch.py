"""Background batch prefetching: host packing overlapped with the step.

Port of ``molkgnn_tpu/data/prefetch.py``. A producer thread draws items
(host-packed batches) from an iterable while the main thread runs the train
step on the previous one; the queue holds at most ``size`` items, one in
compute and one staged at the default 2. An exception raised by the
producer is raised in the consumer, after the items produced before it.

The copy to the device stays with the caller, on the main thread (the JAX
package's default ``to_device=False``): the thread overlaps the host-side
packing, which is the work it can take off the step's path.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


def prefetch_to_device(iterable: Iterable, size: int = 2) -> Iterator:
    """The items of ``iterable`` in order, produced by a background thread
    at most ``size`` ahead of the consumer."""
    q: queue.Queue = queue.Queue(maxsize=size)
    err: list = []

    def producer():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # re-raised in the consumer
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            t.join()
            if err:
                raise err[0]
            return
        yield item
