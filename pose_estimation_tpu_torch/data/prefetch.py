"""Background-thread batch prefetcher (counterpart of data/prefetch.py): a
thread assembles the next batches on the host while the device runs the
current step. Depth 2."""

from __future__ import annotations

import queue
import threading
from typing import Iterator

_DONE = object()
DEPTH = 2


class Prefetcher:
    """Iterate over `batches` (an iterator) with up to DEPTH of them
    built ahead by a worker thread. An exception in the worker is raised
    by the consumer's next(). `close()` stops the worker early."""

    def __init__(self, batches: Iterator):
        self._q: queue.Queue = queue.Queue(maxsize=DEPTH)
        self._stop = threading.Event()
        self._err = None
        self._t = threading.Thread(target=self._work, args=(batches,),
                                   daemon=True)
        self._t.start()

    def _work(self, batches):
        try:
            for b in batches:
                if self._stop.is_set():
                    return
                self._q.put(b)
        except Exception as e:  # handed to the consumer by __next__
            self._err = e
        finally:
            self._q.put(_DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is _DONE:
            self._q.put(_DONE)          # later next() calls stop too
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self, timeout: float = 60.0):
        """Stop the worker and wait for it: drain the queue so that a put
        it is blocked in returns."""
        self._stop.set()
        while self._t.is_alive():
            try:
                self._q.get(timeout=0.1)
            except queue.Empty:
                pass
            self._t.join(timeout=0.1)
            timeout -= 0.2
            if timeout <= 0:
                raise TimeoutError("prefetch worker did not stop")


def prefetched_epoch(dataset, index_batches, generator, crop_size: int,
                     num_points: int) -> Prefetcher:
    """The prefetched batch stream of one epoch: make_batch for each row
    of `index_batches`, the choose draws taken from `generator` in
    order."""
    from pose_estimation_tpu_torch.data.batching import make_batch

    def gen():
        for idx in index_batches:
            yield make_batch(dataset, idx, generator, crop_size, num_points)

    return Prefetcher(gen())
