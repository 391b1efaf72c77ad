"""Background data loading: item fetch on worker threads, batch prefetch.

Counterpart of ``nbss_tpu/data/prefetch.py``. The corpus datasets build
each item on the host with numpy and scipy (file reads, ``fftconvolve``,
FFTs, which release the GIL), so a pool of threads makes the items while
the card runs the step, and a small queue keeps finished batches ready.

Batches come out in the sampler's order and equal ``BatchLoader``'s for any
worker count: items depend on ``(index, seed)`` alone. At most
``num_workers + batch_size`` items are in flight. An exception raised while
making an item is raised again in the consumer. When the consumer stops
early (``break``, or ``close()`` on the iterator), the producer thread stops
and is joined before the iterator returns.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

from nbss_tpu_torch.data.sampler import BatchLoader

_END = object()


class ThreadedLoader(BatchLoader):
    """A ``BatchLoader`` whose items are made by ``num_workers`` threads,
    with up to ``prefetch`` collated batches queued ahead of the consumer.
    With ``ranks`` (ranks on the host, this rank) the threads make only this
    rank's rows of each host batch."""

    def __init__(self, dataset, batch_size: int, sampler, num_workers: int = 4,
                 prefetch: int = 2, drop_last: bool = True, ranks=(1, 0)):
        super().__init__(dataset, batch_size, sampler, drop_last, ranks)
        self.num_workers = num_workers
        self.prefetch = prefetch

    def __iter__(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(obj) -> bool:
            """Queue obj unless the consumer has gone; False once it has."""
            while not stop.is_set():
                try:
                    q.put(obj, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            pool = ThreadPoolExecutor(self.num_workers, thread_name_prefix="ThreadedLoader")
            try:
                # (sample, items after it in its batch, the batch's replicated flag)
                samples = ((s, len(items) - 1 - i, replicated)
                           for items, replicated in self._batches()
                           for i, s in enumerate(items))
                pending: deque = deque()
                buf = []
                while True:
                    while len(pending) < self.num_workers + self.batch_size:
                        nxt = next(samples, None)
                        if nxt is None:
                            break
                        pending.append((pool.submit(self.dataset.__getitem__, nxt[0]), *nxt[1:]))
                    if not pending:
                        break
                    future, left, replicated = pending.popleft()
                    buf.append(future.result())
                    if left == 0:
                        if not put(self._wrap(_collate(buf), replicated)):
                            return
                        buf = []
            except BaseException as e:  # raised again in the consumer, whatever its kind
                put(e)
            finally:
                pool.shutdown(wait=True, cancel_futures=True)
                put(_END)

        thread = threading.Thread(target=produce, daemon=True, name="ThreadedLoader")
        thread.start()
        try:
            while True:
                obj = q.get()
                if obj is _END:
                    break
                if isinstance(obj, BaseException):
                    raise obj
                yield obj
        finally:
            stop.set()
            thread.join()


_collate = BatchLoader._collate
