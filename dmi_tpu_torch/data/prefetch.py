# Copy of dmi_tpu/data/prefetch.py with its dmi_tpu imports rewritten to dmi_tpu_torch, so that
# the port loads no module of the JAX package (tests/test_torch_isolation.py holds the two equal).
"""Background batch prefetcher.

Host-side tokenization/collation runs in a worker thread a fixed number of
steps ahead of the training loop, overlapping with device compute (the
reference's DataLoader(num_workers=0) does everything inline on the hot
path, dmi/data/base.py:286-321).  Because batches are a pure function of
the step index (stateless samplers), prefetching never changes data order.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional


class Prefetcher:
    def __init__(self, fetch: Callable[[int], object], depth: int = 2):
        """fetch(step) -> batch; depth = how many steps ahead to stage."""
        self.fetch = fetch
        self.depth = depth
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._next_to_produce = 0

    def _worker(self, start: int, end: int):
        try:
            for step in range(start, end):
                if self._stop.is_set():
                    return
                self._q.put((step, self.fetch(step)))
        except BaseException as e:  # propagate to the consumer, never hang
            self._q.put((None, e))

    def run(self, start: int, end: int) -> Iterator:
        """Yield (step, batch) for steps [start, end) with lookahead."""
        self._thread = threading.Thread(
            target=self._worker, args=(start, end), daemon=True
        )
        self._thread.start()
        try:
            for _ in range(start, end):
                step, batch = self._q.get()
                if step is None:
                    raise batch  # worker exception
                yield step, batch
        finally:
            self._stop.set()
            # drain so the worker can exit a blocking put
            while not self._q.empty():
                self._q.get_nowait()
