"""FCFS request scheduler with admission control and slot bookkeeping.

The scheduler is pure host logic — it owns *which* request occupies *which*
batch slot, never touching device state (that's ``serving/slots.py``).  Two
invariants matter:

- **FCFS, no starvation**: requests are admitted in exactly the order they
  were submitted; a full batch only delays, never reorders, the queue
  (``tests/test_serving.py::test_scheduler_fcfs_no_starvation``).
- **Admission cap**: the waiting queue is bounded (``max_queue``); a submit
  against a full queue is *rejected* (counted, returned False) rather than
  buffered unboundedly — backpressure belongs at the edge, not in RAM.
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import List, Optional, Tuple

from .workload import Request


class Scheduler:
    def __init__(self, n_slots: int, max_queue: int = 64):
        self.n_slots = n_slots
        self.max_queue = max_queue
        self._queue: deque = deque()
        self._free: List[int] = list(range(n_slots))
        heapq.heapify(self._free)
        self.n_rejected = 0
        self.admitted_order: List[int] = []  # rids, in admission order

    # -- queue edge ----------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Enqueue a request; False (and counted) when the queue is full."""
        if len(self._queue) >= self.max_queue:
            self.n_rejected += 1
            return False
        self._queue.append(req)
        return True

    @property
    def n_waiting(self) -> int:
        return len(self._queue)

    @property
    def n_free_slots(self) -> int:
        return len(self._free)

    # -- slot assignment -----------------------------------------------------
    def admit(self) -> Optional[Tuple[Request, int]]:
        """Pop the oldest waiting request and assign it the lowest free slot;
        None when nothing is waiting or no slot is free."""
        if not self._queue or not self._free:
            return None
        req = self._queue.popleft()
        slot = heapq.heappop(self._free)
        self.admitted_order.append(req.rid)
        return req, slot

    def release(self, slot: int) -> None:
        """Return a retired slot to the free pool."""
        heapq.heappush(self._free, slot)
