"""Indexed event scheduling: the primitives behind ``scheduler="indexed"``.

The serving engine's virtual clock only ever needs *when does the next
thing happen*.  The linear-scan engine answers that by rescanning O(n)
collections every idle step — ``min(ld.ready_ms for ld in inflight)``
over loader records, a fresh ``predict_next_time()`` per tenant (which
re-materializes the tenant's full arrival history as a numpy array), and
so on.  The indexed engine answers it from incremental structures:

* **Load readiness** — a lazy-deletion min-heap (:class:`MonotoneQueue`)
  keyed by ``ready_ms``.  Loaders push an entry whenever a record's
  readiness is (re)established; entries whose payload no longer matches
  the live record are discarded at pop time instead of being searched
  for and removed.
* **Prediction triggers** — a per-tenant memo of ``predict_next_time()``
  keyed on the predictor's observable state (history length, fit count,
  last arrival), so the O(history) forward pass runs once per state
  change instead of once per maintenance pass (see
  ``EdgeServer._predict_time``).
* **Fault schedule** — already an indexed cursor
  (``ElasticController.next_event_ms`` reads ``events[self._next]``);
  the unified wake computation consumes it as-is.
* **Arrivals / step boundaries** — the trace cursor and the continuous
  batcher's step clock, both already incremental.

Tie-break contract
------------------
The engine consumes these sources by **value only**: the wake time is
``min()`` over the candidate timestamps, and the engine then re-derives
*what* to do from current state exactly as the linear path does.  Two
sources proposing the same timestamp therefore cannot reorder any
action, which is what makes the heap refactor bit-exact — it must (and
does) reproduce the same float the linear scan would have computed, and
nothing else about scan order can leak into behavior.  This is asserted
end-to-end by ``tests/test_engine_equivalence.py``.
"""
from __future__ import annotations

import heapq
import math
from typing import Any, Callable, List, Tuple

__all__ = ["MonotoneQueue"]


class MonotoneQueue:
    """Lazy-deletion min-heap of ``(time_ms, payload)`` events.

    ``push`` is O(log n); ``peek(valid)`` discards stale heads (entries
    whose ``valid(time_ms, payload)`` predicate fails) and returns the
    earliest live timestamp, or ``inf`` when none remain.  Stale entries
    arise when a record is committed, cancelled, or re-timed in place:
    rather than deleting from the middle of the heap, the producer
    pushes a fresh entry and the old one is dropped here on first
    contact.  Insertion order breaks timestamp ties (FIFO), though the
    engine consumes timestamps by value only — see the module docstring.
    """

    __slots__ = ("_heap", "_seq")

    def __init__(self) -> None:
        self._heap: List[Tuple[float, int, Any]] = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, time_ms: float, payload: Any = None) -> None:
        heapq.heappush(self._heap, (time_ms, self._seq, payload))
        self._seq += 1

    def peek(self, valid: Callable[[float, Any], bool]) -> float:
        """Earliest timestamp whose payload is still live, else inf."""
        heap = self._heap
        while heap:
            t, _, payload = heap[0]
            if valid(t, payload):
                return t
            heapq.heappop(heap)
        return math.inf

    def clear(self) -> None:
        self._heap.clear()
