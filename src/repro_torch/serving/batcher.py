"""Request batching for the multi-tenant server.

Requests queue per tenant; a batching window groups same-tenant requests
(padding prompts to a common length) so one prefill+decode serves many
requests — the standard serving amortization, orthogonal to the paper's
residency management but required for a real deployment.
"""
from __future__ import annotations

import itertools
from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Deque, Dict, Iterable, KeysView, List, Optional

import numpy as np


@dataclass
class Request:
    app: str
    prompt: np.ndarray  # (S,) int32
    max_new: int = 8
    arrival_ms: float = 0.0
    # Assigned by the Batcher at submit (a module-global counter here
    # leaked ids across server builds in one process, making the FIFO
    # rid tie-break in next_batch non-reproducible between builds).
    rid: Optional[int] = None


@dataclass
class Batch:
    app: str
    requests: List[Request]
    prompts: np.ndarray  # (B, S_max) right-aligned padded
    max_new: int


class Batcher:
    def __init__(self, max_batch: int = 8, pad_id: int = 0):
        # Deques: head pops (next_batch, continuous join) and head
        # re-inserts (preemption requeue) are O(1) instead of shifting
        # the whole tenant queue.
        self.queues: Dict[str, Deque[Request]] = defaultdict(deque)
        self.max_batch = max_batch
        self.pad_id = pad_id
        # Instance-scoped so two server builds in one process each start
        # at rid 0: identical traces get identical tie-break orders.
        self._ids = itertools.count()

    def assign(self, req: Request) -> Request:
        """Give a request its id (idempotent: explicit rids survive)."""
        if req.rid is None:
            req.rid = next(self._ids)
        return req

    def submit(self, req: Request) -> None:
        self.queues[req.app].append(self.assign(req))

    def pending(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def queued(self, app: str) -> int:
        """Depth of one tenant's queue."""
        return len(self.queues.get(app, ()))

    def queued_apps(self) -> KeysView[str]:
        """Live view of tenants with queued work, in insertion order.

        A view, not a copy: callers that only iterate (and do not
        mutate the queue table mid-loop) avoid materializing a fresh
        tuple every scheduler step.  Callers that *do* mutate mid-loop
        (e.g. the continuous-batching join, where a preemption requeue
        can insert new keys) must snapshot with ``list(...)`` first.
        """
        return self.queues.keys()

    def head_arrival(self, app: str) -> Optional[float]:
        """Arrival time of the tenant's oldest queued request."""
        q = self.queues.get(app)
        return q[0].arrival_ms if q else None

    def next_batch(self, exclude: Optional[Iterable[str]] = None
                   ) -> Optional[Batch]:
        """Pop the largest same-tenant group (up to max_batch), FIFO
        within the tenant; queue-size ties go to the tenant whose head
        request has waited longest (no starvation under equal load).
        Tenants in ``exclude`` (mid-load: their weights are still
        staging) are skipped so everyone else keeps serving; returns None
        when every queued tenant is excluded."""
        skip = frozenset(exclude) if exclude else frozenset()
        apps = [a for a in self.queues if a not in skip]
        if not apps:
            return None
        app = max(apps,
                  key=lambda a: (len(self.queues[a]),
                                 -self.queues[a][0].arrival_ms,
                                 -self.queues[a][0].rid))
        q = self.queues[app]
        reqs = [q.popleft() for _ in range(min(self.max_batch, len(q)))]
        if not q:
            del self.queues[app]
        S = max(len(r.prompt) for r in reqs)
        prompts = np.full((len(reqs), S), self.pad_id, np.int32)
        for i, r in enumerate(reqs):
            prompts[i, S - len(r.prompt):] = r.prompt  # right-align
        return Batch(app, reqs, prompts, max(r.max_new for r in reqs))
