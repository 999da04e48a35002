"""EdgeCluster: a fleet of EdgeServers under one global clock + router.

The cluster tier is layered strictly above :class:`EdgeServer` — it
composes built servers, it never reaches into engine internals.  Three
pieces:

* **The global event loop** (:meth:`EdgeCluster.run_trace`): arrivals
  are routed one at a time at their trace timestamps; before each
  routing decision every server's loop is advanced up to (exclusive of)
  that instant through the engine's ``cluster_advance`` protocol, so
  the router always sees the fleet as it stands *at* the arrival — and
  two identical runs see identical fleets, making the whole cluster
  run bit-deterministic (identical per-server audit trails).

* **Routing** over :class:`~repro_torch.cluster.routers.ServerView` snapshots
  — the typed external surface; see ``routers.py``.

* **Cross-server tenant hand-off** (:meth:`_handoff`): the scale-out of
  ``MigrateShard``.  When a flash crowd piles one tenant's queue up on
  its routed server while a strictly lighter server exists, the tenant
  moves home as a transactional pair of residency plans — a staged
  ``Load`` on the receiver (simulate-validated *before* anything
  mutates, staged through the receiver's loader exactly like a demand
  load), then an ``Unload`` drain on the donor and the queued requests
  re-queued to the new home.  Both sides ride the residency-plan
  IR through the existing manager/loader mutation paths — no second
  mutation path.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

from repro_torch.core import actions as A
from repro_torch.cluster.config import ClusterConfig
from repro_torch.cluster.routers import Router, ServerView, resolve_router
from repro_torch.serving.api import EdgeServer
from repro_torch.serving.batcher import Request
from repro_torch.serving.stats import AuditEvent, ServingStats

__all__ = ["EdgeCluster"]


class EdgeCluster:
    """N built servers + a router, driven by one global virtual clock."""

    def __init__(self, config: ClusterConfig,
                 servers: Sequence[EdgeServer], router: Router):
        self.config = config
        self.servers = tuple(servers)
        self.router = router
        self.routed = 0
        self.spilled = 0     # routed cold while another server was warm
        self.handoffs = 0

    @classmethod
    def build(cls, config: ClusterConfig) -> "EdgeCluster":
        servers = tuple(EdgeServer.build(sc) for sc in config.servers)
        return cls(config, servers, resolve_router(config.router))

    @property
    def n_servers(self) -> int:
        return len(self.servers)

    def close(self) -> None:
        for srv in self.servers:
            srv.close()

    # -- the external gossip surface ------------------------------------
    def view(self, i: int) -> ServerView:
        """Server ``i``'s :class:`ServerView` snapshot — only state a
        real fleet's stats endpoint would publish."""
        srv = self.servers[i]
        eng = srv.engine
        st = srv.manager.state
        resident = {a: t.loaded.accuracy for a, t in st.tenants.items()
                    if t.loaded is not None}
        staging = {a: ld.variant.accuracy
                   for a, ld in srv.loader.inflight.items()}
        queued = {a: eng.batcher.queued(a)
                  for a in eng.batcher.queued_apps()}
        return ServerView(
            index=i, pending=eng.batcher.pending(),
            served=len(eng.results),
            warm=eng.warm_served,
            queued=queued, resident=resident, staging=staging)

    def views(self) -> Tuple[ServerView, ...]:
        return tuple(self.view(i) for i in range(self.n_servers))

    # -- the global event loop ------------------------------------------
    def run_trace(self, requests: Sequence[Request]) -> ServingStats:
        """Route-and-serve the trace across the fleet; returns the
        aggregated :class:`ServingStats` (``cluster`` block included)."""
        pending = sorted(requests, key=lambda r: r.arrival_ms)
        # Cluster-global request ids: Batcher.assign is idempotent for
        # explicit rids, so a handed-off request keeps its id on the
        # receiving server and per-request results stay unique fleetwide.
        for i, r in enumerate(pending):
            if r.rid is None:
                r.rid = i
        engines = [srv.engine for srv in self.servers]
        # Next-internal-event cache: only servers whose next event
        # precedes the routing horizon advance.  ``cluster_advance`` is
        # a strict no-op when nothing precedes the horizon (its loop
        # breaks before any state moves), so the skip is bit-exact;
        # anything that mutates a server through routing — a submit, a
        # hand-off's donor/receiver — invalidates that entry.
        nxt = [-math.inf] * len(engines)
        for r in pending:
            t = r.arrival_ms
            for i, eng in enumerate(engines):
                if nxt[i] < t:
                    nxt[i] = eng.cluster_advance(t)
            views = self.views()
            routed = self.router.route(r.app, views, t)
            target = self._maybe_handoff(r.app, routed, views, t)
            if target != routed:  # hand-off moved state on both ends
                nxt[routed] = nxt[target] = -math.inf
            self.routed += 1
            v = self.view(target)  # fresh: a hand-off just moved state
            if (r.app not in v.resident and r.app not in v.staging
                    and any(r.app in w.resident
                            for w in views if w.index != target)):
                self.spilled += 1
            engines[target].cluster_submit(r)
            nxt[target] = -math.inf
        # Drain: keep advancing on the shared clock until every server
        # reports no further internal events.
        while True:
            nxt = [eng.cluster_advance(math.inf) for eng in engines]
            if all(x == math.inf for x in nxt):
                break
        for eng in engines:
            eng.cluster_finish()
        return self.stats()

    # -- cross-server tenant hand-off -----------------------------------
    def _maybe_handoff(self, app: str, target: int,
                       views: Sequence[ServerView], now: float) -> int:
        """Flash-crowd overload check at routing time: if ``app``'s
        queue on ``target`` has reached the configured depth *because
        the server is busy with other tenants' work*, and a server at
        most half that busy exists, hand the tenant off and route this
        request to its new home.  A tenant whose own crowd is the whole
        overload stays put — its queue would move with it, so handing
        it off is churn, not relief (the router's spill penalty is what
        sheds that overflow)."""
        hq = self.config.router.handoff_queue
        if not hq:
            return target
        v = views[target]
        if v.queued.get(app, 0) < hq or app not in v.resident:
            return target
        other_work = v.pending - v.queued.get(app, 0)
        if other_work <= 0:
            return target
        others = sorted((w for w in views if w.index != target),
                        key=lambda w: (w.pending, w.index))
        if not others or others[0].pending * 2 > other_work:
            return target  # nobody is meaningfully lighter
        recv = others[0].index
        if self._handoff(app, target, recv, now):
            return recv
        return target

    def _handoff(self, app: str, src: int, dst: int,
                 now: float) -> bool:
        """Move tenant ``app`` from server ``src`` to ``dst`` as one
        transactional pair of residency plans.  Validates the receiver
        side with ``simulate`` before anything mutates; returns False
        (fleet untouched) when the receiver cannot host the tenant."""
        donor, recv = self.servers[src], self.servers[dst]
        dstate = donor.manager.state
        variant = dstate.tenants[app].loaded
        if variant is None or app in recv.loader.inflight:
            return False
        rstate = recv.manager.state
        rloaded = rstate.tenants[app].loaded
        staged_mb = 0.0
        if rloaded is None or rloaded.size_mb < variant.size_mb:
            # Receiver staged load: the donor's variant, or the largest
            # smaller one the receiver can fund without destabilizing
            # its own residents.  demand=True — the moved requests
            # waited out a real transfer, their admissions are honestly
            # demand-cold, not prefetch-warm.
            plan, v = None, variant
            while v is not None:
                if rloaded is None or v.size_mb > rloaded.size_mb:
                    cand = A.ResidencyPlan(
                        (A.staged_load_action(rstate, app, v),))
                    if rstate.simulate(cand) is None:
                        plan = cand
                        break
                v = rstate.tenants[app].zoo.next_smaller(v)
            if plan is None:
                return False
            if recv.loader.execute(plan, now, demand=True) is None:
                return False  # stale between simulate and execute
            staged_mb = v.size_mb
            recv.engine._event(now, "handoff", app, staged_mb)
        # Donor drain: unwind any in-flight load the donor still has for
        # the tenant through the normal cancel lifecycle, then one
        # Unload through the manager's transactional mirror path.
        if app in donor.loader.inflight:
            donor.loader.cancel(app, now)
        if donor.loader.peek_use(app) is not None:
            donor.loader.take_use(app, False)
        if dstate.tenants[app].loaded is not None:
            donor.manager._apply_actions((A.Unload(app),), now=now)
        donor.engine._event(now, "handoff", app, -variant.size_mb)
        # Re-queue the stranded requests to the new home.  Direct to the
        # receiving batcher (rids survive — assign is idempotent); the
        # receiver's predictor never saw these arrivals, exactly like a
        # real fleet where history doesn't travel with a hand-off.
        moved = donor.engine.batcher.queues.pop(app, [])
        for req in moved:
            recv.engine.batcher.submit(req)
            recv.engine._event(now, "submit", app, 0.0)
        # The receiver's local clock catches up to the hand-off instant:
        # the moved requests were not on this server before ``now``.
        recv.engine._cluster_now = max(recv.engine._cluster_now, now)
        self.handoffs += 1
        return True

    # -- aggregation ----------------------------------------------------
    def audit_trails(self) -> Tuple[Tuple[AuditEvent, ...], ...]:
        """Per-server normalized audit trails (the bit-determinism
        surface: two identical runs produce equal tuples)."""
        return tuple(tuple(srv.engine.audit_trail)
                     for srv in self.servers)

    def check_event_invariant(self) -> None:
        for srv in self.servers:
            srv.engine.check_event_invariant()

    def stats(self) -> ServingStats:
        """Fleet-level :class:`ServingStats`: core counters summed over
        servers, warm/latency aggregates over the merged results, plus
        the ``cluster`` block (per-server warm ratios, routed/spilled/
        handed-off counts)."""
        results = [r for srv in self.servers for r in srv.engine.results]
        tens = [t for srv in self.servers
                for t in srv.manager.state.tenants.values()]
        total_req = sum(t.requests for t in tens)
        kw: dict = {
            "requests": len(results),
            "kv_downgrades": sum(s.engine.kv_downgrades
                                 for s in self.servers),
            "kv_rejections": sum(s.engine.kv_rejections
                                 for s in self.servers),
            "weight_failures": sum(s.engine.weight_failures
                                   for s in self.servers),
            "kv_overrelease_mb": sum(s.manager.state.kv_overrelease_mb
                                     for s in self.servers),
            "prediction_hit_rate": (
                sum(t.requests - t.unexpected for t in tens) / total_req
                if total_req else 0.0),
            "per_tenant": {},
            "warm_ratio": 0.0,
            "prefetch_hits": sum(s.loader.prefetch_hits
                                 for s in self.servers),
            "prefetch_wasted": sum(s.loader.prefetch_wasted
                                   for s in self.servers),
            "prefetch_shrunk": sum(s.loader.prefetch_shrunk
                                   for s in self.servers),
            "demand_loads": sum(s.loader.demand_loads
                                for s in self.servers),
            "loads_committed": sum(s.loader.loads_committed
                                   for s in self.servers),
            "load_overlap_ms": sum(s.loader.load_overlap_ms
                                   for s in self.servers),
            "fits_scheduled": sum(s.loader.fits_scheduled
                                  for s in self.servers),
        }
        per_server_requests = tuple(len(s.engine.results)
                                    for s in self.servers)
        per_server_warm = tuple(
            (sum(1 for r in s.engine.results if r.warm)
             / len(s.engine.results)) if s.engine.results else 0.0
            for s in self.servers)
        kw["cluster"] = {
            "servers": self.n_servers,
            "router": getattr(self.router, "name", "?"),
            "routed": self.routed,
            "spilled": self.spilled,
            "handoffs": self.handoffs,
            "per_server_requests": per_server_requests,
            "per_server_warm_ratio": per_server_warm,
        }
        if not results:
            return ServingStats(**kw)
        kw["warm_ratio"] = sum(r.warm for r in results) / len(results)
        span_ms = (max(r.done_ms for r in results)
                   - min(r.arrival_ms for r in results))
        kw["requests_per_sec"] = (len(results) / (span_ms / 1e3)
                                  if span_ms > 0 else 0.0)
        for app in sorted({r.app for r in results}):
            rs = [r for r in results if r.app == app]
            kw["per_tenant"][app] = {
                "requests": len(rs),
                "warm_ratio": sum(r.warm for r in rs) / len(rs),
                "fail_ratio": sum(r.failed for r in rs) / len(rs),
            }
        return ServingStats(**kw)
