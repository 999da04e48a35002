"""Typed serving telemetry: event kinds, audit records, stats schema.

Six PRs of serving work accreted telemetry as loose strings and dict
keys — ``ev.kind == "migrate"``, ``stats()["warm_ratio"]``, new keys
appearing whenever a subsystem (loader, mesh, paged KV, elastic) was
attached.  This module is the one place that schema lives:

* :class:`EventKind` — every audit/engine event kind as a ``str``-enum,
  so ``ev.kind == "admit"`` keeps working while typos become errors;
* :class:`AuditEvent` — the frozen ``(kind, t, app, detail)`` record
  every stringly callback normalizes into;
* :class:`ServingStats` — the frozen result of ``engine.run_trace`` /
  ``engine.stats()`` / ``server.stats()``.  Core fields are always
  populated; subsystem blocks (loader, mesh, paged KV, elastic,
  server-level gauges) are ``None`` until that subsystem is attached,
  and :meth:`ServingStats.to_dict` drops the ``None`` fields so the
  benchmark CSV path sees exactly the keys the old dict had.

This is deliberately a leaf module (stdlib imports only): engine,
server, and api all import it without cycles.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, fields
from typing import Any, Dict, Optional, Tuple

__all__ = ["AuditEvent", "EventKind", "ServingStats"]


class EventKind(str, enum.Enum):
    """Every audit/engine event kind.  ``str``-valued so existing
    comparisons (``ev.kind == "admit"``, ``ev.kind in (...)``) hold."""

    # Request lifecycle (engine).
    SUBMIT = "submit"
    ADMIT = "admit"
    REJECT = "reject"
    RETIRE = "retire"
    FREE_KV = "free_kv"
    PREEMPT = "preempt"
    # A tenant's CUDA-graph pool charged or trued up around a capture.
    POOL = "pool"
    # Loader pipeline.
    PREFETCH = "prefetch"
    DEMAND = "demand"
    LOAD = "load"
    CANCEL = "cancel"
    SHRINK = "shrink"
    # Memory-state audit.
    MIGRATE = "migrate"
    KV_OVERRELEASE = "kv_overrelease"
    # Elastic mesh (chip loss & recovery).
    CHIP_DOWN = "chip_down"
    CHIP_UP = "chip_up"
    DRAIN = "drain"
    # Cluster tier (cross-server tenant movement).
    HANDOFF = "handoff"

    def __str__(self) -> str:  # keep f-string formatting as the raw kind
        return self.value


@dataclass(frozen=True)
class AuditEvent:
    """One normalized audit record.

    ``detail`` is the event's MB delta (weights moved, KV charged or
    freed, claim cancelled, ...); sign follows the ledger (frees and
    cancels are negative).  ``app`` is the tenant, or a synthetic name
    like ``chip3`` for mesh-level events.
    """

    kind: EventKind
    t: float
    app: str
    detail: float

    def __str__(self) -> str:
        return (f"[{self.t:8.0f}ms] {self.kind.value:8s} {self.app:16s} "
                f"{self.detail:+8.3f}MB")


@dataclass(frozen=True)
class ServingStats:
    """The typed result of a serving run.

    Core fields are always set.  Each ``Optional`` block is ``None``
    until the matching subsystem is attached (then every field in the
    block is populated), and :meth:`to_dict` drops ``None`` fields —
    the dict therefore has exactly the keys the subsystems earned.
    """

    # --- core (always populated) -----------------------------------
    requests: int = 0
    warm_ratio: float = 0.0           # admitted on already-resident weights
    kv_downgrades: int = 0
    kv_rejections: int = 0
    weight_failures: int = 0
    kv_overrelease_mb: float = 0.0    # release drift; 0.0 when healthy
    prediction_hit_rate: float = 0.0
    per_tenant: Dict[str, Dict[str, float]] = None  # type: ignore[assignment]

    # --- throughput (needs >= 1 completed request) ------------------
    requests_per_sec: Optional[float] = None

    # --- background loader pipeline ---------------------------------
    prefetch_hits: Optional[int] = None
    prefetch_wasted: Optional[int] = None
    prefetch_shrunk: Optional[int] = None
    demand_loads: Optional[int] = None
    loads_committed: Optional[int] = None
    load_overlap_ms: Optional[float] = None
    fits_scheduled: Optional[int] = None
    shards_landed: Optional[int] = None   # sharded loader only
    # Quantize-on-the-wire staging: MB actually shipped host→chip (the
    # compressed payload under LoaderSpec(compress="int8")) and variant
    # switches that shipped zero bytes (in-place requantization).
    wire_mb_staged: Optional[float] = None
    inplace_downgrades: Optional[int] = None

    # --- device mesh -------------------------------------------------
    shards_migrated: Optional[int] = None
    device_used_mb: Optional[Tuple[float, ...]] = None
    device_budget_mb: Optional[Tuple[float, ...]] = None

    # --- paged KV (continuous batching) ------------------------------
    kv_page_mb: Optional[float] = None
    kv_pages_total: Optional[int] = None
    kv_pages_used: Optional[int] = None
    kv_preemptions: Optional[int] = None

    # --- elastic mesh (fault schedule configured) --------------------
    chips_lost: Optional[int] = None
    chips_recovered: Optional[int] = None
    drain_migrations: Optional[int] = None
    drain_downgrades: Optional[int] = None
    # Variants the drain degraded that chip_up restored.
    repromotions: Optional[int] = None

    # --- cluster tier (EdgeCluster.stats() only) ---------------------
    # Fleet-level block: router name, routed/spilled/handed-off counts,
    # and per-server request/warm-ratio tuples.  None on single-server
    # stats, so the dict keys only exist when a cluster produced them.
    cluster: Optional[Dict[str, Any]] = None

    # --- server-level gauges (EdgeServer.stats() only) ---------------
    redispatched: Optional[int] = None
    resident_mb: Optional[float] = None
    weights_mb: Optional[float] = None
    kv_mb: Optional[float] = None
    fail_ratio: Optional[float] = None
    mean_latency_s: Optional[float] = None
    predictor_fits: Optional[int] = None
    # Residual-adapted prediction window per tenant (adaptive-delta
    # servers only).
    delta_ms: Optional[Dict[str, float]] = None

    def __post_init__(self) -> None:
        if self.per_tenant is None:
            object.__setattr__(self, "per_tenant", {})

    def to_dict(self) -> Dict[str, Any]:
        """Flatten to the historical stats dict, dropping unset blocks."""
        out: Dict[str, Any] = {}
        for f in fields(self):
            val = getattr(self, f.name)
            if val is None:
                continue
            out[f.name] = val
        return out
