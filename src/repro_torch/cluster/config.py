"""Declarative cluster config: N server trees + one router spec.

Mirrors the ``repro_torch.serving.api`` pattern — frozen dataclasses, a
``to_dict``/``from_dict`` round trip, validation at declaration time —
so a whole fleet is one JSON-able document::

    cfg = ClusterConfig(
        servers=(base, base, base),       # three identical edge boxes
        router=RouterSpec(name="warm-aware", handoff_queue=6))
    cluster = EdgeCluster.build(cfg)

The cluster tier is built on the *deterministic* serving stack: every
server must use the sim executor (one shared virtual clock; wall-clock
executors cannot interleave reproducibly), carry a background loader
(routing decisions read staging state), and use batch-scalar batching
(the continuous engine owns its own loop).  Tenant name sets must match
across servers — the router's unit of placement is the tenant, and a
request must be servable anywhere it can be routed.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Sequence, Tuple

from repro_torch.serving.api import ServingConfig

__all__ = ["ClusterConfig", "RouterSpec"]


@dataclass(frozen=True)
class RouterSpec:
    """Which routing policy, and its knobs.

    ``name`` resolves through the ``@register_router`` registry
    (``round-robin`` / ``least-loaded`` / ``warm-aware`` built in).
    ``spill_penalty`` is the warm-aware router's queue-depth weight:
    how much resident-variant accuracy a server must offer to justify
    each already-queued request in front of the new one.  ``handoff_queue``
    arms cross-server tenant hand-off: when a tenant's queue on its
    routed server reaches this depth while a strictly lighter server
    exists, the cluster drains the tenant to the lighter server as one
    transactional plan pair.  ``0`` (default) disables hand-off.
    """

    name: str = "warm-aware"
    spill_penalty: float = 5.0
    handoff_queue: int = 0

    def __post_init__(self) -> None:
        # Lazy import: routers.py imports this module for the spec type.
        from repro_torch.cluster.routers import available_routers
        if self.name not in available_routers():
            raise ValueError(
                f"unknown router {self.name!r}; registered routers: "
                f"{', '.join(available_routers())}")
        if self.spill_penalty < 0.0:
            raise ValueError(
                f"spill_penalty must be >= 0, got {self.spill_penalty}")
        if self.handoff_queue < 0:
            raise ValueError(
                f"handoff_queue must be >= 0, got {self.handoff_queue}")


@dataclass(frozen=True)
class ClusterConfig:
    """N :class:`~repro_torch.serving.api.ServingConfig` trees + a router."""

    servers: Tuple[ServingConfig, ...]
    router: RouterSpec = field(default_factory=RouterSpec)

    def __post_init__(self) -> None:
        object.__setattr__(self, "servers", tuple(self.servers))
        if not self.servers:
            raise ValueError("ClusterConfig needs at least one server")
        for i, sc in enumerate(self.servers):
            if sc.executor != "sim":
                raise ValueError(
                    f"server {i}: cluster serving requires "
                    f"executor='sim' (one shared virtual clock)")
            if not sc.loader.prefetch:
                raise ValueError(
                    f"server {i}: cluster serving requires "
                    f"LoaderSpec(prefetch=True) — routing reads "
                    f"staging state")
            if sc.batching.continuous:
                raise ValueError(
                    f"server {i}: continuous batching drives its own "
                    f"loop and cannot share the cluster clock")
        names = {tuple(sorted(t.name for t in sc.tenants))
                 for sc in self.servers}
        if len(names) != 1:
            raise ValueError(
                "every server must register the same tenant set; got "
                f"{sorted(names)}")

    @property
    def tenant_names(self) -> Tuple[str, ...]:
        return tuple(sorted(t.name for t in self.servers[0].tenants))

    @classmethod
    def uniform(cls, n: int, base: ServingConfig,
                router: "RouterSpec | None" = None) -> "ClusterConfig":
        """N identical servers from one base config."""
        if n < 1:
            raise ValueError(f"need at least one server, got {n}")
        return cls(servers=(base,) * n,
                   router=router if router is not None else RouterSpec())

    # -- serialization round trip ---------------------------------------
    def to_dict(self) -> dict:
        return {"servers": [s.to_dict() for s in self.servers],
                "router": dataclasses.asdict(self.router)}

    @classmethod
    def from_dict(cls, d: dict) -> "ClusterConfig":
        servers: Sequence = d["servers"]
        router = d.get("router", RouterSpec())
        return cls(
            servers=tuple(s if isinstance(s, ServingConfig)
                          else ServingConfig.from_dict(s)
                          for s in servers),
            router=(router if isinstance(router, RouterSpec)
                    else RouterSpec(**router)))
