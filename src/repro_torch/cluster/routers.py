"""Pluggable cluster routing: the ``Router`` protocol and its registry.

A router answers one question per arriving request: *which server?*
It answers from :class:`ServerView` snapshots — the typed, external
gossip surface a real fleet's router would receive from each server's
stats endpoint (queue depths, served/warm counts, which tenants are
resident or staging at what variant accuracy).  Routers never touch a
server's ``MemoryState``, ledger, or loader directly: if the real
network couldn't see it, the router can't either.

Same registry idiom as ``repro_torch.core.policies``: decorate with
``@register_router(name)``, resolve declaratively from a
:class:`~repro_torch.cluster.config.RouterSpec`, enumerate with
:func:`available_routers`.  All built-ins are deterministic — ties
break toward the lowest server index, so two identical runs route
identically.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Callable, ClassVar, Dict, Mapping, Optional,
                    Protocol, Sequence, Tuple, runtime_checkable)

from repro_torch.cluster.config import RouterSpec

__all__ = ["Router", "ServerView", "available_routers",
           "register_router", "resolve_router"]


@dataclass(frozen=True)
class ServerView:
    """One server's externally visible state at a routing instant.

    Everything here is derivable from the server's typed stats/ledger
    surface: ``resident``/``staging`` map tenant name → the accuracy of
    the variant it holds (or is transferring) — the same per-variant
    accuracy the zoos publish; ``queued`` is per-tenant queue depth;
    ``served``/``warm`` are cumulative admission counts.
    """

    index: int
    pending: int                      # total queued requests
    served: int                       # results so far
    warm: int                         # warm admissions so far
    queued: Mapping[str, int] = field(default_factory=dict)
    resident: Mapping[str, float] = field(default_factory=dict)
    staging: Mapping[str, float] = field(default_factory=dict)

    @property
    def warm_ratio(self) -> float:
        return self.warm / self.served if self.served else 0.0


@runtime_checkable
class Router(Protocol):
    """Route ``app``'s request to one of ``views`` (non-empty, ordered
    by server index).  Must return a valid ``views[i].index``."""

    name: ClassVar[str]

    def route(self, app: str, views: Sequence[ServerView],
              now_ms: float) -> int: ...


_ROUTERS: Dict[str, Callable[[Optional[RouterSpec]], "Router"]] = {}


def register_router(name: str) -> Callable:
    """Register a router factory (usually the class itself; called with
    the :class:`RouterSpec` or ``None``) under ``name``."""
    def deco(factory):
        if isinstance(factory, type):
            factory.name = name
        _ROUTERS[name] = factory
        return factory
    return deco


def available_routers() -> Tuple[str, ...]:
    """The registered router names, sorted — what a
    :class:`~repro_torch.cluster.config.RouterSpec` may name.

    >>> available_routers()
    ('least-loaded', 'round-robin', 'warm-aware')
    """
    return tuple(sorted(_ROUTERS))


def resolve_router(spec: "RouterSpec | str") -> Router:
    """Resolve a :class:`RouterSpec` (or bare name) to a live router
    instance through the registry; unknown names raise ``KeyError``
    listing the registered set.

    >>> resolve_router("round-robin").name
    'round-robin'
    """
    if isinstance(spec, str):
        spec = RouterSpec(name=spec)
    if spec.name not in _ROUTERS:
        raise KeyError(
            f"unknown router {spec.name!r}; registered routers: "
            f"{', '.join(available_routers())}")
    return _ROUTERS[spec.name](spec)


# ---------------------------------------------------------------------------
# Built-ins
# ---------------------------------------------------------------------------
@register_router("round-robin")
class RoundRobin:
    """State-blind rotation — the baseline every placement-aware router
    must beat.  Spreads load perfectly and residency terribly: each
    tenant's requests land on every server in turn, so every server
    ends up churning every zoo."""

    def __init__(self, spec: Optional[RouterSpec] = None):
        self._next = 0

    def route(self, app: str, views: Sequence[ServerView],
              now_ms: float) -> int:
        i = views[self._next % len(views)].index
        self._next += 1
        return i


@register_router("least-loaded")
class LeastLoaded:
    """Shortest total queue wins (ties to the lowest index): the classic
    load balancer — placement-blind, so it trades residency for queue
    evenness exactly like round-robin under symmetric load."""

    def __init__(self, spec: Optional[RouterSpec] = None):
        pass

    def route(self, app: str, views: Sequence[ServerView],
              now_ms: float) -> int:
        return min(views, key=lambda v: (v.pending, v.index)).index


@register_router("warm-aware")
class WarmAware:
    """Route to the server already holding the tenant's weights — the
    cluster-scale analogue of the paper's warm-start objective.

    Score per server: the accuracy of the tenant's resident variant
    (staging counts half — the transfer may not commit before the
    request admits), minus ``spill_penalty`` per queued request.  The
    penalty is what makes a flash crowd *spill*: once the home server's
    queue is deep enough, a cold-but-idle neighbor outscores it, and
    the overflow moves instead of stacking up behind one box.

    Score ties (typically: the tenant is cold everywhere) break toward
    the server hosting the fewest tenants, then the lowest index — so
    cold tenants spread out and the fleet partitions residency instead
    of piling every zoo onto server 0.
    """

    def __init__(self, spec: Optional[RouterSpec] = None):
        self.spill_penalty = (spec.spill_penalty if spec is not None
                              else RouterSpec().spill_penalty)

    def score(self, app: str, v: ServerView) -> float:
        warmth = v.resident.get(app, 0.0)
        if warmth <= 0.0:
            warmth = 0.5 * v.staging.get(app, 0.0)
        return warmth - self.spill_penalty * v.pending

    def route(self, app: str, views: Sequence[ServerView],
              now_ms: float) -> int:
        def crowding(v: ServerView) -> int:
            return len(v.resident) + len(v.staging)
        return max(views, key=lambda v: (self.score(app, v),
                                         -crowding(v), -v.index)).index
