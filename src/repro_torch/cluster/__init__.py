"""Cluster tier: warm-aware routing across a fleet of edge servers.

Layered strictly above ``repro_torch.serving`` — a :class:`EdgeCluster`
composes N built :class:`~repro_torch.serving.api.EdgeServer` instances under
one global virtual clock, routes each arrival through a pluggable
:class:`~repro_torch.cluster.routers.Router`, and moves tenants between
servers with transactional hand-offs when a flash crowd overloads one
box.  See ``cluster.py`` for the event loop, ``routers.py`` for the
routing registry, ``config.py`` for the declarative config tree.
"""
from repro_torch.cluster.cluster import EdgeCluster
from repro_torch.cluster.config import ClusterConfig, RouterSpec
from repro_torch.cluster.routers import (Router, ServerView, available_routers,
                                   register_router, resolve_router)

__all__ = ["ClusterConfig", "EdgeCluster", "Router", "RouterSpec",
           "ServerView", "available_routers", "register_router",
           "resolve_router"]
