"""`repro_torch.serving.api` — the declarative front door for the serving stack.

One config tree, one entry point::

    from repro_torch.serving.api import EdgeServer, ServingConfig, TenantSpec

    srv = EdgeServer.build(ServingConfig(
        tenants=(TenantSpec("tinyllama-1.1b"), TenantSpec("gemma2-2b")),
        policy="iws-bfe",                    # any registered Policy
        batching=BatchingSpec(max_batch=4),
    ))
    stats = srv.engine.run_trace(trace)

``build`` performs every piece of wiring the benchmarks, examples, and
launcher used to repeat by hand: resolve each tenant's model config,
initialize and quantize its zoo (or attach a sim-time executor), install
the arrival predictor, derive the contended memory budget, resolve the
policy through the registry, and attach the background loader + engine.
The imperative ``EdgeServer(...)`` / ``register`` / ``start`` path stays
public underneath for callers with custom params.

Specs are frozen dataclasses with a ``to_dict``/``from_dict`` round trip
so a serving deployment is one JSON-able document.
"""
from __future__ import annotations

import dataclasses
import zlib
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.manager import LOAD_OVER_INFER
from repro_torch.core.model_zoo import ModelVariant, zoo_from_config
from repro_torch.core.policies import Policy, resolve_policy
from repro_torch.core.predictor import RequestPredictor
from repro_torch.models.config import ModelConfig
from repro_torch.serving.elastic import FaultSpec
from repro_torch.serving.server import EdgeServer
from repro_torch.serving.stats import AuditEvent, EventKind, ServingStats

__all__ = ["EdgeServer", "ServingConfig", "TenantSpec", "PredictorSpec",
           "BatchingSpec", "LoaderSpec", "FaultSpec", "SimTenant",
           "ServingStats", "AuditEvent", "EventKind", "build_server"]


# ---------------------------------------------------------------------------
# The config tree
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TenantSpec:
    """One application: which architecture, which precision variants.

    ``arch`` defaults to ``name`` (the registered config name); ``seed``
    defaults to a stable digest of the name so parameter init is
    reproducible across processes without coordinating seeds.
    ``service_ms`` overrides the sim executor's virtual batch service
    time (default: derived from the loaded variant's load cost via the
    paper's load/infer asymmetry) — the knob that lets a trace build
    real queue depth; ignored by the real executor, whose service time
    is measured.

    >>> TenantSpec("tinyllama-1.1b", precisions=(16, 8)).config_name
    'tinyllama-1.1b'
    """
    name: str
    arch: Optional[str] = None
    precisions: Tuple[int, ...] = (16, 8)
    reduced: bool = True
    seed: Optional[int] = None
    service_ms: Optional[float] = None

    @property
    def config_name(self) -> str:
        return self.arch or self.name

    @property
    def init_seed(self) -> int:
        if self.seed is not None:
            return self.seed
        return zlib.crc32(self.name.encode()) & 0x7FFFFFFF


@dataclass(frozen=True)
class PredictorSpec:
    """Per-tenant RNN arrival-predictor shape and its background-training
    schedule (fits run on the loader's staging worker)."""
    context: int = 8
    hidden: int = 16
    min_fit_samples: int = 24
    refit_interval: int = 16
    fit_steps: int = 150


@dataclass(frozen=True)
class BatchingSpec:
    """``continuous=True`` switches the engine to continuous batching:
    the request (not the batch) is the admission unit — each request
    charges its own page-rounded KV need against a
    :class:`~repro_torch.core.memory_state.KVPagePool`, joins the running
    decode batch per step, and frees its pages the step it retires.
    ``kv_page_mb`` is the page size knob (0 = auto: the largest
    tenant's 8-token decode cache); smaller pages waste less memory per
    request, larger pages keep the page tables shorter.

    >>> BatchingSpec(max_batch=4, window_ms=20.0).continuous
    False
    """
    max_batch: int = 8
    window_ms: float = 0.0
    continuous: bool = False
    kv_page_mb: float = 0.0


@dataclass(frozen=True)
class LoaderSpec:
    """``prefetch=False`` is the reactive baseline: no background loader,
    every weight move synchronous inside the admit path.

    ``sharded=True`` serves from a device mesh: tenant weights shard
    across ``mesh_shape`` (1-D = pure tensor parallel ``("model",)``,
    2-D = ``("data", "model")``) via the real partition rules, the
    loader stages per-shard on per-device streams, and ``MemoryState``
    gains per-chip budget ledgers (``device_budget_mb`` per chip; None
    derives a budget that covers the replication overhead, so tighter
    values deliberately exercise the whole-load-failure path; a tuple
    gives *per-chip* budgets — a deliberately skewed mesh).  Requires
    ``prefetch=True`` — the reactive engine has no staging channel to
    decompose.

    ``migrate=True`` (default) arms cross-device victim migration: a
    load blocked by one chip's budget moves a resident victim's shards
    to chips with room (``MigrateShard`` actions, committed atomically
    with the load) instead of failing into the downgrade path.
    ``migrate=False`` keeps the PR-4 downgrade-only behaviour — the
    benchmark's A/B baseline.

    ``compress="int8"`` stages **compressed bytes** host→chip: every
    load (both loader channels) ships the int8 payload plus per-group
    scales instead of full-width leaves and dequantizes on land, so the
    virtual transfer time shrinks by
    :func:`repro_torch.distributed.compression.wire_compression_ratio` (bf16
    → ~0.56×) while ``inflight_mb`` claims and the ``DeviceLedger``
    still charge the *resident* footprint.  ``None`` (default) stages
    full-width.

    >>> LoaderSpec(sharded=True, mesh_shape=(4,), compress="int8").compress
    'int8'
    """
    prefetch: bool = True
    sharded: bool = False
    mesh_shape: Tuple[int, ...] = (8,)
    device_budget_mb: "Optional[float | Tuple[float, ...]]" = None
    migrate: bool = True
    compress: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "mesh_shape", tuple(self.mesh_shape))
        if isinstance(self.device_budget_mb, (tuple, list)):
            object.__setattr__(self, "device_budget_mb",
                               tuple(float(b)
                                     for b in self.device_budget_mb))
        if self.sharded and not self.prefetch:
            raise ValueError(
                "LoaderSpec(sharded=True) requires prefetch=True")
        if self.sharded and not (1 <= len(self.mesh_shape) <= 2):
            raise ValueError(
                f"mesh_shape must be 1-D or 2-D, got {self.mesh_shape}")
        if self.compress not in (None, "int8"):
            raise ValueError(
                f"unknown wire compression {self.compress!r} "
                "(None or 'int8')")


@dataclass(frozen=True)
class ServingConfig:
    """Everything ``EdgeServer.build`` needs, in one declarative tree.

    ``budget_mb=None`` derives the standard contended budget from the
    registered zoos (every tenant resident at its smallest variant, room
    to upgrade the widest zoo, 5% slack) plus KV headroom —
    ``kv_headroom_mb`` directly, and/or ``kv_headroom_shape=(batch,
    total_len)`` for the largest decode cache the workload will admit.

    ``policy`` resolves through the policy registry (a name like
    ``"iws-bfe"`` or ``"batch-bfe"``, a Policy class, or an instance);
    ``"none"`` is the paper's unmanaged baseline (no procurement
    authority).  ``fallback`` is the last-resort eviction backstop
    (``"desperation"`` or ``"none"``).  ``executor="sim"`` swaps every
    tenant for a deterministic sim-time executor — no device work, virtual
    service times — for tests and capacity modelling.
    """
    tenants: Tuple[TenantSpec, ...]
    budget_mb: Optional[float] = None
    kv_headroom_mb: float = 0.0
    kv_headroom_shape: Optional[Tuple[int, int]] = None
    policy: Union[str, Policy, type] = "iws-bfe"
    fallback: Union[str, None, Any] = "desperation"
    delta_ms: float = 500.0
    # Adapt each tenant's Δ from its measured arrival residuals (EWMA of
    # |t_actual − t_pred|) instead of the fixed delta_ms — closes the
    # predictor-quality loop behind prediction_hit_rate.  Off by default
    # (the paper's fixed window).
    adaptive_delta: bool = False
    history_ms: float = 3000.0
    batching: BatchingSpec = field(default_factory=BatchingSpec)
    loader: LoaderSpec = field(default_factory=LoaderSpec)
    predictor: PredictorSpec = field(default_factory=PredictorSpec)
    executor: str = "real"  # "real" | "sim"
    straggler_deadline_s: float = 30.0
    # Chip-fault schedule (elastic mesh): chip-down/chip-up events on the
    # engine clock, each down firing one transactional drain plan.
    # Requires LoaderSpec(sharded=True) — the drain planner works the
    # per-device ledger.
    fault: Optional[FaultSpec] = None
    # Audit level: "full" (default) records per-event usage/device
    # snapshots — what the invariant tests replay; "counters" keeps
    # only event counts, for large-scale replays where the snapshots
    # dominate the hot path.
    audit: str = "full"
    # Event scheduling: "indexed" (default) answers idle wake-ups from
    # incremental structures (loader readiness heap, memoized prediction
    # triggers, online overlap accounting); "linear" is the retained
    # pre-refactor reference path that rescans per step.  Both produce
    # bit-identical audit trails and stats.
    scheduler: str = "indexed"

    def __post_init__(self):
        if not self.tenants:
            raise ValueError("ServingConfig needs at least one TenantSpec")
        if self.audit not in ("full", "counters"):
            raise ValueError(
                f"audit must be 'full' or 'counters', got {self.audit!r}")
        if self.scheduler not in ("indexed", "linear"):
            raise ValueError(
                "scheduler must be 'indexed' or 'linear', got "
                f"{self.scheduler!r}")
        if self.fault is not None and not self.loader.sharded:
            raise ValueError(
                "ServingConfig(fault=...) requires "
                "LoaderSpec(sharded=True) — chip faults drain a device "
                "ledger")
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in {names}")
        if self.executor not in ("real", "sim"):
            raise ValueError(
                f"executor must be 'real' or 'sim', got {self.executor!r}")
        # Fail at declaration time, not at start(): unknown policy names
        # raise here with the registered set in the message.  "none" is
        # the unmanaged baseline, handled by the manager itself.
        if self.policy != "none":
            resolve_policy(self.policy)

    # -- serialization round trip ---------------------------------------
    def to_dict(self) -> dict:
        from repro_torch.core.policies import available_policies
        d = dataclasses.asdict(self)
        if not isinstance(self.policy, str):
            name = resolve_policy(self.policy).name
            if name not in available_policies():
                raise ValueError(
                    f"policy {type(self.policy).__name__!r} (name="
                    f"{name!r}) is not registered — @register_policy it "
                    f"to make the config serializable")
            d["policy"] = name
        if not isinstance(d.get("fallback"), (str, type(None))):
            name = self.fallback.name
            if name not in ("desperation", "none"):
                raise ValueError(
                    f"fallback {type(self.fallback).__name__!r} has no "
                    f"serializable name; pass 'desperation'/'none' or "
                    f"keep the instance form for in-process use")
            d["fallback"] = name
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ServingConfig":
        d = dict(d)
        d["tenants"] = tuple(
            t if isinstance(t, TenantSpec)
            else TenantSpec(**{**t, "precisions": tuple(t["precisions"])})
            for t in d["tenants"])
        for key, spec_cls in (("batching", BatchingSpec),
                              ("loader", LoaderSpec),
                              ("predictor", PredictorSpec),
                              ("fault", FaultSpec)):
            if key in d and isinstance(d[key], dict):
                d[key] = spec_cls(**d[key])
        if d.get("kv_headroom_shape") is not None:
            d["kv_headroom_shape"] = tuple(d["kv_headroom_shape"])
        return cls(**d)


# ---------------------------------------------------------------------------
# Sim-time executor: the TenantExecutor protocol without a model
# ---------------------------------------------------------------------------
class SimTenant:
    """Deterministic ``TenantExecutor``: zoo sizes from exact parameter
    math (:func:`zoo_from_config`, no weights materialized), zero-token
    outputs, and a *virtual* service time derived from the loaded
    variant's load cost via the paper's load/infer asymmetry — so a full
    engine run is reproducible bit-for-bit with no device work and no wall-clock
    jitter."""

    def __init__(self, name: str, cfg: ModelConfig,
                 precisions: Tuple[int, ...] = (16, 8),
                 predictor: Optional[RequestPredictor] = None,
                 service_ms: Optional[float] = None):
        self.name = name
        self.cfg = cfg
        self.zoo = zoo_from_config(cfg, precisions=tuple(precisions))
        self.predictor = predictor or RequestPredictor(context=8, hidden=16)
        self.service_ms = service_ms  # None => variant.load_ms / asymmetry
        self.loaded_bits: Optional[int] = None

    # -- loader callback target -----------------------------------------
    def set_variant(self, variant: Optional[ModelVariant]) -> None:
        self.loaded_bits = variant.bits if variant else None

    # -- TenantExecutor protocol -----------------------------------------
    def execute(self, batch, extra: Optional[dict] = None
                ) -> Tuple[np.ndarray, float]:
        assert self.loaded_bits is not None, f"{self.name}: not loaded"
        virt = (self.service_ms if self.service_ms is not None
                else self.zoo.by_bits(self.loaded_bits).load_ms
                / LOAD_OVER_INFER)
        tokens = np.zeros((len(batch.requests), batch.max_new), np.int32)
        return tokens, virt


# ---------------------------------------------------------------------------
# The wiring ``EdgeServer.build`` performs
# ---------------------------------------------------------------------------
def build_server(config: ServingConfig, cls=None, device="cuda"):
    """Resolve a :class:`ServingConfig` into a started server: register
    every tenant (real quantized zoos or sim executors), install
    predictors, derive the budget, and ``start()`` the manager + loader +
    engine.  This is the only construction path the benchmarks, examples,
    and launcher use.

    Real tenants are initialized, quantized and served on ``device`` —
    the card unless the caller asks for the CPU; asking for CUDA without
    a card raises.  Sim executors touch no device."""
    from repro_torch.serving.engine import kv_cache_mb
    from repro_torch.serving.server import resolve_device

    cls = cls or EdgeServer
    if config.executor == "real":
        device = resolve_device(device)
    srv = cls(budget_mb=config.budget_mb or 0.0,
              policy=config.policy,
              fallback=config.fallback,
              delta_ms=config.delta_ms,
              adaptive_delta=config.adaptive_delta,
              history_ms=config.history_ms,
              straggler_deadline_s=config.straggler_deadline_s,
              max_batch=config.batching.max_batch,
              batch_window_ms=config.batching.window_ms,
              continuous=config.batching.continuous,
              kv_page_mb=config.batching.kv_page_mb,
              prefetch=config.loader.prefetch,
              sharded_mesh=(config.loader.mesh_shape
                            if config.loader.sharded else None),
              device_budget_mb=config.loader.device_budget_mb,
              migrate=config.loader.migrate,
              compress=config.loader.compress,
              fault=config.fault,
              audit=config.audit,
              scheduler=config.scheduler,
              device=device)
    ps = config.predictor
    for spec in config.tenants:
        from repro_torch.configs import get_config
        cfg = get_config(spec.config_name, reduced=spec.reduced)
        predictor = RequestPredictor(
            context=ps.context, hidden=ps.hidden,
            min_fit_samples=ps.min_fit_samples,
            refit_interval=ps.refit_interval,
            fit_steps=ps.fit_steps,
            device=str(device) if config.executor == "real" else "cpu")
        # The linear reference scheduler keeps the pre-refactor
        # O(history) predict cost (bit-identical values either way) so
        # engine_scale's A/B measures against a faithful baseline.
        predictor.full_history_predict = config.scheduler == "linear"
        if config.executor == "sim":
            srv.register_tenant(spec.name, SimTenant(
                spec.name, cfg, precisions=spec.precisions,
                predictor=predictor, service_ms=spec.service_ms))
        else:
            from repro_torch.models import transformer as T
            # Initialized on the serving device: a full-width model's f32
            # weights never pass through host memory, only its variants.
            params = T.init_params(cfg, spec.init_seed, torch.float32,
                                   device=device)
            srv.register(spec.name, cfg, params, spec.precisions,
                         predictor=predictor)
            del params
    if config.executor == "sim":
        # Deterministic runs: a background fit must not race the virtual
        # clock, so sim builds wait each fit out at its schedule point.
        srv.sync_predictor_fits = True
    if config.budget_mb is None:
        headroom = config.kv_headroom_mb
        if config.kv_headroom_shape is not None:
            b, total_len = config.kv_headroom_shape
            headroom += max(kv_cache_mb(t.cfg, b, total_len)
                            for t in srv.tenants.values())
        srv.budget_mb = srv.contention_budget(headroom)
    srv.start()
    return srv
