"""Serving stack of the port."""
from repro_torch.serving.api import (BatchingSpec, FaultSpec, LoaderSpec,
                               PredictorSpec, ServingConfig, SimTenant,
                               TenantSpec, build_server)
from repro_torch.serving.batcher import Batch, Batcher, Request
from repro_torch.serving.engine import (EngineEvent, LoaderChannel, RequestResult,
                                  ServingEngine, ServingHost, TenantExecutor,
                                  fast_trace_from_workload, kv_cache_mb,
                                  poisson_trace, trace_from_workload)
from repro_torch.serving.loader import BackgroundLoader, InflightLoad, LoadRecord
from repro_torch.serving.server import EdgeServer, ServeResult, TenantRuntime
from repro_torch.serving.stats import AuditEvent, EventKind, ServingStats

__all__ = ["Batch", "Batcher", "Request", "EdgeServer",
           "ServeResult", "TenantRuntime", "ServingEngine", "RequestResult",
           "EngineEvent", "kv_cache_mb", "poisson_trace",
           "trace_from_workload", "fast_trace_from_workload",
           "BackgroundLoader", "InflightLoad",
           "LoadRecord", "ServingConfig", "TenantSpec", "PredictorSpec",
           "BatchingSpec", "LoaderSpec", "FaultSpec", "SimTenant",
           "build_server", "ServingStats", "AuditEvent", "EventKind",
           "ServingHost", "TenantExecutor", "LoaderChannel"]
