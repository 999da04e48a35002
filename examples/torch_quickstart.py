"""Quickstart on the PyTorch port: the serving framework in ~30 lines (the
port of ``examples/quickstart.py``; it prints the same numbers).

One declarative config -> a fully wired multi-tenant edge server on a
4-chip mesh.  The sim-time executor makes this deterministic and touches
no device (``executor="real"`` runs the actual quantized models, on
``--device``: the card unless the CPU is asked for); everything else —
policy registry, background prefetch pipeline, per-shard staging under
per-device budgets, KV-charged admission — is exactly the production
path.

    PYTHONPATH=src python examples/torch_quickstart.py
"""
import argparse

from repro_torch.serving import poisson_trace
from repro_torch.serving.api import (BatchingSpec, EdgeServer, LoaderSpec,
                                     ServingConfig, TenantSpec)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

config = ServingConfig(
    # Two LM tenants; each gets a bf16 + int8 model zoo.
    tenants=(TenantSpec("tinyllama-1.1b"), TenantSpec("mamba2-780m")),
    policy="iws-bfe",            # any registered policy: lfe, bfe,
                                 # ws-bfe, iws-bfe, batch-bfe, ...
    delta_ms=750.0,              # prediction-window half-width
    batching=BatchingSpec(max_batch=4, window_ms=20.0),
                                 # BatchingSpec(continuous=True) makes
                                 # the *request* the admission unit
                                 # (page-rounded KV from a KVPagePool)
    executor="sim",              # deterministic virtual service times
    loader=LoaderSpec(sharded=True, mesh_shape=(4,)),  # 4-way TP mesh:
                                 # weights shard per chip, loads stage
                                 # per shard, budgets ledger per device
    kv_headroom_shape=(2, 12),   # budget headroom for a (2, 12) cache
    # fault=FaultSpec(...) schedules chip loss and recovery on the
    # engine clock (the elastic mesh; needs LoaderSpec(sharded=True)).
)                                # budget_mb=None -> derived contention

server = EdgeServer.build(config, device=args.device)  # register + start
ledger = server.manager.state.devices
print(f"budget {server.budget_mb:.2f} MB "
      f"({ledger.n_devices} chips x {ledger.budgets_mb[0]:.2f} MB), "
      f"policy {server.manager.policy.name}")

# A Poisson per-tenant trace drives the engine; the RNN predictors
# learn each cadence and the loader prefetches ahead of requests.
cfgs = {t.name: t.cfg for t in server.tenants.values()}
trace, _ = poisson_trace(cfgs, requests_per_app=20, mean_iat_ms=400.0,
                         seed=0)
# run_trace returns a frozen ServingStats; stats.to_dict() flattens it.
stats = server.engine.run_trace(trace)
server.engine.check_event_invariant()      # budget held at every event
server.close()

print(f"{stats.requests} requests: warm={stats.warm_ratio:.0%} "
      f"prefetch_hits={stats.prefetch_hits} "
      f"demand_loads={stats.demand_loads} "
      f"shards_landed={stats.shards_landed} "
      f"prediction_hit_rate={stats.prediction_hit_rate:.0%}")
