"""Cluster tier on the PyTorch port: warm-aware routing across a fleet of
edge servers.  The port of examples/cluster_serving.py; it prints the
same fleet numbers.

Three sim-executor EdgeServers come up from ONE declarative document —
``EdgeCluster.build(ClusterConfig(...))`` — and share a single global
virtual clock.  A flash-crowd trace (Poisson baseline per tenant, plus
an *unpredicted* dense burst on tinyllama mid-trace) is routed request
by request: the warm-aware router reads each server's typed
``ServerView`` (which tenants are resident or staging at what variant
accuracy, queue depths — only state a real fleet's stats endpoint would
publish) and keeps every tenant's requests on the box already holding
its weights, spilling to an idle neighbor only once the home queue gets
expensive.  The same trace under round-robin sprays requests
everywhere, so every server churns every zoo — the fleet-wide warm
ratio is the A/B.

Everything is bit-deterministic: same trace + same config → identical
per-server audit trails, so the printed numbers never wobble.

    PYTHONPATH=src python examples/torch_cluster_serving.py
"""
from repro_torch.cluster import ClusterConfig, EdgeCluster, RouterSpec
from repro_torch.core.simulator import generate_flash_crowd
from repro_torch.serving import trace_from_workload
from repro_torch.serving.api import ServingConfig, TenantSpec

TENANTS = ["tinyllama-1.1b", "mamba2-780m", "gemma2-2b"]

base = ServingConfig(
    tenants=tuple(TenantSpec(n) for n in TENANTS),
    policy="bfe",
    executor="sim")

wl = generate_flash_crowd(
    TENANTS, requests_per_app=36, base_iat_ms=8000.0,
    burst_app=TENANTS[0], burst_requests=40, burst_iat_ms=100.0, seed=7)
print(f"flash-crowd trace: {len(wl.requests)} requests over "
      f"{wl.horizon_ms / 1e3:.1f}s (virtual); the {TENANTS[0]} burst "
      f"is absent from the predictions\n")

for router in ("round-robin", "warm-aware"):
    cfg = ClusterConfig.uniform(
        3, base, RouterSpec(name=router, handoff_queue=4))
    cluster = EdgeCluster.build(cfg)
    cfgs = {t.name: t.cfg for t in cluster.servers[0].tenants.values()}
    trace = trace_from_workload(wl, cfgs, seed=3, prompt_len=(8, 9),
                                max_new=4)
    stats = cluster.run_trace(trace)
    cluster.check_event_invariant()
    c = stats.cluster
    print(f"router={router}")
    print(f"  fleet warm_ratio : {stats.warm_ratio:.3f} "
          f"({stats.requests} requests)")
    print(f"  routed/spilled   : {c['routed']}/{c['spilled']} "
          f"(handoffs={c['handoffs']})")
    print(f"  per-server load  : "
          + "  ".join(f"s{i}={n}req warm={w:.3f}"
                      for i, (n, w) in enumerate(
                          zip(c["per_server_requests"],
                              c["per_server_warm_ratio"]))))
    for app, s in sorted(stats.per_tenant.items()):
        print(f"    {app:16s} warm={s['warm_ratio']:.3f} "
              f"requests={s['requests']}")
    cluster.close()
    print()

print("warm-aware keeps each tenant's home server warm; round-robin "
      "spreads the churn.")
