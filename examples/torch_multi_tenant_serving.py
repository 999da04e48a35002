"""End-to-end run on the PyTorch port: the event-driven serving engine
running REAL models under a device memory budget, with background
prefetching (the port of ``examples/multi_tenant_serving.py``).

Three LM architectures (reduced configs) are registered as tenants; each
gets a real zoo (bf16 + int8 weight variants built by
``repro_torch.quant``).  A Poisson per-tenant trace drives the engine:
the iWS-BFE policy decides which variant of which tenant stays resident,
every admitted batch's KV cache is charged against the same budget, int8
variants run through the fused dequant matmul (``quant_matmul``'s Hopper
kernel on the card), and RNN predictors learn each tenant's cadence and
trigger *background* loads that the BackgroundLoader stages off the hot
path (watch the ``prefetch``/``load``/``cancel`` events in the log).

The whole stack comes up from one declarative config —
``EdgeServer.build(ServingConfig(...), device=...)``.  Models run on
``--device``: the card unless the CPU is asked for.

    PYTHONPATH=src python examples/torch_multi_tenant_serving.py --device cpu
"""
import argparse

from repro_torch.serving import poisson_trace
from repro_torch.serving.api import (BatchingSpec, EdgeServer, ServingConfig,
                                     TenantSpec)

TENANTS = ["tinyllama-1.1b", "mamba2-780m", "gemma2-2b"]

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--requests", type=int, default=8,
                help="requests a tenant in the trace")
args = ap.parse_args()

server = EdgeServer.build(ServingConfig(
    tenants=tuple(TenantSpec(n) for n in TENANTS),
    policy="iws-bfe",
    delta_ms=1500.0,
    batching=BatchingSpec(max_batch=4, window_ms=100.0),
    # budget_mb=None derives the standard contended budget, with
    # headroom for the largest decode cache this trace admits.
    kv_headroom_shape=(4, 12 + 6)), device=args.device)
cfgs = {}
for name in TENANTS:
    cfgs[name] = server.tenants[name].cfg
    zoo = server.tenants[name].zoo
    print(f"tenant {name:16s} zoo: " + "  ".join(
        f"{v.bits}bit={v.size_mb:.2f}MB" for v in zoo.variants))
print(f"budget: {server.budget_mb:.2f} MB — forces contention\n")

trace, wl = poisson_trace(cfgs, requests_per_app=args.requests,
                          mean_iat_ms=800.0, deviation=0.3, seed=0,
                          max_new=6)
print(f"trace: {len(trace)} requests over {wl.horizon_ms / 1e3:.1f}s "
      f"(virtual), KL={wl.kl:.3f}\n")
stats = server.engine.run_trace(trace)
server.engine.check_event_invariant()

# Each engine event normalizes to a typed AuditEvent (kind, t, app,
# detail) — `ev.audit` — whose __str__ is the canonical log line.
for ev in server.engine.events:
    if ev.kind in ("admit", "reject", "prefetch", "demand", "load",
                   "cancel"):
        print(f"{ev.audit} used={ev.used_mb:5.2f}MB "
              f"inflight={ev.inflight_mb:5.2f}MB free={ev.free_mb:5.2f}MB")

print(f"\nthroughput: {stats.requests_per_sec or 0.0:.2f} req/s   "
      f"kv_rejections={stats.kv_rejections} "
      f"kv_downgrades={stats.kv_downgrades}")
print(f"prefetch pipeline: hits={stats.prefetch_hits} "
      f"wasted={stats.prefetch_wasted} "
      f"demand_loads={stats.demand_loads} "
      f"loads_committed={stats.loads_committed} "
      f"load_overlap={stats.load_overlap_ms:.1f}ms")
print(f"predictors: window_hit_rate={stats.prediction_hit_rate:.2f} "
      f"background_fits_scheduled={stats.fits_scheduled}")
for app, s in stats.per_tenant.items():
    print(f"  {app:16s} n={s['requests']:3d} warm={s['warm_ratio']:.2f} "
          f"fail={s['fail_ratio']:.2f} p50={s['p50_ms']:7.0f}ms "
          f"p95={s['p95_ms']:7.0f}ms p99={s['p99_ms']:7.0f}ms "
          f"batch={s['mean_batch']:.1f}")
st = server.manager.state
print(f"final residency: weights={st.weights_mb:.2f}MB kv={st.kv_mb:.2f}MB "
      f"of {st.budget_mb:.2f}MB")
server.close()
