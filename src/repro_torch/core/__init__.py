"""Edge-MultiAI core: the paper's contribution.

Layers: model zoos (per-tenant precision variants) → memory state →
eviction policies (LFE / BFE / WS-BFE / iWS-BFE) → manager (predictors +
memory optimizer + loader) → E2C-style simulator for the paper's
evaluation protocol.
"""
from repro_torch.core.actions import (CancelPrefetch, ChargeKV, Downgrade,
                                EvictKV, Load, MigrateShard, PlanError,
                                ResidencyPlan, Shrink, Unload, Eviction,
                                eviction_actions, plan_migration, plan_of,
                                procure_actions, staged_load_action)
from repro_torch.core.manager import (BatchAdmission, EdgeMultiAI,
                                InferenceRecord, Metrics)
from repro_torch.core.memory_state import MemoryState, TenantState
from repro_torch.core.model_zoo import ModelVariant, ModelZoo, zoo_from_config
from repro_torch.core.policies import (BatchAware, DemandContext,
                                 DesperationFallback, FallbackPolicy,
                                 Policy, ProcurePlan, available_policies,
                                 kv_headroom_plan, register_policy,
                                 resolve_policy)
from repro_torch.core.predictor import MemoryPredictor, RequestPredictor
from repro_torch.core.simulator import (SimResult, Workload, generate_workload,
                                  generate_zoo, simulate, sweep_policies)

__all__ = [
    "BatchAdmission", "EdgeMultiAI", "InferenceRecord", "Metrics",
    "MemoryState", "TenantState", "ModelVariant", "ModelZoo",
    "Load", "Unload", "Downgrade", "Shrink", "CancelPrefetch",
    "ChargeKV", "EvictKV", "MigrateShard", "ResidencyPlan", "PlanError",
    "Eviction", "plan_of", "plan_migration", "procure_actions",
    "eviction_actions", "staged_load_action",
    "zoo_from_config", "ProcurePlan", "kv_headroom_plan",
    "Policy", "BatchAware", "DemandContext", "DesperationFallback",
    "FallbackPolicy", "available_policies", "register_policy",
    "resolve_policy",
    "MemoryPredictor", "RequestPredictor", "SimResult", "Workload",
    "generate_workload", "generate_zoo", "simulate", "sweep_policies",
]
