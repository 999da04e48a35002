"""The residency-action IR: one transactional plan/apply layer for every
memory mutation in the framework.

Before this layer, the decision logic that is Edge-MultiAI's actual
contribution — *which* NN variants occupy the contended edge memory —
was enacted by five call sites each hand-mutating :class:`MemoryState`
with its own partial invariant checks (admission downgrade loops, the
desperation fallback, the loaders' enqueue/cancel/shrink paths, the
sharded shard-fit failure path).  Composite mutations were not atomic:
a plan that went stale mid-enactment left its evictions behind.

This module makes residency changes *data*: small frozen action records
composed into a :class:`ResidencyPlan`, validated and committed by
exactly one applier — ``MemoryState.simulate(plan)`` (checks budget +
per-device ledgers without mutating) and ``MemoryState.apply(plan)``
(all-or-nothing: any infeasible action rolls the whole plan back and
raises :class:`PlanError`).  Policies and the manager *build* plans; the
serving loaders *translate* applied actions into their physical stage
ops.  Because a plan is pure data over a simulatable state, enumerating
and scoring candidate plans is cheap — which is what the cost-aware
policy plugin and the cross-device migration planner below rely on.

Action vocabulary:

* :class:`Load` — make ``variant`` resident (a synchronous load or a
  staged-load commit), or with ``staged=True`` reserve the in-flight
  claim a background transfer will convert to weights.
* :class:`Unload` / :class:`Downgrade` — evict a victim outright or
  replace it with a smaller variant (the policies' eviction verbs).
* :class:`Shrink` — shrink an in-flight claim to a smaller variant's
  (single-stream loader; the sharded loader expresses a shrink as
  ``CancelPrefetch`` + ``Load(staged=True)`` in one atomic plan).
* :class:`CancelPrefetch` — release an in-flight claim (global and, on
  a mesh, shard-by-shard in device order).
* :class:`ChargeKV` / :class:`EvictKV` — charge a batch's decode cache
  against the budget / return it on retirement.
* :class:`MigrateShard` — move one resident tenant's per-device shard
  between chips of the :class:`~repro_torch.core.memory_state.DeviceLedger`
  (the cross-device victim-migration primitive).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import TYPE_CHECKING, Iterator, List, Optional, Tuple, Union

from repro_torch.core.model_zoo import ModelVariant

if TYPE_CHECKING:  # pragma: no cover - typing only, no runtime cycle
    from repro_torch.core.memory_state import MemoryState

INF = math.inf
EPS = 1e-9


class PlanError(RuntimeError):
    """A plan failed validation; ``MemoryState.apply`` raises this *after*
    rolling back every action it had already applied."""


# ---------------------------------------------------------------------------
# Policy-level plan records (moved here from repro_torch.core.policies, which
# re-exports them: a ProcurePlan is the policies' answer, and
# ``procure_actions`` compiles it onto the action IR for enactment).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Eviction:
    """One victim decision from a policy: replace ``app``'s resident
    ``old`` variant with ``new`` (``None`` = unload outright).  Compiled
    to :class:`Unload`/:class:`Downgrade` actions by
    :func:`eviction_actions`.

    >>> from repro_torch.core.model_zoo import ModelVariant
    >>> old = ModelVariant("m-16bit", 16, 100.0, 0.9, 50.0)
    >>> new = ModelVariant("m-8bit", 8, 50.0, 0.85, 25.0)
    >>> Eviction("m", old, new).freed_mb
    50.0
    """
    app: str
    old: ModelVariant
    new: Optional[ModelVariant]  # None = fully unloaded

    @property
    def freed_mb(self) -> float:
        return self.old.size_mb - (self.new.size_mb if self.new else 0.0)


@dataclass(frozen=True)
class ProcurePlan:
    """A policy's full answer to "procure weights for ``app``": the
    variant to load (``None`` = declared inference failure) plus the
    victim evictions that fund it.  :func:`procure_actions` compiles it
    onto the action IR."""
    app: str
    variant: Optional[ModelVariant]  # None => inference failure
    evictions: Tuple[Eviction, ...] = ()

    @property
    def ok(self) -> bool:
        return self.variant is not None


# ---------------------------------------------------------------------------
# Actions
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Load:
    """Make ``variant`` resident for ``app``.

    ``staged=False`` (default) commits: ``claim_mb`` / ``shard_claims``
    — the in-flight claim a background load held — are released in the
    same transaction the weights are charged, so a commit is net-zero on
    ``free_mb`` and can never trip the budget.  Synchronous (admission
    path) loads simply leave the claim fields at zero/None.

    ``staged=True`` reserves instead of committing: the claim is charged
    (globally, and per chip when ``shard_claims`` is set) so planning
    against ``free_mb`` cannot double-book memory the transfer already
    owns.  ``claim_mb=None`` means "the marginal footprint over the
    currently loaded variant", resolved by the loader at execute time.
    """
    app: str
    variant: ModelVariant
    staged: bool = False
    claim_mb: Optional[float] = None
    shard_claims: Optional[Tuple[float, ...]] = None


@dataclass(frozen=True)
class Unload:
    """Evict ``app``'s resident variant outright (the policies' and the
    drain planner's last-resort verb); its weights and per-device shards
    are released in the same transaction."""
    app: str
    variant = None  # uniform `.variant` access for stage callbacks


@dataclass(frozen=True)
class Downgrade:
    """Replace ``app``'s resident variant with the smaller ``variant``.

    ``in_place=True`` declares that the switch is an **in-place
    requantization**: ``variant`` is a lower-bits sibling of the resident
    variant, so the new weights are derived from the resident leaves via
    the ``quant_matmul`` int8 machinery — zero bytes move over the
    host→chip link.  The residency/ledger effect is identical either way
    (the ``DeviceLedger`` scales the tenant's current layout to the new
    total atomically); only the physical staging cost differs, which the
    loader channels count (``inplace_downgrades`` vs ``wire_mb_staged``).
    ``MemoryState`` validates the claim: an in-place downgrade to a
    variant that is not strictly lower-bits than the resident one — or
    with nothing resident at all — is a :class:`PlanError`.

    >>> from repro_torch.core.model_zoo import ModelVariant
    >>> v8 = ModelVariant("m-8bit", 8, 50.0, 0.85, 25.0)
    >>> Downgrade("m", v8, in_place=True).in_place
    True
    """
    app: str
    variant: ModelVariant
    in_place: bool = False


@dataclass(frozen=True)
class Shrink:
    """Shrink an in-flight claim to ``variant``'s marginal footprint,
    releasing ``release_mb`` back to the pool (single-stream loader)."""
    app: str
    variant: ModelVariant
    release_mb: float


@dataclass(frozen=True)
class CancelPrefetch:
    """Release an in-flight load's claim: ``claim_mb`` globally, plus
    one claim per device (walked in device order) on a sharded mesh."""
    app: str
    claim_mb: float
    shard_claims: Optional[Tuple[float, ...]] = None


@dataclass(frozen=True)
class ChargeKV:
    """Charge a decode cache to ``app``.

    Scalar form (``seq=None``): ``mb`` is a whole-batch charge, the
    pre-paging accounting unit.  Page-granular form (``seq`` set, a
    request id): when the state has a
    :class:`~repro_torch.core.memory_state.KVPagePool` installed, the charge
    allocates fixed-size pages for that sequence — ``pages`` explicitly,
    else ``ceil(mb / page_mb)`` — and the charged MB is the page-rounded
    footprint.  Page allocation validates against the pool's free lists
    (and per-device page capacity on a mesh) exactly like weight shards:
    an unfundable allocation raises ``PlanError`` under simulate/apply.
    """
    app: str
    mb: float
    seq: Optional[int] = None
    pages: Optional[int] = None


@dataclass(frozen=True)
class EvictKV:
    """Return a retired decode cache.  Scalar form releases ``mb``;
    page-granular form (``seq`` set) frees exactly the pages the pool
    holds for that sequence, deriving the MB from the page table — so a
    release can never drift from its charge."""
    app: str
    mb: float
    seq: Optional[int] = None


@dataclass(frozen=True)
class MigrateShard:
    """Move ``mb`` of ``app``'s committed weights from chip ``src`` to
    chip ``dst``: the cross-device victim-migration primitive.  The
    moved layout persists until the tenant's next (re)load re-derives
    the canonical split — by which point the weights are restaged
    anyway."""
    app: str
    src: int
    dst: int
    mb: float


Action = Union[Load, Unload, Downgrade, Shrink, CancelPrefetch,
               ChargeKV, EvictKV, MigrateShard]

# Actions that change which variant is resident — the ones a physical
# stage callback must mirror to the device.
RESIDENCY_ACTIONS = (Load, Downgrade, Unload)


@dataclass(frozen=True)
class ResidencyPlan:
    """An ordered, atomic group of residency actions.  ``simulate``
    validates the whole sequence against the budget and the per-device
    ledger without mutating; ``apply`` commits all-or-nothing."""
    actions: Tuple[Action, ...]

    def __iter__(self) -> Iterator[Action]:
        return iter(self.actions)

    def __len__(self) -> int:
        return len(self.actions)

    def __add__(self, other: "ResidencyPlan") -> "ResidencyPlan":
        return ResidencyPlan(self.actions + other.actions)

    @property
    def apps(self) -> Tuple[str, ...]:
        return tuple(dict.fromkeys(a.app for a in self.actions))


def plan_of(*actions: Action) -> ResidencyPlan:
    """Convenience constructor: ``plan_of(Downgrade(...), Load(...))``."""
    return ResidencyPlan(tuple(actions))


# ---------------------------------------------------------------------------
# Builders: compile policy-level plans onto the action IR
# ---------------------------------------------------------------------------
def downgrade_action(app: str, old: Optional[ModelVariant],
                     new: ModelVariant) -> Downgrade:
    """A :class:`Downgrade` that requantizes **in place** whenever it
    can: ``new`` strictly lower-bits than the resident ``old`` means the
    target weights are derivable from the resident leaves (int8/int4
    from wider), so the variant switch moves zero bytes over the link.
    Every planner that emits downgrades compiles through here, so the
    preference is uniform across cost-bfe, desperation, KV headroom,
    self-downgrade, and the elastic drain."""
    in_place = old is not None and new.bits < old.bits
    return Downgrade(app, new, in_place=in_place)


def eviction_actions(evictions) -> Tuple[Action, ...]:
    """Victim evictions as actions: ``new=None`` unloads, else downgrades
    (in place when the target is a lower-bits sibling of the resident
    variant — see :func:`downgrade_action`)."""
    return tuple(Unload(e.app) if e.new is None
                 else downgrade_action(e.app, e.old, e.new)
                 for e in evictions)


def procure_actions(plan: ProcurePlan, *, staged: bool = False
                    ) -> Tuple[Action, ...]:
    """A :class:`ProcurePlan` as actions: the victims' evictions followed
    by the requester's load (``staged=True`` for a background transfer,
    whose claim the loader resolves to the marginal footprint)."""
    acts = eviction_actions(plan.evictions)
    if plan.variant is not None:
        acts += (Load(plan.app, plan.variant, staged=staged),)
    return acts


def concretize_load(act: Load, state: "MemoryState") -> Load:
    """Resolve a staged :class:`Load`'s ``claim_mb=None`` to the marginal
    footprint over what ``state`` says is loaded."""
    if not act.staged or act.claim_mb is not None:
        return act
    loaded = state.tenants[act.app].loaded
    charge = act.variant.size_mb - (loaded.size_mb if loaded else 0.0)
    return replace(act, claim_mb=max(0.0, charge))


def staged_load_action(state: "MemoryState", app: str,
                       variant: ModelVariant) -> Load:
    """A fully concrete staged :class:`Load`: marginal global claim plus,
    when a :class:`DeviceLedger` is installed, the per-device marginal
    shard claims from the ledger's own split — so simulating the action
    answers "would this transfer fit *every* chip", which device-blind
    eviction math cannot."""
    act = concretize_load(Load(app, variant, staged=True), state)
    led = state.devices
    if led is not None:
        cur = led.held(app, state.tenants[app].loaded)
        new = led.projected(app, variant)
        act = replace(act, shard_claims=tuple(
            max(0.0, n - c) for n, c in zip(new, cur)))
    return act


# ---------------------------------------------------------------------------
# Cross-device victim migration planner
# ---------------------------------------------------------------------------
def plan_migration(state: "MemoryState", app: str,
                   claims: Tuple[float, ...], *,
                   exclude: Tuple[str, ...] = ()
                   ) -> Optional[Tuple[MigrateShard, ...]]:
    """When ``app``'s per-device ``claims`` do not fit the ledger, move
    resident *victims'* shards off the over-committed chips onto chips
    with spare room, instead of failing or downgrading the whole load.

    Pure over ``state`` (returns actions; the caller simulates/applies).
    Victims are whole per-device shards, best-fit per chip (the smallest
    shard that covers the remaining need, else the largest available),
    name-tiebroken for determinism.  The requester itself and any tenant
    with a load mid-staging (the loader owns its residency) never move.
    A destination chip must absorb the shard *on top of* its own share
    of the incoming claim.  Returns None when migration cannot cover the
    shortfall — the caller falls back to the existing downgrade /
    clean-failure path.
    """
    led = state.devices
    if led is None:
        return None
    n = led.n_devices
    if len(claims) != n:
        raise ValueError(f"{len(claims)} claims for {n} devices")
    frozen = {app, *exclude}
    for a, t in state.tenants.items():
        if t.inflight_mb > 0.0:
            frozen.add(a)
    used = [led.used_mb(d) for d in range(n)]
    weights = {a: list(w) for a, w in led.weights.items()}

    def room(d: int) -> float:
        return led.budgets_mb[d] - used[d] - claims[d]

    moves: List[MigrateShard] = []
    for d in range(n):
        while (need := claims[d] - (led.budgets_mb[d] - used[d])) > EPS:
            cands = []
            for a in sorted(weights):
                mb = weights[a][d]
                if a in frozen or mb <= EPS:
                    continue
                dsts = [j for j in range(n)
                        if j != d and room(j) >= mb - EPS]
                if dsts:
                    cands.append((a, mb, max(dsts, key=room)))
            if not cands:
                return None  # this chip cannot be relieved
            covering = [c for c in cands if c[1] >= need]
            a, mb, dst = (min(covering, key=lambda c: c[1]) if covering
                          else max(cands, key=lambda c: c[1]))
            moves.append(MigrateShard(a, d, dst, mb))
            weights[a][d] = 0.0
            weights[a][dst] += mb
            used[d] -= mb
            used[dst] += mb
    return tuple(moves) if moves else None
