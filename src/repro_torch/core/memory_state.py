"""Memory tier state (§III-A "Memory Tier"): tracks loaded variants, live
KV-cache charges, free space, and per-tenant request/prediction bookkeeping.

``used_mb`` counts weights, per-tenant KV caches *and* each tenant's
CUDA-graph pool (the memory its captured ``generate`` graphs keep on the
card while its variant stays): admission and eviction decisions see
runtime memory, not just model residency, so a tenant mid-decode cannot
be silently overcommitted by a procurement.  A pool goes with the variant
its graphs read, so any change of a tenant's loaded variant clears its
pool charge.

This is deliberately a plain-Python, side-effect-free data layer so the
eviction policies are pure functions over it — which is what lets the
hypothesis property tests drive millions of random schedules through the
invariant "Σ loaded sizes ≤ budget, always".

Mutations go through the residency-action IR: callers build a
:class:`~repro_torch.core.actions.ResidencyPlan` and hand it to
:meth:`MemoryState.simulate` (validate without mutating) or
:meth:`MemoryState.apply` (commit all-or-nothing).  The per-primitive
methods (``load`` / ``reserve_kv`` / ``reserve_inflight`` / …) remain
public for tests and as the applier's internals, but ``apply`` is the
only entry point the framework itself uses.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core import actions as A
from repro_torch.core.model_zoo import ModelVariant, ModelZoo

INF = math.inf


class KVPagePool:
    """Fixed-size KV pages with per-tenant, per-sequence page tables.

    The pool makes the KV cache a first-class paged resource: a sequence
    charges ``ceil(need / page_mb)`` pages at admission and frees exactly
    those pages at retirement, so the accounting unit is the request, not
    the batch, and a release can never drift from its charge.  Page ids
    are partitioned across devices (``device_pages[d]`` pages own a
    contiguous id range), so on a mesh an allocation validates per-chip
    page capacity the same way weight shards validate per-chip budgets —
    through :meth:`MemoryState.simulate` / :meth:`MemoryState.apply`,
    which snapshot and restore the pool alongside the ledger.

    Allocation is deterministic: pages come from the device with the most
    free pages (ties to the lowest device), lowest free id first, so two
    identical schedules produce identical page tables.
    """

    def __init__(self, page_mb: float, n_pages: Optional[int] = None, *,
                 device_pages: Optional[Tuple[int, ...]] = None):
        if page_mb <= 0:
            raise ValueError(f"bad page size: {page_mb}MB")
        if device_pages is None:
            if n_pages is None or n_pages <= 0:
                raise ValueError(f"bad page count: {n_pages}")
            device_pages = (int(n_pages),)
        if any(p < 0 for p in device_pages):
            raise ValueError(f"bad device page counts: {device_pages}")
        self.page_mb = float(page_mb)
        self.device_pages = tuple(int(p) for p in device_pages)
        self.n_devices = len(self.device_pages)
        starts, off = [], 0
        for p in self.device_pages:
            starts.append(off)
            off += p
        self._starts = tuple(starts)
        # Sorted free-page ids per device (ascending: lowest id first).
        self.free: List[List[int]] = [
            list(range(s, s + p))
            for s, p in zip(self._starts, self.device_pages)]
        # app -> seq (request id) -> allocated page ids.
        self.tables: Dict[str, Dict[int, Tuple[int, ...]]] = {}
        # Monotone allocation stamps: victim selection preempts the
        # youngest sequence first (least decode progress lost).
        self._stamp = 0
        self._stamps: Dict[Tuple[str, int], int] = {}
        # Free pages of offline devices (chip loss): stashed out of the
        # allocatable lists until the device is restored, so a page
        # freed on a dead chip never funds a new allocation there.
        self._offline_free: Dict[int, List[int]] = {}

    # -- queries ---------------------------------------------------------
    @property
    def n_pages(self) -> int:
        return sum(self.device_pages)

    @property
    def free_pages(self) -> int:
        return sum(len(f) for f in self.free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - self.free_pages

    def pages_for(self, mb: float) -> int:
        """Pages needed to hold ``mb`` (page-rounded, never zero for a
        positive need)."""
        if mb <= 0:
            return 0
        return max(1, int(math.ceil(mb / self.page_mb - 1e-9)))

    def device_of(self, pid: int) -> int:
        for d in range(self.n_devices - 1, -1, -1):
            if pid >= self._starts[d]:
                return d
        raise ValueError(f"bad page id {pid}")

    def held_pages(self, app: str) -> int:
        return sum(len(p) for p in self.tables.get(app, {}).values())

    def seq_pages(self, app: str, seq: int) -> Tuple[int, ...]:
        return self.tables.get(app, {}).get(seq, ())

    def seqs_on_device(self, device: int) -> List[Tuple[str, int]]:
        """Sequences holding at least one page on ``device`` (sorted for
        determinism) — the chip-loss drain planner's eviction set."""
        out = []
        for app in sorted(self.tables):
            for seq in sorted(self.tables[app]):
                if any(self.device_of(p) == device
                       for p in self.tables[app][seq]):
                    out.append((app, seq))
        return out

    def victim_seqs(self, exclude: str = "") -> List[Tuple[str, int, int]]:
        """Preemption candidates ``(app, seq, n_pages)``, youngest
        allocation first, excluding the requester's own sequences."""
        out = [(stamp, app, seq)
               for (app, seq), stamp in self._stamps.items()
               if app != exclude]
        out.sort(reverse=True)
        return [(app, seq, len(self.tables[app][seq]))
                for _, app, seq in out]

    # -- mutations -------------------------------------------------------
    def allocate(self, app: str, seq: int, n: int) -> Tuple[int, ...]:
        """Allocate ``n`` pages for ``(app, seq)``; raises
        :class:`~repro_torch.core.actions.PlanError` when the pool cannot fund
        them (a full pool is a planning decision, like a full chip)."""
        if n <= 0:
            raise A.PlanError(f"bad page allocation for {app}/{seq}: {n}")
        if seq in self.tables.get(app, {}):
            raise A.PlanError(f"sequence {app}/{seq} already holds pages")
        if self.free_pages < n:
            raise A.PlanError(
                f"KV pool exhausted: {app}/{seq} needs {n} pages, "
                f"{self.free_pages} free of {self.n_pages}")
        got: List[int] = []
        for _ in range(n):
            d = max(range(self.n_devices), key=lambda i: len(self.free[i]))
            got.append(self.free[d].pop(0))
        self.tables.setdefault(app, {})[seq] = tuple(got)
        self._stamps[(app, seq)] = self._stamp
        self._stamp += 1
        return tuple(got)

    def release(self, app: str, seq: int) -> int:
        """Free a sequence's pages; returns the page count (0 when the
        pool holds nothing for it — the caller accounts the drift)."""
        pages = self.tables.get(app, {}).pop(seq, ())
        if not self.tables.get(app):
            self.tables.pop(app, None)
        self._stamps.pop((app, seq), None)
        for pid in pages:
            d = self.device_of(pid)
            dest = (self._offline_free[d] if d in self._offline_free
                    else self.free[d])
            dest.append(pid)
            dest.sort()
        return len(pages)

    def release_app(self, app: str) -> int:
        """Crash-release every sequence a tenant holds (a failed batch
        must not leak pages)."""
        total = 0
        for seq in tuple(self.tables.get(app, {})):
            total += self.release(app, seq)
        return total

    # -- elastic mesh ----------------------------------------------------
    def offline_device(self, device: int) -> None:
        """Chip loss: pull the device's free pages out of the allocatable
        lists.  Pages still *held* on the chip stay in their tables — the
        drain planner evicts those sequences, and :meth:`release` routes
        their pages into the offline stash instead of back into play."""
        if device in self._offline_free:
            return
        self._offline_free[device] = sorted(self.free[device])
        self.free[device] = []

    def restore_device(self, device: int) -> None:
        """Chip recovery: the stashed pages become allocatable again."""
        stash = self._offline_free.pop(device, None)
        if stash is None:
            return
        self.free[device] = sorted(self.free[device] + stash)

    def check_invariant(self) -> None:
        held = sum(self.held_pages(a) for a in self.tables)
        offline = sum(len(f) for f in self._offline_free.values())
        if held + self.free_pages + offline != self.n_pages:
            raise AssertionError(
                f"page conservation violated: {held} held + "
                f"{self.free_pages} free + {offline} offline "
                f"!= {self.n_pages} total")

    # -- transactional support ------------------------------------------
    def _snapshot(self) -> Tuple[Any, ...]:
        return ([list(f) for f in self.free],
                {a: dict(t) for a, t in self.tables.items()},
                self._stamp, dict(self._stamps),
                {d: list(f) for d, f in self._offline_free.items()})

    def _restore(self, snap: Tuple[Any, ...]) -> None:
        free, tables, stamp, stamps, offline = snap
        self.free = [list(f) for f in free]
        self.tables = {a: dict(t) for a, t in tables.items()}
        self._stamp = stamp
        self._stamps = dict(stamps)
        self._offline_free = {d: list(f) for d, f in offline.items()}


class DeviceLedger:
    """Per-device memory accounting for a sharded (multi-chip) mesh.

    The global ``MemoryState`` budget answers "does it fit on the box";
    this ledger answers "does every *shard* fit on its chip" — tensor
    parallelism replicates some leaves (norms, odd-width projections), so
    a tenant's per-device footprint is ``split_fn(app, variant)[d]``, not
    ``size_mb / n``.  The sharded loader checks :meth:`fits` before
    claiming, charges whole-load claims up front, and releases them
    shard-by-shard on cancel; committed weights are re-derived from the
    loaded variant on every :meth:`on_load` so evictions and downgrades
    enacted by *any* caller (policies, desperation, admission) stay in
    sync without those callers knowing devices exist.

    Per-device budgets bound weights + in-flight claims; KV caches are a
    global charge against the ``MemoryState`` budget, with per-chip page
    *placement* tracked by the :class:`KVPagePool` when one is installed
    (the pool partitions its page ids across devices, so page-granular
    ``ChargeKV`` validates per-chip capacity like a shard claim).
    """

    def __init__(self, budgets_mb: Tuple[float, ...],
                 split_fn: Callable[[str, ModelVariant],
                                    Tuple[float, ...]]):
        if not budgets_mb or any(b < 0 for b in budgets_mb):
            raise ValueError(f"bad device budgets: {budgets_mb}")
        self.budgets_mb = tuple(float(b) for b in budgets_mb)
        self.split_fn = split_fn
        self.n_devices = len(self.budgets_mb)
        # Committed weight shards per app (re-derived on every load).
        self.weights: Dict[str, Tuple[float, ...]] = {}
        # In-flight claims per app per device (sharded loads mid-staging).
        self.inflight: Dict[str, List[float]] = {}
        # Shards moved between chips by MigrateShard actions (stats).
        self.shards_migrated = 0
        # Original budgets of offline chips (chip loss): budget drops to
        # zero while the chip is down, restored verbatim on recovery.
        self._offline: Dict[int, float] = {}

    # -- queries ---------------------------------------------------------
    def split(self, app: str, variant: Optional[ModelVariant]
              ) -> Tuple[float, ...]:
        if variant is None:
            return (0.0,) * self.n_devices
        shards = tuple(self.split_fn(app, variant))
        if len(shards) != self.n_devices:
            raise ValueError(
                f"split_fn returned {len(shards)} shards for "
                f"{self.n_devices} devices")
        return shards

    def used_mb(self, device: int) -> float:
        return (sum(w[device] for w in self.weights.values())
                + sum(c[device] for c in self.inflight.values()))

    def device_used(self) -> Tuple[float, ...]:
        """Weights + in-flight claims per device (the invariant's LHS)."""
        return tuple(self.used_mb(d) for d in range(self.n_devices))

    def free_mb(self, device: int) -> float:
        return self.budgets_mb[device] - self.used_mb(device)

    def fits(self, claims: Tuple[float, ...]) -> bool:
        """Would charging ``claims[d]`` on each device stay in budget?
        One overfull shard fails the whole load — cleanly, before any
        claim lands."""
        return all(self.free_mb(d) >= claims[d] - 1e-9
                   for d in range(self.n_devices))

    def held(self, app: str, variant: Optional[ModelVariant] = None
             ) -> Tuple[float, ...]:
        """Actual per-device holdings — the migrated layout when one
        exists; falls back to ``variant``'s canonical split when the
        ledger has not seen a load for ``app`` yet."""
        cur = self.weights.get(app)
        if cur is not None:
            return tuple(cur)
        return self.split(app, variant)

    def projected(self, app: str, variant: Optional[ModelVariant]
                  ) -> Tuple[float, ...]:
        """Per-device holdings after swapping ``app``'s weights to
        ``variant``: the *current* (possibly migrated) layout scaled to
        the new total — a migrated victim keeps its layout, so the chip
        it vacated stays vacated through downgrades and upgrades, and a
        per-chip budget that held keeps holding.  Canonical split when
        nothing is held (a cold load re-derives the canonical layout).
        For never-migrated tenants the current layout *is* canonical,
        so this is exactly the old re-derivation."""
        if variant is None:
            return (0.0,) * self.n_devices
        canonical = self.split(app, variant)
        cur = self.weights.get(app)
        total = sum(cur) if cur else 0.0
        if not cur or total <= 1e-12:
            return canonical
        scale = sum(canonical) / total
        return tuple(w * scale for w in cur)

    def fits_variant(self, app: str, variant: Optional[ModelVariant]
                     ) -> bool:
        """Would swapping ``app``'s committed weights to ``variant`` keep
        every device in budget (admission-path downgrade check)?  The
        projection preserves a migrated layout, so the check validates
        exactly what :meth:`on_load` will commit."""
        if variant is None:
            return True
        cur = self.weights.get(app, (0.0,) * self.n_devices)
        new = self.projected(app, variant)
        return all(self.free_mb(d) + cur[d] >= new[d] - 1e-9
                   for d in range(self.n_devices))

    # -- mutations -------------------------------------------------------
    def on_load(self, app: str, variant: Optional[ModelVariant]) -> None:
        """``MemoryState.load`` observed a (re)load: re-derive the app's
        committed shard footprint — the current layout scaled to the new
        variant (see :meth:`projected`), canonical from cold."""
        if variant is None:
            self.weights.pop(app, None)
        else:
            self.weights[app] = self.projected(app, variant)

    def reserve_inflight(self, app: str, claims: Tuple[float, ...]) -> None:
        """Claim a whole sharded load's per-device footprint at enqueue
        (callers check :meth:`fits` first — an unfundable shard is a
        planning decision, never an assert)."""
        cur = self.inflight.setdefault(app, [0.0] * self.n_devices)
        for d, mb in enumerate(claims):
            if mb < 0:
                raise ValueError(f"negative shard claim: {claims}")
            cur[d] += mb

    def release_inflight_shard(self, app: str, device: int,
                               mb: float) -> None:
        """Return one shard's claim to its device pool (commit converts
        it to weights via :meth:`on_load`; cancel walks shards in device
        order releasing each)."""
        cur = self.inflight.get(app)
        if cur is None:
            return
        cur[device] = max(0.0, cur[device] - mb)
        if all(c <= 1e-12 for c in cur):
            del self.inflight[app]

    def move_shard(self, app: str, src: int, dst: int, mb: float) -> None:
        """Enact one :class:`~repro_torch.core.actions.MigrateShard`: move
        ``mb`` of ``app``'s committed weights from ``src`` to ``dst``.
        The destination must stay in budget — migration is planned, and
        an unfundable move fails the whole plan, never lands partially."""
        cur = list(self.weights.get(app, (0.0,) * self.n_devices))
        if mb < 0 or cur[src] < mb - 1e-9:
            raise A.PlanError(
                f"{app} holds {cur[src]:.2f}MB on device {src}, "
                f"cannot migrate {mb:.2f}MB")
        if self.used_mb(dst) + mb > self.budgets_mb[dst] + 1e-6:
            raise A.PlanError(
                f"device {dst} cannot absorb {mb:.2f}MB of {app} "
                f"({self.used_mb(dst):.2f}/{self.budgets_mb[dst]:.2f}MB)")
        cur[src] -= mb
        cur[dst] += mb
        self.weights[app] = tuple(cur)
        self.shards_migrated += 1

    # -- elastic mesh ----------------------------------------------------
    @property
    def offline_devices(self) -> Tuple[int, ...]:
        return tuple(sorted(self._offline))

    def offline(self, device: int) -> None:
        """Chip loss: the device's budget drops to zero.  Weights and
        claims still homed there are now over budget — the caller (the
        elastic drain planner) owes one plan that vacates them before the
        next :meth:`check_invariant`."""
        if device in self._offline:
            return
        budgets = list(self.budgets_mb)
        self._offline[device] = budgets[device]
        budgets[device] = 0.0
        self.budgets_mb = tuple(budgets)

    def online(self, device: int) -> None:
        """Chip recovery: restore the original budget verbatim."""
        orig = self._offline.pop(device, None)
        if orig is None:
            return
        budgets = list(self.budgets_mb)
        budgets[device] = orig
        self.budgets_mb = tuple(budgets)

    def check_invariant(self) -> None:
        for d in range(self.n_devices):
            if self.used_mb(d) > self.budgets_mb[d] + 1e-6:
                raise AssertionError(
                    f"device {d} over budget: {self.used_mb(d):.2f}MB "
                    f"> {self.budgets_mb[d]:.2f}MB")


@dataclass
class TenantState:
    zoo: ModelZoo
    loaded: Optional[ModelVariant] = None
    kv_mb: float = 0.0  # live KV/decode-cache MB charged to this tenant
    inflight_mb: float = 0.0  # MB claimed by a background load mid-staging
    pool_mb: float = 0.0  # the loaded variant's CUDA-graph pool on the card
    last_request: float = -INF  # time of most recent actual request
    predicted_next: float = INF  # next predicted request time (INF = none)
    requests: int = 0
    unexpected: int = 0  # requests that arrived outside a predicted window

    def window(self, delta: float, theta: float = 0.0) -> Tuple[float, float]:
        """Predicted request window [t−Δ−θ, t+Δ] (paper Fig. 3)."""
        if self.predicted_next is INF:
            return (INF, INF)
        return (self.predicted_next - delta - theta,
                self.predicted_next + delta)


@dataclass
class MemoryState:
    budget_mb: float
    tenants: Dict[str, TenantState] = field(default_factory=dict)
    # Transient planning charge: an admission-in-flight's KV need.  It is
    # subtracted from free_mb so procure policies pick variants that leave
    # room for the cache, but excluded from used_mb/check_invariant — it
    # is a reservation *request*, not committed memory.
    pending_mb: float = 0.0
    # Per-device shard accounting for a sharded mesh (None = single
    # device).  ``load`` keeps it in sync; the global invariant stays the
    # authority here because admission may transiently overshoot a single
    # chip mid-downgrade — per-device limits are enforced at reservation
    # time (sharded loader) and at admission resolution (manager).
    devices: Optional[DeviceLedger] = None
    # Paged KV accounting (None = scalar KV charges).  When installed,
    # ChargeKV/EvictKV actions carrying a ``seq`` allocate and free
    # fixed-size pages through the pool; the MB charge stays on the
    # tenant so the global invariant is unchanged.
    kv_pool: Optional[KVPagePool] = None
    # Clamped over-release drift (satellite of the paging work): MB that
    # EvictKV/release_kv tried to return beyond what the tenant held.
    # Counted always; raises when ``strict_kv`` is set so accounting
    # drift fails tests instead of vanishing into the clamp.
    kv_overrelease_mb: float = 0.0
    strict_kv: bool = False
    # Audit hook: called as on_audit(kind, app, mb) when drift is
    # clamped (suppressed during simulate, which always rolls back).
    on_audit: Optional[Callable[[str, str, float], None]] = None
    _simulating: bool = field(default=False, repr=False)

    @property
    def weights_mb(self) -> float:
        return sum(t.loaded.size_mb for t in self.tenants.values()
                   if t.loaded is not None)

    @property
    def kv_mb(self) -> float:
        return sum(t.kv_mb for t in self.tenants.values())

    @property
    def pool_mb(self) -> float:
        return sum(t.pool_mb for t in self.tenants.values())

    @property
    def inflight_mb(self) -> float:
        """MB claimed by background loads that have not yet committed —
        prefetched weights mid-staging.  Committed memory the instant the
        load lands (``load`` + ``release_inflight``), or returned to the
        pool if the prefetch is cancelled."""
        return sum(t.inflight_mb for t in self.tenants.values())

    @property
    def used_mb(self) -> float:
        """Weights + live KV caches + graph pools: *runtime* memory, not
        just weights."""
        return self.weights_mb + self.kv_mb + self.pool_mb

    @property
    def free_mb(self) -> float:
        return (self.budget_mb - self.used_mb - self.pending_mb
                - self.inflight_mb)

    def loaded_variant(self, app: str) -> Optional[ModelVariant]:
        return self.tenants[app].loaded

    def check_invariant(self) -> None:
        if self.used_mb + self.inflight_mb > self.budget_mb + 1e-6:
            raise AssertionError(
                f"memory invariant violated: {self.used_mb:.1f}MB used "
                f"+ {self.inflight_mb:.1f}MB in-flight "
                f"> {self.budget_mb:.1f}MB budget")
        if self.strict_kv and self.kv_overrelease_mb > 1e-9:
            raise AssertionError(
                f"KV accounting drift: {self.kv_overrelease_mb:.3f}MB "
                f"over-released (strict_kv)")
        if self.kv_pool is not None:
            self.kv_pool.check_invariant()

    # -- mutations (the manager calls these after a policy decision) -------
    def load(self, app: str, variant: Optional[ModelVariant]) -> None:
        self._set_loaded(self.tenants[app], variant)
        if self.devices is not None:
            self.devices.on_load(app, variant)
        self.check_invariant()

    @staticmethod
    def _set_loaded(t: TenantState, variant: Optional[ModelVariant]) -> None:
        """A change of variant drops the graphs of the old one, and the
        pool they kept with them."""
        if variant != t.loaded:
            t.pool_mb = 0.0
        t.loaded = variant

    def charge_pool(self, app: str, mb: float) -> None:
        """Set ``app``'s graph-pool charge to ``mb`` (the pool measured
        after a capture, or an estimate reserved before one).  Callers
        must verify that a rise fits ``free_mb`` first."""
        if mb < 0:
            raise ValueError(f"negative graph-pool charge: {mb}")
        self.tenants[app].pool_mb = mb
        self.check_invariant()

    def reserve_kv(self, app: str, mb: float) -> None:
        """Charge a batch's KV cache to the tenant.  Callers must verify
        ``free_mb >= mb`` first — an over-budget admit is an admission
        decision (downgrade / reject), never an invariant violation."""
        if mb < 0:
            raise ValueError(f"negative KV reservation: {mb}")
        self.tenants[app].kv_mb += mb
        self.check_invariant()

    def release_kv(self, app: str, mb: float) -> None:
        """Return a retired batch's KV memory to the pool.  Over-release
        (more MB than the tenant holds) is clamped but *counted* in
        ``kv_overrelease_mb`` — and raises under ``strict_kv`` — so KV
        accounting drift surfaces instead of silently vanishing."""
        self._drain_kv(app, mb)

    def _drain_kv(self, app: str, mb: float) -> None:
        t = self.tenants[app]
        over = mb - t.kv_mb
        if over > 1e-9:
            self.kv_overrelease_mb += over
            if self.on_audit is not None and not self._simulating:
                self.on_audit("kv_overrelease", app, over)
            if self.strict_kv:
                raise AssertionError(
                    f"KV over-release: {app} returning {mb:.3f}MB while "
                    f"holding {t.kv_mb:.3f}MB ({over:.3f}MB drift)")
        t.kv_mb = max(0.0, t.kv_mb - mb)

    def reserve_inflight(self, app: str, mb: float) -> None:
        """Claim memory for a background load mid-staging.  The charge is
        what the completed load will *add* over the tenant's currently
        loaded variant, so eviction/procurement (which plan against
        ``free_mb``) cannot double-book memory a prefetch already owns.
        Callers must verify ``free_mb >= mb`` first — an unfundable
        prefetch is a planning decision, never an invariant violation."""
        if mb < 0:
            raise ValueError(f"negative in-flight reservation: {mb}")
        self.tenants[app].inflight_mb += mb
        self.check_invariant()

    def release_inflight(self, app: str, mb: float) -> None:
        """A background load committed or was cancelled: return its
        in-flight claim to the pool (commit re-charges it as weights)."""
        t = self.tenants[app]
        t.inflight_mb = max(0.0, t.inflight_mb - mb)

    def in_window(self, app: str, now: float, delta: float,
                  theta: float = 0.0) -> bool:
        lo, hi = self.tenants[app].window(delta, theta)
        return lo <= now <= hi

    def maximalist_set(self, now: float, delta: float) -> Tuple[str, ...]:
        """A*: apps inside their predicted request window."""
        return tuple(a for a in self.tenants
                     if self.in_window(a, now, delta,
                                       self._theta(a)))

    def minimalist_set(self, now: float, delta: float) -> Tuple[str, ...]:
        """A′: apps outside their predicted request window."""
        return tuple(a for a in self.tenants
                     if not self.in_window(a, now, delta, self._theta(a)))

    def _theta(self, app: str) -> float:
        """Load-time overhead θ_i of the app's largest model, in the same
        time units as the simulation (ms)."""
        return self.tenants[app].zoo.largest.load_ms

    def p_unexpected(self, app: str) -> float:
        """Laplace-smoothed P(unexpected request | window) from history."""
        t = self.tenants[app]
        return (t.unexpected + 1.0) / (t.requests + 2.0)

    # ------------------------------------------------------------------
    # The transactional plan applier: the framework's only mutation path
    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def pending(self, mb: float):
        """Scope a transient planning charge: procurement inside the
        block plans around ``mb`` of reserved-but-uncommitted memory
        (a KV need, typically), and the charge always comes back off."""
        self.pending_mb += mb
        try:
            yield self
        finally:
            self.pending_mb -= mb

    def _snapshot(self) -> Tuple[Any, ...]:
        tenants = {a: (t.loaded, t.kv_mb, t.inflight_mb, t.pool_mb)
                   for a, t in self.tenants.items()}
        dev = None
        if self.devices is not None:
            dev = ({a: tuple(w) for a, w in self.devices.weights.items()},
                   {a: list(c) for a, c in self.devices.inflight.items()},
                   self.devices.shards_migrated,
                   self.devices.budgets_mb,
                   dict(self.devices._offline))
        pool = self.kv_pool._snapshot() if self.kv_pool is not None else None
        return tenants, self.pending_mb, dev, pool, self.kv_overrelease_mb

    def _restore(self, snap: Tuple[Any, ...]) -> None:
        tenants, pending, dev, pool, overrelease = snap
        for a, (loaded, kv, inflight, graphs) in tenants.items():
            t = self.tenants[a]
            t.loaded, t.kv_mb, t.inflight_mb = loaded, kv, inflight
            t.pool_mb = graphs
        self.pending_mb = pending
        if dev is not None:
            weights, inflight, migrated, budgets, offline = dev
            self.devices.weights = dict(weights)
            self.devices.inflight = {a: list(c) for a, c in inflight.items()}
            self.devices.shards_migrated = migrated
            self.devices.budgets_mb = budgets
            self.devices._offline = dict(offline)
        if pool is not None:
            self.kv_pool._restore(pool)
        self.kv_overrelease_mb = overrelease

    def simulate(self, plan: "A.ResidencyPlan") -> Optional[str]:
        """Validate a plan without mutating: returns None when every
        action is feasible in sequence (budget and per-device ledgers
        included), else the first failure's reason.  ``simulate`` runs
        the *same* per-action code as :meth:`apply` against a snapshot,
        so a plan that simulates clean is guaranteed to apply."""
        snap = self._snapshot()
        self._simulating = True
        try:
            for act in plan:
                self._apply_action(act)
            return None
        except A.PlanError as e:
            return str(e)
        finally:
            self._simulating = False
            self._restore(snap)

    def apply(self, plan: "A.ResidencyPlan") -> "A.ResidencyPlan":
        """Commit a plan all-or-nothing: actions apply in order, each
        re-validated; the first infeasible action rolls back everything
        already applied (claims released, weights restored) and raises
        :class:`~repro_torch.core.actions.PlanError`.  Returns the plan so
        callers can chain into physical staging."""
        snap = self._snapshot()
        try:
            for act in plan:
                self._apply_action(act)
        except A.PlanError:
            self._restore(snap)
            raise
        return plan

    def _apply_action(self, act: "A.Action") -> None:
        if act.app not in self.tenants:
            raise A.PlanError(f"unknown tenant {act.app!r}")
        t = self.tenants[act.app]
        if isinstance(act, A.Load):
            if act.staged:
                if act.variant != t.loaded:
                    # A load of another variant drops the tenant's graphs
                    # and their pool now (the runtime serves eagerly until
                    # the commit), so the claim is planned against the
                    # memory the pool gave back.
                    t.pool_mb = 0.0
                load = A.concretize_load(act, self)
                if self.free_mb < load.claim_mb - 1e-9:
                    raise A.PlanError(
                        f"staged load {act.app} needs {load.claim_mb:.2f}MB"
                        f" > {self.free_mb:.2f}MB free")
                if load.shard_claims is not None and self.devices is not None:
                    if not self.devices.fits(load.shard_claims):
                        raise A.PlanError(
                            f"staged load {act.app}: a shard does not fit "
                            f"its chip {load.shard_claims}")
                    self.devices.reserve_inflight(act.app, load.shard_claims)
                t.inflight_mb += load.claim_mb
            else:
                # Commit: the claim converts to weights in one
                # transaction (net zero on free_mb for staged loads).
                if act.claim_mb:
                    t.inflight_mb = max(0.0, t.inflight_mb - act.claim_mb)
                if act.shard_claims is not None and self.devices is not None:
                    for d, mb in enumerate(act.shard_claims):
                        self.devices.release_inflight_shard(act.app, d, mb)
                self._set_loaded(t, act.variant)
                if self.devices is not None:
                    self.devices.on_load(act.app, act.variant)
                # Global budget only: an admission load may transiently
                # overshoot one chip mid-downgrade (policies are
                # device-blind); per-device limits are enforced at
                # reservation (staged) and at admission resolution.
                try:
                    self.check_invariant()
                except AssertionError as e:
                    raise A.PlanError(str(e)) from None
        elif isinstance(act, A.Downgrade):
            if t.loaded is not None and \
                    act.variant.size_mb > t.loaded.size_mb + 1e-9:
                raise A.PlanError(
                    f"downgrade {act.app} to {act.variant.size_mb:.2f}MB "
                    f"> loaded {t.loaded.size_mb:.2f}MB")
            if act.in_place:
                # In-place requantization derives the target weights
                # from the resident leaves: there must *be* resident
                # leaves, and only a strictly lower-bits sibling is
                # derivable (int8/int4 from wider — never back up).
                if t.loaded is None:
                    raise A.PlanError(
                        f"in-place downgrade {act.app}: nothing resident")
                if act.variant.bits >= t.loaded.bits:
                    raise A.PlanError(
                        f"in-place downgrade {act.app}: {act.variant.bits}"
                        f"-bit target not below resident "
                        f"{t.loaded.bits}-bit")
            self._set_loaded(t, act.variant)
            if self.devices is not None:
                self.devices.on_load(act.app, act.variant)
        elif isinstance(act, A.Unload):
            self._set_loaded(t, None)
            if self.devices is not None:
                self.devices.on_load(act.app, None)
        elif isinstance(act, A.Shrink):
            if act.release_mb < 0:
                raise A.PlanError(f"negative shrink release: {act}")
            t.inflight_mb = max(0.0, t.inflight_mb - act.release_mb)
        elif isinstance(act, A.CancelPrefetch):
            t.inflight_mb = max(0.0, t.inflight_mb - act.claim_mb)
            if act.shard_claims is not None and self.devices is not None:
                # Device order, shard by shard: the accounting primitive
                # cross-device migration rides.
                for d, mb in enumerate(act.shard_claims):
                    self.devices.release_inflight_shard(act.app, d, mb)
        elif isinstance(act, A.ChargeKV):
            if act.mb < 0:
                raise A.PlanError(f"negative KV reservation: {act.mb}")
            if self.kv_pool is not None and act.seq is not None:
                # Page-granular: allocate fixed-size pages for the
                # sequence (validated against the pool's free lists, per
                # device) and charge the page-rounded footprint.
                n = (act.pages if act.pages is not None
                     else self.kv_pool.pages_for(act.mb))
                self.kv_pool.allocate(act.app, act.seq, n)
                t.kv_mb += n * self.kv_pool.page_mb
            else:
                t.kv_mb += act.mb
            try:
                self.check_invariant()
            except AssertionError as e:
                raise A.PlanError(str(e)) from None
        elif isinstance(act, A.EvictKV):
            try:
                if self.kv_pool is not None and act.seq is not None:
                    freed = self.kv_pool.release(act.app, act.seq)
                    self._drain_kv(act.app, freed * self.kv_pool.page_mb)
                else:
                    self._drain_kv(act.app, act.mb)
            except AssertionError as e:
                raise A.PlanError(str(e)) from None
        elif isinstance(act, A.MigrateShard):
            if self.devices is None:
                raise A.PlanError("MigrateShard without a DeviceLedger")
            self.devices.move_shard(act.app, act.src, act.dst, act.mb)
        else:
            raise A.PlanError(f"unknown action {act!r}")
