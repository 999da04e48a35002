"""Mesh-aware sharded loader: per-shard staging of tenant weights across
a multi-chip edge box, behind the same :class:`LoaderChannel` protocol.

Port of :mod:`repro.serving.sharded_loader`, line for line in its
accounting: the same plans, claims, virtual shard schedules and records,
so a sim run equals the reference's bit for bit.

On a single device the background loader hides one tenant's weight
transfer behind the other tenants' execution.  On a multi-chip box the
transfer itself decomposes: tensor parallelism places a *shard* of every
variant on each chip (``repro_torch.distributed.sharding`` — replicated leaves
included, so a shard is ``weight_shard_fraction``, not ``1/n``), and the
loader stages one shard per device stream.  What that buys, concretely:

* **Per-shard virtual progress.**  The host→device link is shared, so
  shard ``k``'s transfer occupies the virtual slot ``[t + Σ_{j<k} ms_j,
  t + Σ_{j≤k} ms_j]`` — the *total* load time matches the single-stream
  loader (same bytes through the same link; the per-device streams
  overlap only the wall-clock device writes).  But progress is now
  observable per shard: each shard lands at its own schedule point, and
  ``load_overlap_ms`` is measured per shard — a load cancelled with 3 of
  8 shards landed still hid 3 shards of real transfer behind execution,
  and is credited for exactly that (the single-stream loader credits a
  cancelled load nothing).

* **Whole-load claims, per-shard release.**  ``enqueue`` charges the
  load's full marginal footprint once (global ``inflight_mb`` plus one
  claim per device in the :class:`~repro_torch.core.memory_state.DeviceLedger`);
  ``cancel`` walks the shards in device order releasing each claim —
  the accounting a cross-device victim-migration pass will need.

* **Per-device budgets.**  A shard that does not fit on its chip fails
  the whole load *cleanly* (no claims land, ``enqueue`` returns None),
  which routes the tenant through the existing admission downgrade /
  desperation path — exactly how an unfundable single-device load fails.

Physical staging: per-shard ops ride worker-per-device pools (the
"per-chip DMA streams"); the whole-variant commit move rides the base
class's single staging channel, so device mutations keep landing in
accounting order.  The default per-shard op is a no-op hook, and the
per-device workers touch no CUDA state: ``TenantRuntime.set_variant``
moves whole variants at commit, on the card through the base channel's
pinned host → copy-stream path.  The mesh is logical: the port places no
tensor-parallel shards across cards (ROADMAP A13).
"""
from __future__ import annotations

import dataclasses
import math
from concurrent.futures import CancelledError, Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from repro_torch.core import actions as A
from repro_torch.core.model_zoo import ModelVariant
from repro_torch.serving.loader import (ActionHook, BackgroundLoader,
                                  InflightLoad, LoadRecord)

INF = math.inf

# (app, variant_or_None, device, n_devices) — the per-device stream op.
ShardStageFn = Callable[[str, Optional[ModelVariant], int, int], None]


@dataclass
class ShardStage:
    """One device's slice of an in-flight sharded load."""
    device: int
    mb: float  # resident MB this shard adds on its device
    claim_mb: float  # per-device in-flight claim (marginal over loaded)
    global_mb: float  # this shard's slice of the global inflight charge
    load_ms: float  # virtual transfer time of this shard
    t_start_ms: float  # when this shard's slot on the host link opens
    ready_ms: float  # t_start + load_ms
    landed: bool = False
    future: Optional[Future] = None  # the wall-clock per-device stream op


@dataclass
class ShardedInflightLoad(InflightLoad):
    """An :class:`InflightLoad` decomposed into per-device shard stages
    (``ready_ms`` is the last shard's landing)."""
    shards: List[ShardStage] = field(default_factory=list)

    @property
    def cancelled(self) -> bool:
        """Gates the commit move on the staging channel (read from the
        worker thread; the action-record state machine is the truth)."""
        return self.state == "cancelled"

    @property
    def shard_claims(self) -> Tuple[float, ...]:
        return tuple(sh.claim_mb for sh in self.shards)


class ShardedLoaderChannel(BackgroundLoader):
    """Stages tenant weights shard-by-shard across a device mesh.

    Drop-in :class:`LoaderChannel`: the engine drives it exactly like
    :class:`BackgroundLoader`.  ``shard_fn(app, variant)`` maps a variant
    to per-device resident MB; it defaults to the manager state's
    :class:`DeviceLedger` split (when one is installed) or an even
    ``1/n`` split.  ``stage_shard_fn`` is the per-device stream op.

    ``migrate=True`` (default) arms **cross-device victim migration**:
    when one chip's ledger budget blocks a load while neighbors have
    room, :func:`repro_torch.core.actions.plan_migration` emits
    ``MigrateShard`` actions that move a resident victim's shards to the
    free chips, and the whole group — moves, evictions, staged load —
    commits as one atomic plan instead of failing the load into the
    downgrade path.  ``migrate=False`` keeps the plain behaviour (one
    overfull chip fails the whole load cleanly).
    """

    def __init__(self, manager, n_devices: int = 8, *,
                 stage_fn=None,
                 shard_fn: Optional[Callable[
                     [str, ModelVariant], Tuple[float, ...]]] = None,
                 stage_shard_fn: Optional[ShardStageFn] = None,
                 migrate: bool = True,
                 compress: Optional[str] = None,
                 graphs_fn: Optional[Callable[[str, bool], None]] = None):
        if n_devices < 1:
            raise ValueError(f"n_devices must be >= 1, got {n_devices}")
        super().__init__(manager, stage_fn=stage_fn, compress=compress,
                         graphs_fn=graphs_fn)
        self.n_devices = n_devices
        self.migrate = migrate
        self._shard_fn = shard_fn
        self._stage_shard_fn = stage_shard_fn or (
            lambda app, variant, device, n: None)
        self._device_pools = [
            ThreadPoolExecutor(max_workers=1,
                               thread_name_prefix=f"shard-dev{d}")
            for d in range(n_devices)]
        # Landed shards of cancelled loads, queued for the engine's
        # overlap measurement at the next reap (their transfer was real
        # and really was hidden — the honest half of a wasted prefetch).
        self._partials: List[LoadRecord] = []
        # Shard schedules built at concretize time, carried to _perform
        # keyed by the concrete Load action (one execute() at a time on
        # the engine thread; cleared after every execute).
        self._staged_shards: dict = {}
        self.shards_landed = 0

    def execute(self, rplan: A.ResidencyPlan, now_ms: float, *,
                demand: bool = False, predicted_ms: float = INF,
                on_action: Optional[ActionHook] = None):
        try:
            return super().execute(rplan, now_ms, demand=demand,
                                   predicted_ms=predicted_ms,
                                   on_action=on_action)
        finally:
            self._staged_shards.clear()  # drop leftovers of failed plans

    # -- shard geometry --------------------------------------------------
    def _split_mb(self, app: str, variant: Optional[ModelVariant]
                  ) -> Tuple[float, ...]:
        if variant is None:
            return (0.0,) * self.n_devices
        ledger = self.manager.state.devices
        if self._shard_fn is not None:
            return tuple(self._shard_fn(app, variant))
        if ledger is not None:
            return ledger.split(app, variant)
        return tuple(variant.size_mb / self.n_devices
                     for _ in range(self.n_devices))

    def _build_shards(self, app: str, variant: ModelVariant,
                      now_ms: float, charge_mb: float
                      ) -> List[ShardStage]:
        """Decompose one load: per-device resident MB and claims, plus
        the shared-host-link virtual schedule (cumulative slots summing
        to exactly ``variant.load_ms``).  With a ledger installed the
        target layout is the *projection* of the tenant's actual
        holdings (a migrated layout persists through the reload) and the
        claims are marginal over those holdings — so the reserve checks
        validate exactly what the commit will place per chip."""
        loaded = self.manager.state.tenants[app].loaded
        ledger = self.manager.state.devices
        if ledger is not None and self._shard_fn is None:
            shards_mb = ledger.projected(app, variant)
            cur_mb = ledger.held(app, loaded)
        else:
            shards_mb = self._split_mb(app, variant)
            cur_mb = self._split_mb(app, loaded)
        total = sum(shards_mb)
        # Shared host link: the cumulative slots sum to exactly the
        # *wire* transfer time (compressed bytes under compress="int8").
        wire_ms = self._wire_ms(variant)
        out: List[ShardStage] = []
        t_cursor, global_left = now_ms, charge_mb
        for d, mb in enumerate(shards_mb):
            frac = mb / total if total else 0.0
            ms = wire_ms * frac
            gmb = (global_left if d == self.n_devices - 1
                   else charge_mb * frac)
            global_left -= gmb
            out.append(ShardStage(
                device=d, mb=mb,
                claim_mb=max(0.0, mb - cur_mb[d]),
                global_mb=gmb, load_ms=ms,
                t_start_ms=t_cursor, ready_ms=t_cursor + ms))
            t_cursor += ms
        return out

    def _dispatch(self, app: str, variant: ModelVariant,
                  shards: List[ShardStage],
                  ld: "ShardedInflightLoad") -> Future:
        """Queue the per-device stream ops and the gated whole-variant
        commit move (same single staging channel as every other device
        mutation, so commits land in accounting order)."""
        for sh in shards:
            sh.future = self._device_pools[sh.device].submit(
                self._stage_shard_fn, app, variant, sh.device,
                self.n_devices)

        def commit_move():
            for sh in shards:
                try:
                    if sh.future is not None:
                        sh.future.result()
                except CancelledError:
                    pass
            if not ld.cancelled:
                self._stage_fn(app, variant)

        return self._pool.submit(commit_move)

    def _track_load(self, app: str, variant: ModelVariant, now_ms: float,
                    charge: float, shards: List[ShardStage], *,
                    demand: bool, predicted_ms: float,
                    on_action: Optional[ActionHook] = None
                    ) -> ShardedInflightLoad:
        """Track an already-*applied* staged load (claims reserved by the
        plan applier) and dispatch its shard stages."""
        ld = ShardedInflightLoad(
            app=app, variant=variant, t_enqueue_ms=now_ms,
            ready_ms=shards[-1].ready_ms if shards else now_ms,
            charge_mb=charge, demand=demand, predicted_ms=predicted_ms,
            future=None, shards=shards, on_action=on_action)
        ld.future = self._dispatch(app, variant, shards, ld)
        self.inflight[app] = ld
        self._ready.push(ld.ready_ms, (app, ld))
        return ld

    # -- plan translation -------------------------------------------------
    def _concretize(self, rplan: A.ResidencyPlan, now_ms: float
                    ) -> Optional[A.ResidencyPlan]:
        """Resolve staged loads to concrete per-device shard claims; when
        a chip's budget blocks the plan and migration is armed, prepend
        the :func:`~repro_torch.core.actions.plan_migration` moves so the whole
        group commits atomically.  Returns None when the plan is a no-op
        or remains unfundable — the tenant then rides the existing
        admission downgrade/desperation path, as an unfundable load does."""
        rplan = super()._concretize(rplan, now_ms)
        if rplan is None:
            return None
        state = self.manager.state
        acts, load = [], None
        for act in rplan:
            if isinstance(act, A.Load) and act.staged:
                shards = self._build_shards(act.app, act.variant, now_ms,
                                            act.claim_mb)
                act = dataclasses.replace(
                    act, shard_claims=tuple(sh.claim_mb for sh in shards))
                self._staged_shards[id(act)] = shards
                load = act
            acts.append(act)
        out = A.ResidencyPlan(tuple(acts))
        if state.simulate(out) is None:
            return out
        if not self.migrate or load is None or state.devices is None:
            return None
        # One chip over budget while neighbors idle: move a resident
        # victim's shards to the free chips instead of failing the load.
        # Victims the plan itself evicts are pinned (their downgrade
        # re-derives the canonical split, which would undo the move).
        evicted = tuple(a.app for a in out
                        if isinstance(a, (A.Unload, A.Downgrade)))
        moves = A.plan_migration(state, load.app, load.shard_claims,
                                 exclude=evicted)
        if moves is None:
            return None
        out = A.ResidencyPlan(moves + out.actions)
        return out if state.simulate(out) is None else None

    def _perform(self, act: A.Action, now_ms: float, *, demand: bool,
                 predicted_ms: float,
                 on_action: Optional[ActionHook]
                 ) -> Optional[ShardedInflightLoad]:
        if isinstance(act, A.Load) and act.staged:
            # The schedule built at concretize time (pre-apply holdings)
            # — its claims are exactly what the applier reserved.
            shards = self._staged_shards.pop(id(act), None)
            if shards is None:  # direct _perform use (tests/tools)
                shards = self._build_shards(act.app, act.variant, now_ms,
                                            act.claim_mb)
                for sh, claim in zip(shards, act.shard_claims or ()):
                    sh.claim_mb = claim
            ld = self._track_load(act.app, act.variant, now_ms,
                                  act.claim_mb, shards, demand=demand,
                                  predicted_ms=predicted_ms,
                                  on_action=on_action)
            self.wire_mb_staged += (act.variant.size_mb
                                    * self.wire_ratio(act.variant))
            if demand:
                self.demand_loads += 1
            self._emit(now_ms, "demand" if demand else "prefetch",
                       act.app, act.claim_mb)
            return ld
        if isinstance(act, A.MigrateShard):
            # Physical per-device streams: re-stage the victim's shard
            # on both chips (a no-op for the default hook; the
            # commit-time whole-variant move already converges).
            loaded = self.manager.state.tenants[act.app].loaded
            for dev in (act.src, act.dst):
                self._device_pools[dev].submit(
                    self._stage_shard_fn, act.app, loaded, dev,
                    self.n_devices)
            self._emit(now_ms, "migrate", act.app, act.mb)
            if on_action is not None:
                on_action(act, now_ms)
            return None
        return super()._perform(act, now_ms, demand=demand,
                                predicted_ms=predicted_ms,
                                on_action=on_action)

    def earliest_ready(self) -> float:
        """The next *commit* (last shard of the soonest-completing load)
        — deliberately the same wake semantics as the single-stream
        loader: nothing is actionable at an intermediate shard landing,
        and waking the engine there would shift prefetch enqueue times
        off the single-stream schedule (the A/B must differ only in the
        staging accounting).  Shard landings themselves are timestamped
        from the virtual schedule, so reaping them lazily at the next
        natural wake is exact.  A commit's ``ready_ms`` is fixed at
        track time (shrinks retire the old record and track a new one),
        so the base class's readiness heap covers this channel with the
        same validity predicate."""
        if self.indexed_ready:
            return self._ready.peek(self._ready_live)
        return min((ld.ready_ms for ld in self.inflight.values()),
                   default=INF)

    def reap(self, now_ms: float) -> List[LoadRecord]:
        """Land every shard whose virtual slot has passed; commit loads
        whose last shard landed.  Also drains the partial records of
        cancelled loads so the engine credits their landed shards'
        overlap."""
        out: List[LoadRecord] = self._partials
        self._partials = []
        state = self.manager.state
        for app in list(self.inflight):
            ld = self.inflight[app]
            for sh in ld.shards:
                if not sh.landed and sh.ready_ms <= now_ms:
                    sh.landed = True
                    self.shards_landed += 1
            if not all(sh.landed for sh in ld.shards):
                continue
            if not ld.staging:  # a stale record cannot commit twice
                del self.inflight[app]
                continue
            del self.inflight[app]
            ld.future.result()  # wall-clock commit move absorbed here
            # Claims convert to committed weights in one transaction;
            # the applier walks the shard claims in device order.
            commit = A.Load(app, ld.variant, claim_mb=ld.charge_mb,
                            shard_claims=ld.shard_claims)
            state.apply(A.ResidencyPlan((commit,)))
            self._graphs_fn(app, False)
            ld.state = "committed"
            rec = LoadRecord(
                app=app, bits=ld.variant.bits,
                # Sum of the shard slots = the wire transfer time.
                load_ms=sum(sh.load_ms for sh in ld.shards),
                t_enqueue_ms=ld.t_enqueue_ms, t_ready_ms=ld.ready_ms,
                demand=ld.demand,
                shard_intervals=tuple(
                    (sh.t_start_ms, sh.ready_ms, sh.load_ms)
                    for sh in ld.shards),
                overlap_busy=ld.ol_take())
            self._committed[app] = rec
            self.history.append(rec)
            self.loads_committed += 1
            self._emit(ld.ready_ms, "load", app, ld.variant.size_mb)
            if ld.on_action is not None:
                ld.on_action(commit, ld.ready_ms)
            out.append(rec)
        return out

    def _release_load(self, ld: ShardedInflightLoad) -> bool:
        """Release a load's claims (shard-by-shard, device order, via the
        plan applier) and restore any device whose stream op already
        ran.  Guarded by the action-record state machine: a record that
        already committed or cancelled — e.g. the old record of a shrink
        whose shards are mid-release — returns False and releases
        *nothing*, so the claims now owned by the replacement load can
        never be double-released."""
        if not ld.staging:
            return False
        ld.state = "cancelled"  # one-way, before any release lands
        state = self.manager.state
        state.apply(A.ResidencyPlan((
            A.CancelPrefetch(ld.app, ld.charge_mb, ld.shard_claims),)))
        loaded = state.tenants[ld.app].loaded
        for sh in ld.shards:
            if sh.future is not None and not sh.future.cancel():
                self._device_pools[sh.device].submit(
                    self._stage_shard_fn, ld.app, loaded, sh.device,
                    self.n_devices)
        if not ld.future.cancel():
            # The commit move may already be past its gate: queue a
            # whole-variant restore behind it on the staging channel.
            self.stage(ld.app, loaded)
        return True

    def _queue_partial(self, ld: ShardedInflightLoad) -> None:
        """Queue the honest credit for an abandoned load: its landed
        shards' transfer really was hidden, so a partial record goes to
        the engine's next reap for overlap measurement."""
        landed = [sh for sh in ld.shards if sh.landed]
        if landed:
            # The online busy values ride along, filtered to the landed
            # shards so they stay parallel to the record's intervals.
            busy = ld.ol_take()
            if busy is not None:
                busy = tuple(b for sh, b in zip(ld.shards, busy)
                             if sh.landed)
            self._partials.append(LoadRecord(
                app=ld.app, bits=ld.variant.bits,
                load_ms=sum(sh.load_ms for sh in landed),
                t_enqueue_ms=ld.t_enqueue_ms,
                t_ready_ms=max(sh.ready_ms for sh in landed),
                demand=ld.demand,
                shard_intervals=tuple(
                    (sh.t_start_ms, sh.ready_ms, sh.load_ms)
                    for sh in landed),
                partial=True,
                overlap_busy=busy))

    def _retire_load(self, ld: ShardedInflightLoad) -> bool:
        """Release an abandoned load and queue its partial credit; False
        (and no release) when the record already left ``staging``."""
        if not self._release_load(ld):
            return False
        self._queue_partial(ld)
        return True

    def cancel(self, app: str,
               now_ms: float) -> Optional[ShardedInflightLoad]:
        """Release the claim shard-by-shard and restore the device; the
        landed shards' transfer still counts toward ``load_overlap_ms``
        (queued for the engine's next reap)."""
        ld = self.inflight.pop(app, None)
        if ld is None or not self._retire_load(ld):
            return None
        self._graphs_fn(app, False)
        self.prefetch_wasted += 1
        self._emit(now_ms, "cancel", app, -ld.charge_mb)
        return ld

    def shrink_inflight(self, app: str, variant: Optional[ModelVariant],
                        now_ms: float
                        ) -> Optional[ShardedInflightLoad]:
        """Sharded shrink: one atomic plan releases the old shard claims
        and reserves the smaller variant's, then the smaller transfer
        restages from ``now`` under a fresh in-flight record (the old
        record leaves ``staging`` first, so no stale path can release
        the new record's claims).  The landed shards' overlap is still
        credited via a partial record."""
        ld = self.inflight.get(app)
        if ld is None or ld.demand or variant is None or not ld.staging:
            return None
        if variant.size_mb >= ld.variant.size_mb:
            return None
        state = self.manager.state
        loaded = state.tenants[app].loaded
        new_charge = variant.size_mb - (loaded.size_mb if loaded else 0.0)
        if new_charge <= 0.0:
            return None  # below residency: that is a cancel, not a shrink
        del self.inflight[app]
        shards = self._build_shards(app, variant, now_ms, new_charge)
        ld.state = "cancelled"  # before the claims move: one-way
        # Release-then-reserve in one transaction — the shrunk claims
        # always fit (strictly less on the same devices), and a failure
        # anywhere would roll the whole exchange back.
        state.apply(A.ResidencyPlan((
            A.CancelPrefetch(app, ld.charge_mb, ld.shard_claims),
            A.Load(app, variant, staged=True, claim_mb=new_charge,
                   shard_claims=tuple(sh.claim_mb for sh in shards)),
        )))
        for sh in ld.shards:
            if sh.future is not None:
                sh.future.cancel()
        ld.future.cancel()
        self._queue_partial(ld)
        new_ld = self._track_load(app, variant, now_ms, new_charge,
                                  shards, demand=ld.demand,
                                  predicted_ms=ld.predicted_ms,
                                  on_action=ld.on_action)
        self.wire_mb_staged += (variant.size_mb
                                * self.wire_ratio(variant))
        self.prefetch_shrunk += 1
        self._emit(now_ms, "shrink", app, -(ld.charge_mb - new_charge))
        return new_ld

    def stage_shards_sync(self, app: str,
                          variant: Optional[ModelVariant]) -> None:
        """Run one whole variant's per-device stream ops concurrently and
        wait them out — the wall-clock shape of a sharded admission-path
        load (and what ``benchmarks.perf_compare`` measures against
        single-stream staging)."""
        futs = [self._device_pools[d].submit(
                    self._stage_shard_fn, app, variant, d, self.n_devices)
                for d in range(self.n_devices)]
        for f in futs:
            f.result()

    def close(self) -> None:
        super().close()
        for pool in self._device_pools:
            pool.shutdown(wait=True)
