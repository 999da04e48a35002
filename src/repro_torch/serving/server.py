"""Multi-tenant serving runtime: Edge-MultiAI managing *real* PyTorch models.

Port of :mod:`repro.serving.server`.  Each tenant is an LM architecture
with a real zoo (bf16 / int8 / int4 variants built by
``repro_torch.quant``), "storage" is pinned host memory, "memory" is the
device budget tracked in MB of true buffer bytes, and load/evict callbacks
copy weights host→device.  The manager decides *which variant is resident
when*; serving runs true prefill/decode steps with whatever is loaded
(quantized variants run through the fused dequant matmul kernel).

On the card a batch without extra inputs runs as one CUDA graph, the
counterpart of the reference's one jitted program per batch shape: the
first call of a (variant, batch, prompt length, new tokens) key runs the
loop eagerly (a key seen once is never worth a capture), the second
captures prefill and the whole greedy decode, every later call copies its
prompts in and replays.  A tenant's graphs share one private memory pool,
and they and the pool go with the variant they read; it keeps the
``MAX_GRAPHS`` last replayed.  The pool is memory on the card, so a
runtime served by the engine charges it to the tenant: before a capture
it reserves the key's eager peak, after it the measured pool; when the
budget has no room for the growth the batch runs eagerly instead.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import actions as RA
from repro_torch.core.manager import EdgeMultiAI
from repro_torch.core.policies import Policy
from repro_torch.core.model_zoo import ModelVariant, ModelZoo
from repro_torch.core.predictor import RequestPredictor
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.quant.quantize import (params_nbytes, quantize_params,
                                        tree_map)

MB = 1024 * 1024


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  Asking for CUDA where there is
    no card raises: the port never carries on on the CPU instead."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was asked for, but no CUDA "
                           "device is available")
    return device


def _generate_tokens(cfg: ModelConfig, params, prompts: torch.Tensor, *,
                     max_new: int, max_len: int,
                     extra: Optional[dict] = None) -> torch.Tensor:
    """Greedy decode: prefill, then ``max_new − 1`` decode steps, eagerly
    (the cache is allocated once at ``max_len`` and written in place).

    Every cache leaf keeps the type prefill gave it, as the reference's
    loop casts its carry: ``decode_step`` stores into the cache in place,
    so the Mamba-2 conv buffer, for one, stays in the cache's bf16 although
    an 8-bit variant's decode produces it in f32."""
    batch = {"tokens": prompts, **(extra or {})}
    logits, cache = T.prefill(cfg, params, batch, max_len=max_len)
    toks = [T.greedy_token(cfg, logits)]
    for _ in range(max_new - 1):
        logits, cache = T.decode_step(cfg, params, cache, toks[-1])
        toks.append(T.greedy_token(cfg, logits))
    return torch.stack(toks, dim=1)


# One capture at a time in the process (PyTorch's rule for graph capture),
# and no pool freed or graph destroyed while one runs: the caching
# allocator frees no memory during a capture.
_CAPTURE_LOCK = threading.Lock()
_capture_streams: Dict[torch.device, "torch.cuda.Stream"] = {}

# Graphs a tenant keeps, the least recently replayed dropped first: each
# holds 12-26 k nodes at full width, and a trace whose prompt lengths vary
# makes a key per length.
MAX_GRAPHS = 16
# Keys a tenant remembers having run once (with their eager peak), the
# oldest forgotten first.
MAX_SEEN = 64


def pool_bytes(pool) -> int:
    """Device bytes the caching allocator holds for graph pool ``pool``."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool))


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    stream = _capture_streams.get(device)
    if stream is None:
        stream = _capture_streams[device] = torch.cuda.Stream(device)
    return stream


def on_capture_stream(fn, device: torch.device):
    """``fn()`` run eagerly on the shared capture stream, after the work
    queued on the current stream and before any queued after it: a key's
    first call, whose one-time set-up (shared-memory limits, cuBLAS's
    workspace for that stream) a later capture of the key then finds
    done."""
    with _CAPTURE_LOCK:
        stream = _capture_stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            out = fn()
        torch.cuda.current_stream(device).wait_stream(stream)
    return out


def capture(fn, device: torch.device, pool, warm_up: bool = True):
    """Capture ``fn()`` into one CUDA graph whose allocations come from
    ``pool``; returns (graph, ``fn``'s output, which every replay
    rewrites in place).

    With ``warm_up``, ``fn`` runs once eagerly on the capture stream
    first, as PyTorch's graph notes ask: the kernels' one-time set-up
    (shared-memory limits, cuBLAS's workspace for that stream) happens
    outside the graph.  Captures in ``thread_local`` mode, so that the
    loader's thread may allocate and copy meanwhile, and without
    ``torch.cuda.graph``'s ``empty_cache`` before each capture.  A launch
    that fails raises, and no graph is returned."""
    with _CAPTURE_LOCK:
        stream = _capture_stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            if warm_up:
                fn()
            graph.capture_begin(pool, capture_error_mode="thread_local")
            try:
                out = fn()
            finally:
                graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(stream)
    return graph, out


@dataclass
class _Graph:
    """One captured ``generate``: its static prompt buffer and tokens, and
    the params tree the graph reads (kept alive as long as the graph)."""
    graph: Any
    prompts: torch.Tensor
    tokens: torch.Tensor
    params: Any


@dataclass
class ServeResult:
    app: str
    tokens: np.ndarray
    warm: bool
    failed: bool
    bits: Optional[int]
    latency_s: float
    redispatched: bool = False


class TenantRuntime:
    """One application: config + host-side zoo + device-side loaded params.

    The production implementation of the engine's ``TenantExecutor``
    protocol — :meth:`execute` runs the real prefill+decode and is timed
    by wall clock (it returns no virtual service time).

    The zoo is quantized from ``params`` on whatever device they lie on
    (the card, for a full-width model: it spares the host the f32 copy)
    and kept on the host, pinned when the runtime serves from a card."""

    def __init__(self, name: str, cfg: ModelConfig, params,
                 precisions: Tuple[int, ...] = (16, 8),
                 predictor: Optional[RequestPredictor] = None,
                 device="cuda"):
        self.name = name
        self.cfg = cfg
        self.device = resolve_device(device)
        pin = self.device.type == "cuda"
        # Host "storage": every zoo variant, kept off-device.
        self.host: Dict[int, Any] = {}
        sizes: Dict[int, float] = {}
        for bits in precisions:
            variant = quantize_params(params, bits=bits, group=32)
            self.host[bits] = tree_map(
                lambda _, t: t.cpu().pin_memory() if pin else t.cpu(),
                variant)
            sizes[bits] = params_nbytes(variant) / MB
            del variant
        self.zoo = ModelZoo(
            app_name=name,
            variants=tuple(
                ModelVariant(
                    name=f"{name}-{b}bit", bits=b, size_mb=sizes[b],
                    accuracy={16: 100.0, 8: 97.0, 4: 85.0}.get(b, 90.0),
                    load_ms=max(sizes[b], 0.01))
                for b in precisions))
        self.device_params: Optional[Any] = None
        self.loaded_bits: Optional[int] = None
        self.predictor = predictor or RequestPredictor(context=8, hidden=16)
        self._copy_stream = (torch.cuda.Stream(self.device) if pin
                             else None)
        # CUDA graphs of the loaded variant, keyed as the reference's jit
        # is: (bits, batch, prompt length, new tokens, cache length), the
        # least recently replayed first; the keys run so far, with their
        # eager peak (MB), kept across variant swaps (a key names its
        # variant's bits); whether the loaded variant has run eagerly on
        # the capture stream; the private pool the graphs share, and the
        # MB of it charged; how many were captured and replayed.  The
        # lock is held across a capture or a replay and its readback, and
        # across a variant swap, so neither frees what the other uses.
        self._graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()
        self._seen: "OrderedDict[tuple, float]" = OrderedDict()
        self._warm = False
        self._held = False  # a staged load of another variant: no graphs
        self.pool = None
        self.pool_mb = 0.0
        self.captures = 0
        self.replays = 0
        self._lock = threading.Lock()
        # Set by the serving engine: ``pool_ledger(mb)`` sets the tenant's
        # charged pool to ``mb`` MB, or returns False when a rise does not
        # fit the budget.  None (a runtime used on its own): no charge.
        self.pool_ledger = None

    # -- loader callback target -------------------------------------------
    def set_variant(self, variant: Optional[ModelVariant]) -> None:
        """Stage a variant host→device (on the loader's worker thread).

        The copies run on a stream of their own, after the work already
        queued on the device's default stream, and the stream is
        synchronized before the new params are published: ``generate``
        on the serving thread never reads a tensor whose copy is still in
        flight.  Publishing drops the graphs of the old variant, and their
        pool's memory goes back to the card."""
        if variant is not None and variant.bits == self.loaded_bits:
            return
        params = None
        if variant is not None:
            host_tree = self.host[variant.bits]
            stream = self._copy_stream
            if stream is None:
                params = tree_map(lambda _, t: t.to(self.device), host_tree)
            else:
                stream.wait_stream(torch.cuda.default_stream(self.device))
                with torch.cuda.stream(stream):
                    params = tree_map(
                        lambda _, t: t.to(self.device, non_blocking=True),
                        host_tree)
                stream.synchronize()
        with self._lock:
            self.device_params = params
            self.loaded_bits = None if variant is None else variant.bits
            self._warm = False
            # The engine's ledger clears the charge with the variant.
            self.pool_mb = 0.0
            self._drop_graphs()

    def hold_graphs(self, hold: bool) -> None:
        """The loader's call when a load of another variant is staged
        (``hold``): drop every graph and give the pool back to the card
        now, as the ledger drops its charge, and serve eagerly until the
        load commits or is cancelled (``hold`` False)."""
        with self._lock:
            self._held = hold
            if hold:
                self.pool_mb = 0.0
                self._drop_graphs()

    def reshard_device_params(self) -> None:
        """Elastic recovery hook: re-place the resident variant's buffers
        after the ledger's layout changed.  A no-op: the port serves a
        logical mesh from one card and places no shards across cards
        (``EdgeServer._attach_physical_mesh``)."""

    def _drop_graphs(self) -> None:
        """Drop every graph and give the pool back to the card (the old
        params go with their graphs).  Under the runtime's lock."""
        pool, self.pool = self.pool, None
        graphs, self._graphs = self._graphs, OrderedDict()
        if pool is not None:
            with _CAPTURE_LOCK:
                del graphs
                torch.cuda.empty_cache()

    def generate(self, prompts: np.ndarray, max_new: int,
                 extra: Optional[dict] = None) -> np.ndarray:
        """Greedy-decode ``max_new`` tokens for a batch of prompts.

        On the card a batch without extras replays its key's CUDA graph,
        captured at the key's second call (the first runs eagerly on the
        capture stream; a call whose pool growth the budget cannot take
        also runs eagerly); the CPU, and a batch with extra modality
        inputs (as in the reference), run the eager loop.  Returns host
        numpy, which waits for the device: the engine's wall-clock
        service time covers the whole computation."""
        with self._lock, torch.inference_mode():
            assert self.device_params is not None, f"{self.name}: not loaded"
            params = self.device_params
            dev = self.device
            S = prompts.shape[1]

            def run() -> np.ndarray:  # the eager loop
                extra_t = ({k: torch.as_tensor(v, device=dev)
                            for k, v in extra.items()} if extra else None)
                return _generate_tokens(
                    self.cfg, params, torch.as_tensor(prompts, device=dev),
                    max_new=max_new, max_len=S + max_new,
                    extra=extra_t).cpu().numpy()

            if dev.type != "cuda" or extra or self._held:
                return run()
            key = (self.loaded_bits, prompts.shape[0], S, max_new,
                   S + max_new)
            g = self._graphs.get(key)
            if g is None and key in self._seen:
                g = self._capture(key, params, prompts)
            if g is not None:
                self._graphs.move_to_end(key)
                g.prompts.copy_(torch.as_tensor(prompts))
                g.graph.replay()
                self.replays += 1
                return g.tokens.cpu().numpy()
            if key in self._seen:  # no room for the pool's growth
                return run()
            # The key's first call: eager, on the capture stream, its peak
            # allocation above the level before it kept as the estimate a
            # capture of the key reserves (the graph allocates what the
            # eager run did, up to the allocator's rounding, which the
            # true-up after the capture settles).
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            toks = on_capture_stream(run, dev)
            self._warm = True
            self._seen[key] = (torch.cuda.max_memory_allocated(dev)
                               - base) / MB
            if len(self._seen) > MAX_SEEN:
                self._seen.popitem(last=False)
            return toks

    def _charge(self, mb: float) -> bool:
        """Set the pool's charge to ``mb`` MB through the engine's ledger
        (always, for a runtime used on its own); False when a rise does
        not fit."""
        if self.pool_ledger is not None and not self.pool_ledger(mb):
            return False
        self.pool_mb = mb
        return True

    def _capture(self, key: tuple, params,
                 prompts: np.ndarray) -> Optional[_Graph]:
        """Capture ``_generate_tokens`` for ``key`` over a static prompt
        buffer holding ``prompts``, in the runtime's pool, with the key's
        eager peak reserved for the pool's growth beforehand and the
        charge trued up to the measured pool afterwards.  Returns None,
        having captured nothing, when the reservation does not fit; drops
        every graph and returns None when the measured pool does not fit.
        Drops the least recently replayed graph past ``MAX_GRAPHS``.  A
        variant that has not run on the capture stream since it was
        loaded (the key's first call was made with an earlier load) runs
        the loop there once eagerly first, so that the kernels' set-up
        for its weights happens outside the graph."""
        if not self._charge(self.pool_mb + self._seen[key]):
            return None
        *_, max_new, max_len = key
        static = torch.as_tensor(prompts, dtype=torch.int32).to(self.device)
        pool = (torch.cuda.graph_pool_handle() if self.pool is None
                else self.pool)
        if len(self._graphs) >= MAX_GRAPHS:
            with _CAPTURE_LOCK:
                self._graphs.popitem(last=False)
        try:
            graph, tokens = capture(
                lambda: _generate_tokens(self.cfg, params, static,
                                         max_new=max_new, max_len=max_len),
                self.device, pool, warm_up=not self._warm)
            self._warm = True
        except BaseException:
            self._true_up()
            raise
        self.pool = pool
        self._graphs[key] = g = _Graph(graph, static, tokens, params)
        self.captures += 1
        return g if self._true_up() else None

    def _true_up(self) -> bool:
        """Charge the pool as measured; where its growth past the
        reservation does not fit, drop every graph (the pool goes back to
        the card) and charge nothing.  False in that case."""
        held = pool_bytes(self.pool) / MB if self.pool is not None else 0.0
        if self._charge(held):
            return True
        self._drop_graphs()
        self._charge(0.0)
        return False

    # -- TenantExecutor protocol ------------------------------------------
    def execute(self, batch, extra: Optional[dict] = None
                ) -> Tuple[np.ndarray, Optional[float]]:
        """Run one batch; wall-clock timed (no virtual service time)."""
        return self.generate(batch.prompts, batch.max_new, extra), None


class EdgeServer:
    """The end-to-end system: Edge-MultiAI + real tenants + batching.

    This object is the *tenant registry and facade* (the engine's
    ``ServingHost``): ``serve()`` keeps its one-call API but delegates
    every admit/execute/retire cycle to the :class:`ServingEngine`, which
    also charges each batch's KV cache against the memory budget.

    The declarative front door is :meth:`build` — one call that resolves
    a :class:`~repro_torch.serving.api.ServingConfig` into a fully wired,
    started server (tenants registered, policy resolved through the
    registry, loader and engine attached, budget derived).  The
    imperative ``__init__`` / ``register`` / ``start`` path underneath
    stays public for callers that need custom params or executors.
    """

    def __init__(self, budget_mb: float, policy="iws-bfe",
                 delta_ms: float = 500.0, straggler_deadline_s: float = 30.0,
                 max_batch: int = 8, batch_window_ms: float = 0.0,
                 prefetch: bool = True, history_ms: float = 3000.0,
                 fallback="desperation",
                 sharded_mesh: Optional[Tuple[int, ...]] = None,
                 device_budget_mb: "Optional[float | Tuple[float, ...]]"
                 = None,
                 migrate: bool = True,
                 compress: Optional[str] = None,
                 adaptive_delta: bool = False,
                 continuous: bool = False,
                 kv_page_mb: float = 0.0,
                 fault=None,
                 audit: str = "full",
                 scheduler: str = "indexed",
                 device="cuda"):
        # Where real tenants' weights and predictors live; resolved (and
        # refused when CUDA is asked for without a card) at register().
        self.device = device
        self.tenants: Dict[str, Any] = {}  # TenantExecutor implementations
        self.budget_mb = budget_mb
        self.policy = policy
        self.fallback = fallback
        self.delta_ms = delta_ms
        self.history_ms = history_ms
        # Sharded multi-device serving: a logical mesh shape, per-device
        # budgets, and an optional chip-fault schedule (elastic mesh).
        self.sharded_mesh = (tuple(sharded_mesh)
                             if sharded_mesh is not None else None)
        self.device_budget_mb = (tuple(device_budget_mb)
                                 if isinstance(device_budget_mb,
                                               (tuple, list))
                                 else device_budget_mb)
        self.migrate = migrate
        # Quantize-on-the-wire staging ("int8" or None): both loader
        # channels ship compressed bytes host→chip and dequantize on
        # land, shrinking every load's virtual transfer time by the
        # wire ratio while residency accounting is unchanged.
        self.compress = compress
        self.adaptive_delta = adaptive_delta
        # Continuous batching: requests join/leave the running decode
        # batch per step, and KV is charged page-granularly through a
        # KVPagePool sized at start().  kv_page_mb=0 derives the page
        # size from the largest tenant's 8-token decode cache.
        self.continuous = continuous
        self.kv_page_mb = kv_page_mb
        # Chip fault schedule (a serving.elastic.FaultSpec): start()
        # installs an ElasticController that fires chip-down drain plans
        # and chip-up rebalances on the engine clock.
        self.fault = fault
        self.elastic = None  # type: Optional["ElasticController"]
        # Engine fast-path knobs (see ServingEngine): audit level and
        # event-scheduling mode.  scheduler="indexed" also memoizes the
        # per-tenant prediction triggers here (the predictors' forward
        # pass re-materializes full arrival history on every call).
        self.audit = audit
        self.scheduler = scheduler
        self._tpred_memo: Dict[str, Tuple[tuple, float]] = {}
        # Horizon before which a repeat of the last maintenance pass is
        # provably the identical no-op (every tenant took the indexed
        # fast skip).  The engine's continuous loop consults it — see
        # predict_and_preload; -inf means "never skip".
        self.maint_valid_ms = float("-inf")
        self.manager: Optional[EdgeMultiAI] = None
        self.engine = None  # type: Optional["ServingEngine"]
        self.loader = None  # type: Optional["BackgroundLoader"]
        self.prefetch = prefetch
        self.max_batch = max_batch
        self.batch_window_ms = batch_window_ms
        self.straggler_deadline_s = straggler_deadline_s
        self.redispatch_count = 0
        self.results: List[ServeResult] = []
        # Sim-executor builds set this: background fits complete before
        # the next prediction so virtual-time runs stay bit-deterministic
        # (a wall-clock fit racing the virtual clock would flip
        # predictions at a nondeterministic timestamp).
        self.sync_predictor_fits = False

    @classmethod
    def build(cls, config, device="cuda") -> "EdgeServer":
        """Resolve a :class:`repro_torch.serving.api.ServingConfig` into a
        started server — the single wiring point every benchmark,
        example, and launcher goes through.  Real tenants run on
        ``device`` (the card unless the caller asks for the CPU)."""
        from repro_torch.serving.api import build_server  # local: avoids cycle
        return build_server(config, cls=cls, device=device)

    def register(self, name: str, cfg: ModelConfig, params,
                 precisions: Tuple[int, ...] = (16, 8),
                 predictor: Optional[RequestPredictor] = None) -> None:
        """Register a real-model tenant (host-side zoo built from
        ``params`` by quantization)."""
        self.tenants[name] = TenantRuntime(name, cfg, params, precisions,
                                           predictor=predictor,
                                           device=self.device)

    def register_tenant(self, name: str, tenant) -> None:
        """Register any ``TenantExecutor`` implementation — e.g. the
        sim-time executor (:class:`repro_torch.serving.api.SimTenant`) for
        deterministic, model-free tests."""
        self.tenants[name] = tenant

    def contention_budget(self, kv_headroom_mb: float = 0.0) -> float:
        """Standard contended budget over the registered tenants: every
        tenant resident at its smallest variant, plus room to upgrade the
        widest zoo to full precision, 5% slack, and explicit headroom for
        KV caches (which are charged against the budget too).  All-bf16
        residency stays impossible."""
        small = sum(t.zoo.smallest.size_mb for t in self.tenants.values())
        room = max(t.zoo.largest.size_mb - t.zoo.smallest.size_mb
                   for t in self.tenants.values())
        return (small + room) * 1.05 + kv_headroom_mb

    def start(self) -> None:
        from repro_torch.serving.engine import ServingEngine
        from repro_torch.serving.loader import BackgroundLoader

        zoos = {n: t.zoo for n, t in self.tenants.items()}

        def stage(app: str, variant: Optional[ModelVariant]) -> None:
            self.tenants[app].set_variant(variant)

        def graphs(app: str, hold: bool) -> None:
            hold_graphs = getattr(self.tenants[app], "hold_graphs", None)
            if hold_graphs is not None:
                hold_graphs(hold)

        def loader_cb(app: str, variant: Optional[ModelVariant]) -> None:
            # Synchronous (admission-path) weight moves ride the same
            # single-worker staging channel as background loads, so
            # device mutations land in the order their accounting did.
            if self.loader is not None:
                self.loader.stage_sync(app, variant)
            else:
                stage(app, variant)

        self.manager = EdgeMultiAI(
            zoos, self.budget_mb, policy=self.policy,
            delta_ms=self.delta_ms, history_ms=self.history_ms,
            loader=loader_cb, fallback=self.fallback,
            adaptive_delta=self.adaptive_delta, migrate=self.migrate)
        if self.sharded_mesh is not None:
            if not self.prefetch:
                raise ValueError(
                    "sharded serving requires the background loader "
                    "(prefetch=True): the reactive engine has no "
                    "staging channel to decompose per shard")
            self.manager.state.devices = self._device_ledger()
            from repro_torch.serving.sharded_loader import (
                ShardedLoaderChannel)
            self.loader = ShardedLoaderChannel(
                self.manager,
                n_devices=self.manager.state.devices.n_devices,
                stage_fn=stage, migrate=self.migrate,
                compress=self.compress, graphs_fn=graphs)
            self._attach_physical_mesh()
        else:
            self.loader = (BackgroundLoader(self.manager, stage_fn=stage,
                                            compress=self.compress,
                                            graphs_fn=graphs)
                           if self.prefetch else None)
        if self.loader is not None:
            # Admission-path migrations land in the same audit trail as
            # loader-path ones (the engine mirrors loader events).
            self.manager.on_migrate = (
                lambda t, app, mb: self.loader._emit(t, "migrate",
                                                     app, mb))
        if self.continuous:
            self._install_kv_pool()
        self.engine = ServingEngine(
            self, max_batch=self.max_batch,
            batch_window_ms=self.batch_window_ms, loader=self.loader,
            continuous=self.continuous, audit=self.audit,
            scheduler=self.scheduler)
        if self.fault is not None:
            from repro_torch.serving.elastic import ElasticController
            ctrl = ElasticController(self.fault, self.manager,
                                     loader=self.loader)
            # chip_down/chip_up/drain ride the loader's event hook into
            # the engine's audit trail, like migrations do.
            ctrl.on_event = (
                lambda t, kind, app, mb: self.loader._emit(t, kind,
                                                           app, mb))
            ctrl.on_reshard = self._reshard_tenant
            self.elastic = ctrl
            self.engine.elastic = ctrl

    def _attach_physical_mesh(self) -> None:
        """Physical placement of the logical mesh, by the reference's rule:
        skipped when the process has fewer cards than the mesh asks for
        (sim builds, the CPU, one card), and the ledger stays the
        accounting authority either way.  The port places no
        tensor-parallel shards across cards, so real CUDA tenants on a
        mesh that the process's cards could hold raise rather than
        serve from one card."""
        n = 1
        for s in self.sharded_mesh:
            n *= s
        cuda = [name for name, tr in self.tenants.items()
                if getattr(getattr(tr, "device", None), "type", None)
                == "cuda"]
        if n > 1 and cuda and torch.cuda.device_count() >= n:
            raise NotImplementedError(
                f"tensor-parallel placement of {', '.join(cuda)} across "
                f"{n} cards (mesh {self.sharded_mesh}) is not ported; see "
                "ROADMAP A13")

    def _reshard_tenant(self, app: str) -> None:
        """Elastic-plan hook: re-place a tenant's resident buffers after
        a drain/rebalance changed its layout (a no-op without a physical
        mesh, and for sim executors)."""
        tr = self.tenants[app]
        if hasattr(tr, "reshard_device_params"):
            tr.reshard_device_params()

    def _install_kv_pool(self) -> None:
        """Size and attach the paged-KV pool for continuous batching.

        Page size defaults to the largest tenant's 8-token decode cache
        (so one page ~ one short burst of decoding for the heaviest
        model); the whole budget is divided into pages because KV shares
        the same ledger as weights — a page the pool holds is memory a
        weight load cannot claim, and simulate/apply validates both the
        same way.  Under a sharded mesh the pages are partitioned across
        chips proportional to each chip's ledger budget."""
        from repro_torch.core.memory_state import KVPagePool
        from repro_torch.serving.engine import kv_cache_mb

        page_mb = self.kv_page_mb or max(
            kv_cache_mb(t.cfg, 1, 8) for t in self.tenants.values())
        n_pages = int(self.budget_mb // page_mb)
        if n_pages < 1:
            raise ValueError(
                f"kv_page_mb={page_mb:.1f} exceeds the whole budget "
                f"({self.budget_mb:.1f} MB): no page fits")
        dev = self.manager.state.devices
        if dev is not None:
            total = sum(dev.budgets_mb)
            counts = [int(n_pages * b / total) for b in dev.budgets_mb]
            counts[0] += n_pages - sum(counts)  # remainder to chip 0
            self.manager.state.kv_pool = KVPagePool(
                page_mb, device_pages=tuple(counts))
        else:
            self.manager.state.kv_pool = KVPagePool(page_mb, n_pages)

    def _device_ledger(self):
        """Per-device budgets + spec-derived shard splits for the mesh.

        Each tenant's per-chip fraction comes from the real partition
        rules (``weight_shard_fraction`` — replicated leaves included),
        so the ledger budgets what a chip actually holds.  The default
        per-device budget covers the worst tenant's replication overhead
        over the even ``budget/n`` split: anything fundable globally is
        then fundable per-chip, and tighter (explicit) budgets surface
        as clean whole-load failures in the sharded loader."""
        from repro_torch.core.memory_state import DeviceLedger
        from repro_torch.distributed import sharding as SH

        mesh = SH.serving_mesh(self.sharded_mesh)
        n = mesh.size
        fracs = {name: SH.weight_shard_fraction(t.cfg, mesh)
                 for name, t in self.tenants.items()}
        if isinstance(self.device_budget_mb, tuple):
            # Per-chip (skewed) budgets: the migration regime — one
            # tight chip while neighbors keep slack.
            if len(self.device_budget_mb) != n:
                raise ValueError(
                    f"{len(self.device_budget_mb)} device budgets for "
                    f"a {n}-chip mesh")
            budgets = self.device_budget_mb
        else:
            per_dev = (self.device_budget_mb
                       if self.device_budget_mb is not None
                       else self.budget_mb / n * max(
                           f * n for f in fracs.values()))
            budgets = (per_dev,) * n
        return DeviceLedger(
            budgets,
            split_fn=lambda app, v: SH.variant_shard_mb(
                v.size_mb, n, fracs[app]))

    def close(self) -> None:
        """Drain and shut down the background staging worker."""
        if self.loader is not None:
            self.loader.close()

    # ------------------------------------------------------------------
    def _predict_time(self, name: str, predictor) -> float:
        """``predictor.predict_next_time()``, memoized on the indexed
        scheduler.  The prediction is a pure function of the predictor's
        observable state — arrival history (appends only), trained
        params (change only when ``fits`` increments), and the last
        arrival — so caching on that key returns the identical float
        while skipping the O(history) forward pass the linear path runs
        once per tenant per maintenance pass."""
        if self.scheduler != "indexed":
            return predictor.predict_next_time()
        key = (len(predictor.history), predictor.fits,
               predictor.last_time)
        hit = self._tpred_memo.get(name)
        if hit is not None and hit[0] == key:
            return hit[1]
        t = predictor.predict_next_time()
        self._tpred_memo[name] = (key, t)
        return t

    def predict_and_preload(self, now_ms: float) -> None:
        """Drive the RNN request predictors -> proactive loads.

        With the background loader attached, predicted-next tenants get
        their iWS-BFE-chosen variant *enqueued* for staging instead of
        loaded on the caller's thread, and prefetches whose predicted
        window expired without a request are cancelled (releasing their
        in-flight memory claim).  Without a loader this is the PR-1
        synchronous proactive load.

        This is also where the RNNs get *trained*: a predictor with
        enough fresh inter-arrival history (``fit_due``) is handed to
        the loader's background fit worker — the live path runs on the
        mean-gap fallback until the first fit lands, then on the
        trained RNN, and never blocks on training."""
        # Indexed fast path: when a tenant's memoized prediction is
        # current and no fit is due, its pass can only end in "do
        # nothing" — prove it with cheap reads and skip the planner.
        # Soundness: (a) the prediction is rewritten so state matches
        # the linear pass even when the memo was filled by
        # ``next_prefetch_trigger``; (b) Δ is recomputed fresh when
        # adaptive (it drifts with arrival residuals); (c) outside
        # [t_pred−Δ−θ, t_pred+Δ] nothing fires, and inside it a tenant
        # with queued requests is demand-loaded, never prefetched —
        # both exactly the linear conditions; (d) for the
        # un-overridden base ``plan_prefetch`` hook the eviction-free
        # surplus decision is replicated verbatim against a pass-level
        # ``free_mb`` (one budget sum per pass, dropped whenever a
        # full pass may have mutated the state).  A custom policy hook
        # gets no structural credit — the full pass runs so its plan
        # is actually consulted.  This loop is the engine's hottest
        # code (once per tenant per event-loop iteration), hence the
        # hoisted locals and the inlined window/fit/hook checks.
        mgr = self.manager
        fast = self.scheduler == "indexed" and self.loader is not None
        free_mb = None  # one budget sum per pass; reset on mutation
        # Skip horizon accounting: while every tenant takes the fast
        # skip, the pass decisions can only flip at the earliest
        # still-ahead window opening (t_pred − Δ − θ) — tenants already
        # in or past their window stay no-ops until an arrival, fit, or
        # memory mutation, all of which reset the engine's clean flag.
        valid = float("inf")
        all_skipped = fast
        if fast:
            memo = self._tpred_memo
            tstates = mgr.state.tenants
            queues = (self.engine.batcher.queues
                      if self.engine is not None else None)
            delta_const = None if mgr.adaptive_delta else mgr.delta
            policy = mgr.policy
            base_hook = (policy is not None and
                         type(policy).plan_prefetch is Policy.plan_prefetch)
        for name, tr in self.tenants.items():
            if fast:
                p = tr.predictor
                hit = memo.get(name)
                n_hist = len(p.history)
                if (hit is not None
                        and hit[0] == (n_hist, p.fits, p.last_time)
                        # fit_due is False while the history is short
                        # (n < max(min_fit_samples, context+2)); only
                        # past that must the refit cadence be asked.
                        and (n_hist < p.min_fit_samples
                             or n_hist < p.context + 2
                             or not p.fit_due())):
                    t_pred = hit[1]
                    t = tstates[name]
                    t.predicted_next = t_pred  # == set_prediction
                    delta = (delta_const if delta_const is not None
                             else mgr.delta_for(name))
                    largest = t.zoo.variants[0]  # zoo sorts desc
                    start = t_pred - delta - largest.load_ms
                    if now_ms < start:  # ahead of the window
                        if start < valid:
                            valid = start
                        continue
                    if now_ms > t_pred + delta:  # window passed
                        continue
                    if queues is not None and queues.get(name):
                        continue  # queued: demand path, not prefetch
                    if policy is None:
                        continue  # manager.plan_prefetch is None
                    if base_hook:
                        if (t.loaded is largest
                                or t.inflight_mb > 0.0):
                            continue  # the hook's two early outs
                        if free_mb is None:
                            free_mb = mgr.state.free_mb
                        cur = t.loaded.size_mb if t.loaded else 0.0
                        planless = True
                        for v in t.zoo.variants:  # mirror the hook
                            if t.loaded is not None \
                                    and v.size_mb <= cur:
                                break
                            if v.size_mb - cur <= free_mb:
                                planless = False  # hook would plan
                                break
                        if planless:
                            continue
                    # In-window, unqueued, and the hook might plan:
                    # fall through to the full pass below.
            # The full pass may mutate the memory state (stage a load,
            # reserve a claim): drop the pass-level free_mb cache, and
            # give the engine no skip credit for this pass.
            all_skipped = False
            free_mb = None
            if self.loader is not None and tr.predictor.fit_due():
                fut = self.loader.submit_fit(tr.predictor)
                if fut is not None and self.sync_predictor_fits:
                    fut.result()  # lands at this exact virtual instant
            t_pred = self._predict_time(name, tr.predictor)
            self.manager.set_prediction(name, t_pred)
            theta = tr.zoo.largest.load_ms
            # Per-tenant Δ: the configured constant, or the residual-
            # adapted window when ``adaptive_delta`` is on.
            delta = self.manager.delta_for(name)
            in_window = (t_pred - delta - theta <= now_ms
                         <= t_pred + delta)
            if self.loader is None:
                if t_pred - delta - theta <= now_ms:
                    self.manager.proactive_load(name, now_ms)
            elif in_window:
                # Only prefetch inside the predicted window: past its
                # far edge the prediction is already wrong, and a stale-
                # cancelled prefetch must not immediately re-enqueue.
                if (self.engine is None
                        or self.engine.batcher.queued(name) == 0):
                    # A tenant with requests already queued is not a
                    # prefetch target — its load is demand-triggered
                    # (the engine stages it and admits the batch cold);
                    # calling it a prefetch would count a request that
                    # waited out the transfer as a warm start.
                    plan = self.manager.plan_prefetch(name, now_ms)
                    if plan is not None:
                        self.loader.execute(
                            RA.ResidencyPlan(
                                RA.procure_actions(plan, staged=True)),
                            now_ms, predicted_ms=t_pred)
        self.maint_valid_ms = valid if all_skipped else float("-inf")
        if (self.loader is not None and self.engine is not None
                and self.loader.inflight):  # nothing staged: no-op
            # Per-tenant Δ so staleness agrees with the (possibly
            # adaptive) window that justified the prefetch.
            self.loader.cancel_stale(
                now_ms, self.manager.delta_for,
                has_queued=lambda a: self.engine.batcher.queued(a) > 0)

    def next_prefetch_trigger(self, now_ms: float) -> float:
        """Earliest *future* t_pred − Δ − θ across tenants that could use
        a proactive load: the engine's idle path wakes here, otherwise a
        drained queue would sleep straight through its prefetch window
        and every load would degenerate to demand-time."""
        out = float("inf")
        for name, tr in self.tenants.items():
            t = self.manager.state.tenants[name]
            if t.loaded is t.zoo.largest or t.inflight_mb > 0.0:
                continue
            trig = (self._predict_time(name, tr.predictor)
                    - self.manager.delta_for(name)
                    - tr.zoo.largest.load_ms)
            if now_ms < trig < out:
                out = trig
        return out

    def serve(self, app: str, prompts: np.ndarray, max_new: int = 8,
              now_ms: Optional[float] = None,
              extra: Optional[dict] = None) -> ServeResult:
        """Synchronous one-batch API, delegating to the engine: the batch
        is admitted with its KV cache charged against the budget and the
        charge released on retirement."""
        assert self.manager is not None, "call start() first"
        from repro_torch.serving.batcher import Batch, Request

        now_ms = time.monotonic() * 1e3 if now_ms is None else now_ms
        tr = self.tenants[app]
        prompts = np.asarray(prompts, np.int32)
        if len(prompts) == 0:  # nothing to admit, nothing to charge
            return self._record(ServeResult(
                app, np.zeros((0, max_new), np.int32), False, False,
                tr.loaded_bits, 0.0))
        tr.predictor.observe_request(now_ms)
        reqs = [self.engine.batcher.assign(
            Request(app=app, prompt=prompts[i], max_new=max_new,
                    arrival_ms=now_ms)) for i in range(len(prompts))]
        batch = Batch(app, reqs, prompts, max_new)
        results, service_ms, toks = self.engine.execute_batch(
            batch, now_ms, extra=extra)
        warm = results[0].warm
        if toks is None:
            return self._record(ServeResult(
                app, np.zeros((len(prompts), 0), np.int32), warm, True,
                None, service_ms / 1e3))
        elapsed = service_ms / 1e3
        redis = False
        if elapsed > self.straggler_deadline_s:
            # Straggler mitigation: on a real fleet this re-dispatches to
            # the replica pod (the multi-pod mesh's second pod); here we
            # count and serve locally.
            self.redispatch_count += 1
            redis = True
        return self._record(ServeResult(
            app, toks, warm, False, tr.loaded_bits, elapsed, redis))

    def _record(self, r: ServeResult) -> ServeResult:
        self.results.append(r)
        return r

    # ------------------------------------------------------------------
    def stats(self) -> "ServingStats":
        """The engine's typed :class:`~repro_torch.serving.stats.ServingStats`
        with the server-level gauges filled in (residency, latency,
        redispatch, predictor fits, adaptive windows, device ledger).
        All request counts are per *request* (the engine's unit), so the
        top-level ratios and the per-tenant breakdown describe the same
        population — a multi-row serve() batch counts once per row."""
        import dataclasses

        from repro_torch.serving.stats import ServingStats

        eng_results = self.engine.results if self.engine else []
        if not eng_results:  # serve() always routes through the engine
            return ServingStats()
        n = len(eng_results)
        ok = [r.latency_ms for r in eng_results if not r.failed]
        extra: dict = {
            "redispatched": self.redispatch_count,
            "resident_mb": self.manager.state.used_mb,
            "weights_mb": self.manager.state.weights_mb,
            "kv_mb": self.manager.state.kv_mb,
            "requests": n,
            "warm_ratio": sum(r.warm for r in eng_results) / n,
            "fail_ratio": sum(r.failed for r in eng_results) / n,
            "mean_latency_s": (float(np.mean(ok)) / 1e3 if ok
                               else float("inf")),
            # Completed background predictor fits (the hit rate itself
            # comes from the engine view).
            "predictor_fits": sum(
                getattr(t.predictor, "fits", 0)
                for t in self.tenants.values()),
        }
        if self.adaptive_delta:
            # The residual-adapted prediction windows, per tenant.
            extra["delta_ms"] = {name: self.manager.delta_for(name)
                                 for name in self.tenants}
        if self.manager.state.devices is not None:
            led = self.manager.state.devices
            extra["device_used_mb"] = led.device_used()
            extra["device_budget_mb"] = led.budgets_mb
        return dataclasses.replace(self.engine.stats(), **extra)
