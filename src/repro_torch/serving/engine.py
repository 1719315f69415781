"""Serving engines: LM decode batching and DCN vision serving over the
graph executor.

``DecodeEngine`` keeps a fixed pool of ``batch`` cache slots; requests are
admitted into free slots (continuous batching), ``step()`` decodes one
token for every slot in one ``lm_decode_step`` call (every GQA attention
layer one launch of the split-KV decode kernel on a card; MLA layers keep
a latent cache and run plain ops), and finished slots
(EOS, ``max_new`` or ``max_len``) are released and refilled. Per-slot
positions make the batch ragged-safe: each slot attends only to its own
``pos`` prefix. Prefill here is incremental (the prompt is fed token by
token through the decode step), as in the JAX package; the batched
full-sequence prefill is ``models.lm.lm_prefill``.

``DcnServingEngine`` serves the paper's DCN networks through the
network-graph executor with a per-engine schedule cache: replayed requests
whose quantized sampling coordinates match an earlier one skip the TDT +
Algorithm-1 build. It is a continuous-batching service: ``submit()``
enqueues image requests from any thread, ``step()`` admits queued images
into a fixed pool of slots and serves every occupied slot with ONE
``batch_fused`` ragged grid per layer segment, so concurrent requests
share each kernel launch. Requests carry deadlines; the queue can be
bounded with ``block``/``reject``/``shed-oldest`` backpressure. ``stats``
and ``metrics_snapshot()`` expose the cache hit rate, dispatch and
overlap counters and submit->result latency percentiles.

Requests are isolated: a failed ``batch_fused`` step retries once with
the offending slot evicted (when the fault names its image), then
degrades to per-image ``batched`` dispatch, so one poisoned image never
takes down its step-mates. A failing request resolves with
``DcnRequest.error`` set (``result()`` raises the typed
``RequestFailedError``) and is returned exactly once; the failure
counters (``requests_failed``, ``deadline_expired``, ``queue_rejected``,
``queue_shed``, ``step_retries``, ``degraded_steps``,
``watchdog_failovers``) appear in ``stats`` and ``metrics_snapshot()``.
A kernel that does not build or launch, or a CUDA error, is not a fault
of one request: it propagates out of ``step()`` instead of being
isolated, so the ladder never hides a broken device path.

With a sharded graph config (``mesh=`` / ``data_parallel=``) the engine
is replica-aware: its slots partition contiguously over the mesh's data
replicas, admission refills the replica with the most free slots, and
each step passes its per-replica occupancy to ``run_graph(shard_sizes=)``
so that shard placement is slot placement. ``stats`` reports
``replicas``, ``per_replica`` images / dispatches / DRAM bytes and
``allgather_bytes``.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.convert import _tensor
from repro_torch.kernels._build import KernelError
from repro_torch.models import lm
from repro_torch.models.transformer import reset_cache_rows
from repro_torch.obs import MetricsRegistry, Tracer, get_tracer
from repro_torch.serving.errors import (DeadlineExceededError, DrainTimeout,
                                        QueueFullError, RequestFailedError)

# Device-level failures: never isolated per request (see module doc).
_DEVICE_ERRORS = (KernelError,) + tuple(
    e for e in (getattr(torch, "AcceleratorError", None),) if e is not None)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 16
    temperature: float = 0.0
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class DecodeEngine:
    """Continuous-batching LM decoding over ``batch`` cache slots.

    ``params`` must already lie on ``device`` (``"cuda"`` by default).
    Every step runs all ``batch`` slots: a free or finished slot decodes
    into the void at its stale position and writes its cache row there,
    as the JAX package's jitted step does. Admission differs from the JAX
    engine in one way: it writes the initial values back into the slot's
    rows of every recurrent cache (Mamba, mLSTM, sLSTM; their decode
    ignores ``pos``), so a request never starts from the state of the
    slot's previous occupant; the JAX engine leaves that state in place
    (ROADMAP.md §3). Attention and MLA caches are left alone, since
    ``pos`` masks their stale rows, and so are the cross-attention
    caches. A cross-attention model (llama-3.2-vision) decodes against the
    image K/V in ``cache``, which the engine starts at zero, as the JAX
    engine does: the caller fills it after construction with
    ``eng.cache = lm.build_cross_cache(params, cfg, eng.cache, states)``,
    row i of ``states`` being slot i's image. The image belongs to the
    slot, not to the request: admission leaves it in place, and every
    request the slot serves sees it. Sampling at
    ``temperature > 0`` draws from the engine's own ``torch.Generator``
    seeded with ``rng_seed``; its draws differ from ``jax.random``'s, so
    only greedy (temperature 0) tokens match the JAX engine. ``mesh`` (a
    ``launch.mesh.DeviceMesh``) goes into the decode step's ``ctx``, as in
    the JAX engine: the MoE blocks run expert-parallel over it (its model
    size must be the config's ``ep``); the params and the cache stay on
    ``device``, which must be the mesh's rank (0, 0), and every device of
    the mesh of its type (``ValueError`` otherwise).
    ``steps`` counts the decode steps run. ``cache_dtype`` (float32 by
    default, as the JAX engine's) is the attention, MLA and Mamba caches'
    dtype, free of the params' dtype: bf16 (float16) params with
    ``cache_dtype=torch.bfloat16`` (``torch.float16``) serve a bf16
    (float16) model, and on a card #8 reads the cache as stored.
    """

    def __init__(self, params, cfg, *, batch: int, max_len: int, mesh=None,
                 cache_dtype=torch.float32, eos_id: int | None = None,
                 rng_seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        if mesh is not None:
            here = self.device
            if here.type == "cuda" and here.index is None:
                here = torch.device("cuda", torch.cuda.current_device())
            if mesh.device(0, 0) != here or any(
                    d.type != here.type for row in mesh.ranks for d in row):
                raise ValueError(
                    f"DecodeEngine(device={self.device}) needs a mesh whose "
                    f"devices are {self.device.type} devices, rank (0, 0) "
                    f"on the engine's device; got {mesh.ranks}")
        self._ctx = {"mesh": mesh} if mesh is not None else {}
        self.params = params
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.cache = lm.init_cache(cfg, batch, max_len, dtype=cache_dtype,
                                   device=self.device)
        self.slots: list[Request | None] = [None] * batch
        self.pos = np.zeros((batch,), np.int32)
        self.pending_tok = np.zeros(
            (batch, 1, cfg.n_codebooks) if cfg.n_codebooks > 1 else (batch, 1),
            np.int32)
        self.active = np.zeros((batch,), bool)
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self.steps = 0
        # submit() may be called from any producer thread; the lock covers
        # every queue mutation.
        self._lock = threading.Lock()
        self._gen = torch.Generator().manual_seed(rng_seed)

    def submit(self, req: Request):
        if not req.prompt:
            raise ValueError(
                f"request {req.rid}: empty prompt — decoding needs at "
                "least one prompt token to seed the first step")
        with self._lock:
            self.queue.append(req)

    def _admit(self):
        admitted = []
        with self._lock:
            for i in range(self.batch):
                if self.slots[i] is None and self.queue:
                    req = self.queue.pop(0)
                    self.slots[i] = req
                    self.pos[i] = 0
                    self.pending_tok[i] = req.prompt[0]
                    self.active[i] = True
                    admitted.append(i)
        if admitted:
            reset_cache_rows(self.cfg, self.cache, admitted)

    def _sample(self, logits, temperature) -> np.ndarray:
        """Next-token sampling; ``temperature`` is a scalar or a per-slot
        (B,) vector — 0 means greedy argmax for that slot."""
        t = np.atleast_1d(np.asarray(temperature, np.float32))
        greedy = torch.argmax(logits, dim=-1).cpu().numpy()
        if not (t > 0).any():
            return greedy
        safe = torch.as_tensor(np.where(t > 0, t, 1.0))
        scaled = logits.float().cpu() / safe.reshape(-1, 1)
        sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                    generator=self._gen)[:, 0].numpy()
        return np.where(t > 0, sampled, greedy)

    def step(self) -> int:
        """One decode step over all slots. Returns #active."""
        self._admit()
        if not self.active.any():
            return 0
        tok = torch.as_tensor(self.pending_tok).to(self.device)
        pos = torch.as_tensor(self.pos).to(self.device)
        logits, self.cache = lm.lm_decode_step(self.params, self.cfg,
                                               self.cache, tok, pos,
                                               self._ctx)
        self.steps += 1

        # Sampled at each slot's OWN request temperature (inactive slots
        # decode greedily into the void).
        temps = np.zeros((self.batch,), np.float32)
        for i, req in enumerate(self.slots):
            if req is not None and self.active[i]:
                temps[i] = req.temperature
        next_tok = self._sample(logits[:, 0], temps)
        for i in range(self.batch):
            req = self.slots[i]
            if req is None or not self.active[i]:
                continue
            self.pos[i] += 1
            in_prompt = self.pos[i] < len(req.prompt)
            if in_prompt:
                nxt = req.prompt[self.pos[i]]
            else:
                nxt = next_tok[i]
                req.out.append(int(np.asarray(nxt).reshape(-1)[0]))
            self.pending_tok[i] = nxt
            hit_eos = (self.eos_id is not None and not in_prompt
                       and int(np.asarray(nxt).reshape(-1)[0]) == self.eos_id)
            if (len(req.out) >= req.max_new or hit_eos
                    or self.pos[i] >= self.max_len - 1):
                req.done = True
                self.finished.append(req)
                self.slots[i] = None
                self.active[i] = False
        return int(self.active.sum())

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Decode until idle. Raises :class:`DrainTimeout` (stuck rids +
        what did finish) if ``max_steps`` is exhausted with requests
        still queued or mid-decode — silently returning would drop
        them."""
        for _ in range(max_steps):
            active = self.step()
            with self._lock:
                queued = bool(self.queue)
            if active == 0 and not queued:
                return self.finished
        with self._lock:
            stuck = ([r.rid for r in self.slots if r is not None]
                     + [r.rid for r in self.queue])
        if stuck:
            raise DrainTimeout(stuck, finished=self.finished)
        return self.finished


# ---------------------------------------------------------------------------
# DCN graph-backend serving
# ---------------------------------------------------------------------------


def _image_dram(trace) -> dict[int, int]:
    """Modeled DRAM bytes of each image of a ``NetworkTrace`` (its groups;
    the trace's total adds the boundary planes)."""
    per_img: dict[int, int] = {}
    for gt in trace.groups:
        per_img[gt.image] = per_img.get(gt.image, 0) + gt.total_dram_bytes
    return per_img


def _host_images(x) -> torch.Tensor:
    """Images as a host tensor in their own floating dtype (bf16 from an
    ``ml_dtypes`` array or a torch tensor included); float64 and
    non-floating values are read as float32."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
    else:
        a = np.asarray(x)
        t = _tensor(a, torch.device("cpu")) \
            if a.dtype.name == "bfloat16" else torch.as_tensor(a)
    if t.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        t = t.to(torch.float32)
    return t


@dataclasses.dataclass
class DcnRequest:
    """One vision serving request: a small batch of images.

    ``out`` fills per image as serving steps complete the images' slots;
    the request finishes when its last image does. A request always
    resolves: ``done`` with outputs, or ``done`` with ``error`` set, in
    which case ``result()`` raises it. ``x`` holds the images on the host
    as submitted, in their dtype (float64 read as float32). Outputs are
    numpy arrays, except a bf16 engine's, which numpy cannot hold without
    ``ml_dtypes``: those are host ``torch.bfloat16`` tensors with the
    logits' exact values.
    """

    rid: int
    x: torch.Tensor              # (n, H, W, C), on the host
    submit_s: float
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    finish_s: float = 0.0
    error: Exception | None = None
    deadline: float | None = None

    @property
    def n_images(self) -> int:
        return int(self.x.shape[0])

    @property
    def failed(self) -> bool:
        return self.error is not None

    @property
    def latency_s(self) -> float:
        return (self.finish_s - self.submit_s) if self.done else 0.0

    def result(self) -> np.ndarray:
        """Stacked per-image outputs, in submit order (a host bf16 tensor
        on a bf16 engine, else a numpy array)."""
        if self.error is not None:
            raise self.error
        if not self.done:
            raise RuntimeError(f"request {self.rid} is not finished")
        if isinstance(self.out[0], torch.Tensor):
            return torch.stack(self.out)
        return np.stack([np.asarray(o) for o in self.out])


class DcnServingEngine:
    """Inference service for the paper's DCN networks over the graph
    executor on ``device`` (default ``"cuda"``; the parameters must live
    there too).

    * ``infer(x)`` — serve one request synchronously, whole batch in one
      executor call.
    * ``submit(x)`` / ``step()`` / ``drain()`` — continuous batching: a
      submit queue feeds ``slots`` image slots; each ``step()`` admits
      queued images into free slots and serves ALL occupied slots with
      one ``batch_fused`` grid per layer segment. ``submit`` is
      thread-safe; ``step``/``drain`` are driven by one serving loop.

    ``faults`` threads a fault injector (``repro_torch.testing``) into the
    executor config, for resilience tests. A ``graph`` config with a
    ``mesh`` (or ``data_parallel``) shards every step's batch over the
    mesh's data replicas; ``slots`` must give each replica one slot.
    """

    def __init__(self, params, cfg, *, graph=None, cache_size: int = 256,
                 slots: int = 4,
                 clock: Callable[[], float] | None = None,
                 tracer: Tracer | None = None,
                 max_queue: int | None = None,
                 queue_policy: str = "block",
                 faults=None,
                 device="cuda"):
        from repro_torch.core.scheduler import host_schedule_builds
        from repro_torch.models.dcn_models import DcnNetConfig
        from repro_torch.runtime.cache import ScheduleCache
        from repro_torch.runtime.fused_exec import GraphConfig
        from repro_torch.runtime.graph import build_graph
        from repro_torch.runtime.pipeline import (clamp_tile_config,
                                                  staging_watchdog_failovers)
        from repro_torch.runtime.trace import LatencyStats, OverlapSpans

        if not isinstance(cfg, DcnNetConfig):
            raise ValueError(
                f"DcnServingEngine needs a DcnNetConfig, got {type(cfg)}")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if queue_policy not in ("block", "reject", "shed-oldest"):
            raise ValueError(
                f"unknown queue_policy: {queue_policy!r} (expected "
                f"'block', 'reject' or 'shed-oldest')")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.device = resolve_device(device)
        w0 = params["convs"][0]
        w0 = w0.w if hasattr(w0, "w") else w0["w"]
        if w0.device.type != self.device.type:
            raise ValueError(f"params live on {w0.device}, the engine on "
                             f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.graph_cfg = graph or GraphConfig()
        if faults is not None:
            self.graph_cfg = dataclasses.replace(self.graph_cfg,
                                                 faults=faults)
        self.net_graph = build_graph(cfg)
        self.cache = ScheduleCache(maxsize=cache_size)
        self.overlap = OverlapSpans()
        self.tracer = tracer if tracer is not None else get_tracer()
        self.metrics = MetricsRegistry()
        self._m_requests = self.metrics.counter(
            "serving.requests", help="requests submitted")
        self._m_images = self.metrics.counter(
            "serving.images", help="images served")
        self._m_dispatches = self.metrics.counter(
            "serving.kernel_dispatches",
            help="host-issued kernel dispatches")
        self._m_steps = self.metrics.counter(
            "serving.steps", help="continuous-batching serving steps")
        self._m_failed = self.metrics.counter(
            "serving.requests_failed",
            help="requests that resolved with an error status")
        self._m_deadline = self.metrics.counter(
            "serving.deadline_expired",
            help="requests failed on a missed deadline (admission or "
                 "completion)")
        self._m_rejected = self.metrics.counter(
            "serving.queue_rejected",
            help="submits refused by the bounded queue")
        self._m_shed = self.metrics.counter(
            "serving.queue_shed",
            help="queued requests evicted by policy 'shed-oldest'")
        self._m_retries = self.metrics.counter(
            "serving.step_retries",
            help="batch_fused steps retried after an execution fault")
        self._m_degraded = self.metrics.counter(
            "serving.degraded_steps",
            help="steps degraded to per-image batched dispatch")
        # Process-wide counters: the engine reports its own deltas.
        self._host_builds = host_schedule_builds
        self._host_builds0 = host_schedule_builds.count
        self._watchdog = staging_watchdog_failovers
        self._watchdog0 = staging_watchdog_failovers.count
        self.n_slots = int(slots)
        self.max_queue = None if max_queue is None else int(max_queue)
        self.queue_policy = queue_policy
        self._clock = clock if clock is not None else time.perf_counter
        self._lock = threading.Lock()
        self._queue_room = threading.Condition(self._lock)
        self._queue: deque[tuple[DcnRequest, int]] = deque()
        self._slots: list[tuple[DcnRequest, int] | None] = (
            [None] * self.n_slots)
        self._rid = itertools.count()
        self.latency = LatencyStats()
        self.metrics.register("serving.latency_s", self.latency)
        self.last_trace = None
        self.last_step_faulted = False
        # One entry a step while the tracer is enabled: step id, width,
        # dispatch and DRAM accounting and the step's dispatch spans.
        self.timeline: list[dict] = []
        # The step config pins the coalesced dispatch mode to
        # batch_fused and is clamped once: serving images share a plane.
        self._step_cfg = clamp_tile_config(
            dataclasses.replace(self.graph_cfg, dispatch="batch_fused"),
            cfg.img_size, cfg.img_size)
        # Scale-out: the mesh is resolved once, so every step (and its
        # weight copies to other devices) reuses it; the slot pool
        # partitions contiguously over the mesh's data replicas.
        from repro_torch.runtime.shard import (plan_batch_shards,
                                               resolve_shard_mesh)
        mesh = resolve_shard_mesh(self._step_cfg.mesh,
                                  self._step_cfg.data_parallel)
        if mesh is not None:
            self._step_cfg = dataclasses.replace(self._step_cfg, mesh=mesh,
                                                 data_parallel=None)
        self.replicas = mesh.shape["data"] if mesh is not None else 1
        if self.replicas > self.n_slots:
            raise ValueError(
                f"slots={self.n_slots} cannot cover {self.replicas} data "
                f"replicas — every replica needs at least one slot (raise "
                f"slots= or shrink the mesh)")
        self._slot_replica = [
            r for r, (a, b) in enumerate(
                plan_batch_shards(self.n_slots, self.replicas).spans)
            for _ in range(b - a)]
        self._m_replica = [
            {"images": self.metrics.counter(
                 f"serving.replica{r}.images",
                 help=f"images served on data replica {r}"),
             "dispatches": self.metrics.counter(
                 f"serving.replica{r}.dispatches",
                 help=f"kernel dispatches executed on replica {r}"),
             "dram_bytes": self.metrics.counter(
                 f"serving.replica{r}.dram_bytes",
                 help=f"modeled DRAM bytes of replica {r}'s images")}
            for r in range(self.replicas)]
        self._m_allgather = self.metrics.counter(
            "serving.allgather_bytes",
            help="output gather traffic of sharded steps")
        # Degraded mode: per-image batched dispatch, serial staging — a
        # fault in one image's dispatch cannot touch another's. Sharding
        # is cleared: "batched" rejects mesh=/data_parallel=.
        self._degraded_cfg = dataclasses.replace(
            self._step_cfg, dispatch="batched", staging_depth=1, mesh=None,
            data_parallel=None)
        self._faults = self._step_cfg.faults
        # Plan autotuning: resolve the tuned plan ONCE at construction — a
        # cache hit (memory or plan_cache_dir disk) is free, an "offline"
        # miss pays the simulator search here rather than on the first
        # request. Every step, the evicted retry and the degraded step
        # replay this same plan (tuned_plan= below), so the hot path
        # never re-resolves.
        from repro_torch.tuning import plan_cache_hits, resolve_tuned_plan
        self._plan_hits = plan_cache_hits
        self._plan_hits0 = plan_cache_hits.count
        self.tuned_plan = None
        self._autotune_search_s = 0.0
        if self._step_cfg.autotune != "off":
            sc = self._step_cfg
            hits_before = plan_cache_hits.count
            self.tuned_plan = resolve_tuned_plan(
                self.params["convs"], self.net_graph,
                autotune=sc.autotune,
                onchip_budget_bytes=sc.onchip_budget_bytes,
                dtype_bytes=4, tile_hw=sc.tile_hw,
                buffer_tiles=sc.buffer_tiles, schedule=sc.schedule,
                batch=self.n_slots, budget=sc.autotune_budget,
                plan_cache_dir=sc.plan_cache_dir,
                max_displacement=self.cfg.max_displacement,
                tracer=self.tracer)
            if (self.tuned_plan is not None
                    and plan_cache_hits.count == hits_before):
                # Fresh search (not a cache hit): surface its cost.
                self._autotune_search_s = self.tuned_plan.search_s

    @property
    def requests(self) -> int:
        return self._m_requests.count

    @property
    def images(self) -> int:
        return self._m_images.count

    @property
    def kernel_dispatches(self) -> int:
        return self._m_dispatches.count

    @property
    def steps(self) -> int:
        return self._m_steps.count

    @property
    def host_schedule_builds(self) -> int:
        """Host-side ``TileSchedule`` builds since this engine was
        constructed (0 on the device scheduling hot path)."""
        return self._host_builds.count - self._host_builds0

    @property
    def requests_failed(self) -> int:
        return self._m_failed.count

    @property
    def watchdog_failovers(self) -> int:
        """Staging-watchdog failovers since this engine was constructed
        (process-wide counter, engine-relative delta)."""
        return self._watchdog.count - self._watchdog0

    @property
    def plan_cache_hits(self) -> int:
        """Tuned-plan cache hits since this engine was constructed
        (process-wide counter, engine-relative delta — same pattern as
        ``host_schedule_builds``)."""
        return self._plan_hits.count - self._plan_hits0

    @property
    def tuned_groups(self) -> int:
        """Fused groups in the active tuned plan (0 = greedy plan)."""
        return len(self.tuned_plan.groups) if self.tuned_plan else 0

    def _absorb_trace(self, trace) -> None:
        """Fold one executor trace into the engine counters (caller holds
        ``self._lock``)."""
        self._m_dispatches.inc(trace.kernel_dispatches)
        self._m_allgather.inc(trace.allgather_bytes)
        self.overlap.merge(trace.overlap)
        self.last_trace = trace

    def _fail_locked(self, req: DcnRequest, error: RequestFailedError,
                     now: float) -> bool:
        """Resolve ``req`` with an error (caller holds ``self._lock``);
        purges its queued images and slots. False if already resolved."""
        if req.done:
            return False
        req.error = error
        req.done = True
        req.finish_s = now
        self._m_failed.inc()
        if isinstance(error, DeadlineExceededError):
            self._m_deadline.inc()
        if any(e[0] is req for e in self._queue):
            self._queue = deque(e for e in self._queue if e[0] is not req)
        for i, s in enumerate(self._slots):
            if s is not None and s[0] is req:
                self._slots[i] = None
        self._queue_room.notify_all()
        return True

    def _to_device(self, x) -> torch.Tensor:
        return _host_images(x).to(self.device)

    def _run_graph(self, x: torch.Tensor, cfg, shard_sizes=None):
        """One executor call -> (logits on the device, trace). Images of
        another dtype than the params' raise ``TypeError``, as the JAX
        engine's first convolution rejects mixed dtypes."""
        from repro_torch.models.dcn_models import apply_head
        from repro_torch.runtime.fused_exec import run_graph

        w0 = self.params["convs"][0]
        w0 = w0.w if hasattr(w0, "w") else w0["w"]
        if x.dtype != w0.dtype:
            raise TypeError(f"{x.dtype} images into an engine whose params "
                            f"are {w0.dtype}: the first convolution takes "
                            f"one dtype")

        y, trace = run_graph(
            self.params["convs"], self.net_graph, x, config=cfg,
            max_displacement=self.cfg.max_displacement, return_trace=True,
            schedule_cache=self.cache, tracer=self.tracer,
            shard_sizes=shard_sizes, tuned_plan=self.tuned_plan)
        return apply_head(self.params, self.cfg, y), trace

    def _run_batch(self, images: list[np.ndarray], cfg, shard_sizes=None):
        """One executor call over a list of host images -> (host logits,
        trace): numpy, or a bf16 tensor (``DcnRequest``)."""
        logits, trace = self._run_graph(
            torch.stack(images).to(self.device), cfg, shard_sizes)
        logits = logits.cpu()
        return (logits if logits.dtype == torch.bfloat16
                else logits.numpy()), trace

    def _shard_sizes(self, repl: list[int] | None):
        """Per-replica image counts of one step's batch (None when the
        engine is unsharded). ``repl`` is slot-ordered, and slots map to
        replicas contiguously, so the batch is shard-contiguous."""
        if repl is None or self.replicas <= 1:
            return None
        return [repl.count(r) for r in range(self.replicas)]

    def _execute_isolated(self, images: list[np.ndarray],
                          repl: list[int] | None = None):
        """Serve one step's images with request isolation.

        Returns ``(outs, traces, failures, degraded)``: ``outs`` maps
        batch position -> output, ``failures`` batch position ->
        exception, ``traces`` the executor traces to absorb, ``degraded``
        marks a step that fell back to per-image dispatch. ``repl`` is
        each position's replica on a sharded engine: it sets
        ``shard_sizes``, the evicted retry's included.

        The ladder: (1) the coalesced ``batch_fused`` run; (2) on an
        exception that names the offending image (``e.image``), retry ONCE
        with that slot evicted; (3) on an unattributed exception or a
        failed retry, degrade to per-image ``batched`` dispatch, capturing
        each image's exception on its own. Device-level errors
        (``_DEVICE_ERRORS``) are never caught here.
        """
        n = len(images)
        try:
            out, trace = self._run_batch(images, self._step_cfg,
                                         self._shard_sizes(repl))
            return dict(enumerate(out)), [trace], {}, False
        except _DEVICE_ERRORS:
            raise
        except Exception as e:   # isolation boundary: any executor fault
            first = e
        self._m_retries.inc()
        self.tracer.instant("serve.step_retry", error=type(first).__name__)
        failures: dict[int, Exception] = {}
        bad = getattr(first, "image", None)
        if isinstance(bad, int) and 0 <= bad < n:
            failures[bad] = first
            keep = [k for k in range(n) if k != bad]
            if not keep:
                return {}, [], failures, False
            try:
                out, trace = self._run_batch(
                    [images[k] for k in keep], self._step_cfg,
                    self._shard_sizes(None if repl is None
                                      else [repl[k] for k in keep]))
                return ({k: out[z] for z, k in enumerate(keep)}, [trace],
                        failures, False)
            except _DEVICE_ERRORS:
                raise
            except Exception:    # the retry faulted too -> degrade
                pass
        self._m_degraded.inc()
        self.tracer.instant("serve.step_degraded", width=n)
        outs: dict[int, np.ndarray] = {}
        traces: list = []
        for k in range(n):
            if k in failures:
                continue
            try:
                out, trace = self._run_batch([images[k]],
                                             self._degraded_cfg)
                outs[k] = out[0]
                traces.append(trace)
            except _DEVICE_ERRORS:
                raise
            except Exception as ek:
                failures[k] = ek
        return outs, traces, failures, True

    def infer(self, x) -> torch.Tensor:
        """Serve one request batch (N, H, W, C) -> logits."""
        from repro_torch.runtime.pipeline import clamp_tile_config

        x = x.to(self.device) if isinstance(x, torch.Tensor) \
            else self._to_device(x)
        gcfg = clamp_tile_config(
            dataclasses.replace(self.graph_cfg, dispatch="batch_fused"),
            x.shape[1], x.shape[2])
        out, trace = self._run_graph(x, gcfg)
        self._m_requests.inc()
        self._m_images.inc(int(x.shape[0]))
        with self._lock:
            self._absorb_trace(trace)
        return out

    # -- continuous batching ------------------------------------------------

    def submit(self, x, *, deadline_s: float | None = None) -> DcnRequest:
        """Enqueue a request (thread-safe): one image (H, W, C) or a batch
        (n, H, W, C) matching the engine's plane. ``deadline_s``
        (relative, engine clock) fails the request if it is still queued
        past the deadline or its step completes past it. With
        ``max_queue`` set, an overfilling submit follows ``queue_policy``:
        ``block`` waits, ``reject`` raises :class:`QueueFullError`,
        ``shed-oldest`` fails the request(s) owning the oldest images.
        ``x`` is a numpy array (an ``ml_dtypes`` bfloat16 one included) or
        a torch tensor, in the params' dtype: it is served in its own
        dtype, as the JAX engine serves it, float64 read as float32;
        images of another dtype fail their request at its step."""
        x = _host_images(x)
        if x.ndim == 3:
            x = x[None]
        g = self.net_graph
        if x.ndim != 4 or x.shape[1:] != (g.in_h, g.in_w, g.in_c):
            raise ValueError(
                f"request images must be (n, {g.in_h}, {g.in_w}, "
                f"{g.in_c}); got {x.shape}")
        if x.shape[0] == 0:
            raise ValueError(
                "empty request: a serving request needs at least one "
                "image")
        if not bool(torch.isfinite(x).all()):
            # NaN/Inf would decode into junk clipped-floor coords and
            # poison the schedule cache with a shared junk digest.
            raise ValueError(
                "request images must be finite: NaN/Inf values poison "
                "the quantized-coords schedule-cache digest")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        n_img = int(x.shape[0])
        with self._queue_room:
            if self.max_queue is not None and n_img > self.max_queue:
                self._m_rejected.inc()
                raise QueueFullError(
                    f"request of {n_img} images exceeds max_queue="
                    f"{self.max_queue}")
            if self.max_queue is not None:
                if self.queue_policy == "reject":
                    if len(self._queue) + n_img > self.max_queue:
                        self._m_rejected.inc()
                        raise QueueFullError(
                            f"queue full ({len(self._queue)}/"
                            f"{self.max_queue} images queued)")
                elif self.queue_policy == "shed-oldest":
                    while len(self._queue) + n_img > self.max_queue:
                        victim = self._queue[0][0]
                        self._m_shed.inc()
                        self._fail_locked(
                            victim,
                            RequestFailedError(
                                victim.rid,
                                cause=QueueFullError(
                                    f"request {victim.rid} shed: queue "
                                    "full, policy shed-oldest")),
                            self._clock())
                else:  # block
                    while len(self._queue) + n_img > self.max_queue:
                        self._queue_room.wait()
            req = DcnRequest(rid=next(self._rid), x=x,
                             submit_s=self._clock(), out=[None] * n_img)
            if deadline_s is not None:
                req.deadline = req.submit_s + deadline_s
            self._m_requests.inc()
            for j in range(n_img):
                self._queue.append((req, j))
        self.tracer.instant("serve.submit", rid=req.rid,
                            images=req.n_images)
        return req

    @property
    def queue_depth(self) -> int:
        """Images waiting for a slot (not yet admitted)."""
        with self._lock:
            return len(self._queue)

    def _admission_order(self) -> list[int]:
        """Free slots in admission order (caller holds the lock).

        Unsharded engines refill lowest-slot-first. Sharded engines
        repeatedly take the replica with the MOST free slots (ties to the
        lowest replica), so step batches stay balanced over the replicas
        and the fullest shard — which sets the slab — stays small."""
        free = [i for i in range(self.n_slots) if self._slots[i] is None]
        if self.replicas <= 1:
            return free
        by_r: list[list[int]] = [[] for _ in range(self.replicas)]
        for i in free:
            by_r[self._slot_replica[i]].append(i)
        order: list[int] = []
        while True:
            r = max(range(self.replicas), key=lambda q: len(by_r[q]))
            if not by_r[r]:
                return order
            order.append(by_r[r].pop(0))

    def _attribute_replicas(self, repl: list[int], traces, image_dram,
                            failures) -> None:
        """Per-replica serving counters for one step (caller holds the
        lock). Images count by slot placement; every replica that served
        an image ran each of the step's dispatches on its own shard; a
        clean coalesced step's per-image DRAM (``image_dram``, one dict a
        trace) comes from its trace's per-image groups (a retried or
        degraded step moves batch positions, so its DRAM stays in the
        engine-wide counters)."""
        dispatches = sum(t.kernel_dispatches for t in traces)
        for k, r in enumerate(repl):
            if k not in failures:
                self._m_replica[r]["images"].inc()
        for r in sorted(set(repl)):
            self._m_replica[r]["dispatches"].inc(dispatches)
        if len(traces) == 1 and not failures:
            for k, r in enumerate(repl):
                self._m_replica[r]["dram_bytes"].inc(
                    image_dram[0].get(k, 0))

    def step(self) -> list[DcnRequest]:
        """One continuous-batching serving step: refill free slots from
        the queue in submit order (expired requests fail at admission;
        a sharded engine fills the replica with the most free slots
        first), then serve all occupied slots with one ``batch_fused``
        grid per layer segment, under the retry/degrade containment of
        :meth:`_execute_isolated`. Returns the requests that resolved this
        step — finished or failed, each exactly once. Images are served in
        their own dtype, the degraded per-image step's and the evicted
        retry's included; a bf16 engine's outputs are host
        ``torch.bfloat16`` tensors, a float32 or float16 engine's numpy
        arrays of its dtype."""
        tr = self.tracer
        if self._faults is not None:
            begin = getattr(self._faults, "begin_step", None)
            if begin is not None:
                begin()
        finished: list[DcnRequest] = []
        with tr.span("serve.admit", queue_depth=self.queue_depth):
            with self._lock:
                now = self._clock()
                for i in self._admission_order():
                    while self._queue:
                        req, j = self._queue.popleft()
                        self._queue_room.notify_all()
                        if req.done:
                            continue   # failed/shed while queued
                        if req.deadline is not None and now > req.deadline:
                            if self._fail_locked(
                                    req, DeadlineExceededError(
                                        req.rid, deadline=req.deadline),
                                    now):
                                finished.append(req)
                            continue
                        self._slots[i] = (req, j)
                        break
                occupied = [(i, s[0], s[1])
                            for i, s in enumerate(self._slots)
                            if s is not None]
        if not occupied:
            return finished
        step_id = self._m_steps.count
        # Slot-ordered, and slots map to replicas contiguously, so the
        # step's batch is shard-contiguous.
        repl = [self._slot_replica[i] for i, _, _ in occupied]
        hits0 = self.cache.info()["image_hits"] if tr.enabled else 0
        mark = len(tr) if tr.enabled else 0
        with tr.timed("serve.step", step=step_id,
                      width=len(occupied)) as ssp:
            outs, traces, failures, degraded = self._execute_isolated(
                [req.x[j] for _, req, j in occupied], repl)
            # Each group's DRAM is a FIFO replay: replay once, per image.
            image_dram = [_image_dram(t) for t in traces]
            dispatches = sum(t.kernel_dispatches for t in traces)
            dram = sum(sum(d.values()) + t.boundary_bytes
                       for d, t in zip(image_dram, traces))
            ssp.set(dispatches=dispatches, dram_bytes=dram,
                    failures=len(failures), degraded=degraded)
        if tr.enabled:
            self.timeline.append({
                "step": step_id,
                "width": len(occupied),
                "wall_s": ssp.dur,
                "dispatches": dispatches,
                "dram_bytes": dram,
                "failures": len(failures),
                "degraded": degraded,
                "image_hits": self.cache.info()["image_hits"] - hits0,
                "schedule_backend": self._step_cfg.schedule_backend,
                "dispatch_spans": [
                    {"name": s.name, "dur_s": s.dur, **s.attrs}
                    for s in tr.spans_since(mark)
                    if s.name.startswith("dispatch.")],
            })
        now = self._clock()
        with self._lock:
            self._m_steps.inc()
            self._m_images.inc(len(occupied))
            for t in traces:
                self._absorb_trace(t)
            self._attribute_replicas(repl, traces, image_dram, failures)
            self.last_step_faulted = bool(failures)
            for k, (i, req, j) in enumerate(occupied):
                self._slots[i] = None
                if req.done:
                    continue   # a step-mate image already failed it
                if k in failures:
                    e = failures[k]
                    err = (e if isinstance(e, RequestFailedError)
                           else RequestFailedError(req.rid, cause=e))
                    if self._fail_locked(req, err, now):
                        finished.append(req)
                    continue
                if k in outs:
                    req.out[j] = outs[k]
                if req.deadline is not None and now > req.deadline:
                    # Mid-flight expiry: computed, but past the deadline.
                    if self._fail_locked(
                            req, DeadlineExceededError(
                                req.rid, deadline=req.deadline), now):
                        finished.append(req)
                    continue
                if all(o is not None for o in req.out):
                    req.done = True
                    req.finish_s = now
                    self.latency.add(now - req.submit_s)
                    finished.append(req)
        return finished

    def drain(self, max_steps: int = 10_000) -> list[DcnRequest]:
        """Serve until queue and slots are empty. Returns every request
        that resolved during the drain, each exactly once; raises
        :class:`DrainTimeout` if ``max_steps`` runs out with work left."""
        finished: list[DcnRequest] = []
        with self.tracer.span("serve.drain") as sp:
            for _ in range(max_steps):
                finished.extend(self.step())
                with self._lock:
                    idle = (not self._queue
                            and all(s is None for s in self._slots))
                if idle:
                    sp.set(finished=len(finished))
                    return finished
            with self._lock:
                stuck = sorted(
                    {req.rid for req, _ in self._queue}
                    | {s[0].rid for s in self._slots if s is not None})
            sp.set(finished=len(finished), stuck=len(stuck))
        if stuck:
            raise DrainTimeout(stuck, finished=finished)
        return finished

    @property
    def stats(self) -> dict[str, Any]:
        """Serving counters, read under the engine lock in one instant."""
        with self._lock:
            info = self.cache.info()
            total = info["hits"] + info["misses"]
            return {
                "requests": self.requests,
                "images": self.images,
                "schedule_cache_hits": info["hits"],
                "schedule_cache_misses": info["misses"],
                "schedule_cache_hit_rate": (info["hits"] / total
                                            if total else 0.0),
                "schedule_cache_size": info["size"],
                "image_hits": info["image_hits"],
                "image_lookups": info["image_lookups"],
                "image_hit_rate": (info["image_hits"]
                                   / info["image_lookups"]
                                   if info["image_lookups"] else 0.0),
                "batch_assemblies": info["batch_assemblies"],
                "kernel_dispatches": self.kernel_dispatches,
                "dispatches_per_batch": (self.kernel_dispatches
                                         / self.requests
                                         if self.requests else 0.0),
                "host_overlap_frac": self.overlap.host_overlap_frac,
                "schedule_backend": self.graph_cfg.schedule_backend,
                "dispatch": self._step_cfg.dispatch,
                "schedule_s": self.overlap.schedule_s,
                "schedule_device_frac": self.overlap.schedule_device_frac,
                "slots": self.n_slots,
                "replicas": self.replicas,
                "per_replica": [
                    {"images": c["images"].count,
                     "dispatches": c["dispatches"].count,
                     "dram_bytes": c["dram_bytes"].count}
                    for c in self._m_replica],
                "allgather_bytes": self._m_allgather.count,
                "queue_depth": len(self._queue),
                "steps": self.steps,
                "host_schedule_builds": self.host_schedule_builds,
                "latency": self.latency.summary(),
                "max_queue": self.max_queue,
                "queue_policy": self.queue_policy,
                "requests_failed": self._m_failed.count,
                "deadline_expired": self._m_deadline.count,
                "queue_rejected": self._m_rejected.count,
                "queue_shed": self._m_shed.count,
                "step_retries": self._m_retries.count,
                "degraded_steps": self._m_degraded.count,
                "watchdog_failovers": self.watchdog_failovers,
                "autotune": self._step_cfg.autotune,
                "plan_cache_hits": self.plan_cache_hits,
                "autotune_search_s": self._autotune_search_s,
                "tuned_groups": self.tuned_groups,
                "device": str(self.device),
            }

    def metrics_snapshot(self) -> dict[str, Any]:
        """Registry counters/histograms plus gauges synced at call time —
        every value ``stats`` reports under a stable name."""
        m = self.metrics
        with self._lock:
            self.cache.publish(m, prefix="schedule_cache")
            m.gauge("serving.queue_depth").set(len(self._queue))
            m.gauge("serving.slots").set(self.n_slots)
            m.gauge("serving.host_schedule_builds").set(
                self.host_schedule_builds)
            m.gauge("serving.watchdog_failovers").set(
                self.watchdog_failovers)
            req = self._m_requests.count
            m.gauge("serving.dispatches_per_batch").set(
                self._m_dispatches.count / req if req else 0.0)
            m.gauge("serving.host_overlap_frac").set(
                self.overlap.host_overlap_frac)
            m.gauge("serving.schedule_s").set(self.overlap.schedule_s)
            m.gauge("serving.schedule_device_frac").set(
                self.overlap.schedule_device_frac)
            m.gauge("serving.plan_cache_hits").set(self.plan_cache_hits)
            m.gauge("serving.autotune_search_s").set(
                self._autotune_search_s)
            m.gauge("serving.tuned_groups").set(self.tuned_groups)
        return m.snapshot()
