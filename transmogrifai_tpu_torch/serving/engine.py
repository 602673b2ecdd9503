"""ScoringEngine — micro-batching over the port's ``ScoreProgram`` (port of
``transmogrifai_tpu/serving/engine.py:199-1184``).

One request at a time, the host sets the pace of a small score: a card
earns its keep only when concurrent requests share one device pass.  The
engine:

* loads a verified bundle (``checkpoint.find_latest_valid`` passes over
  bundles whose digests fail) through ``WorkflowModel.load(path, device)``:
  CUDA unless the caller passes ``device="cpu"``, raising without CUDA;
* warms the score program at a ladder of padded batch sizes (powers of two
  up to ``max_batch``) and pads every batch to its rung.  In the JAX
  package the ladder exists because ``jax.jit`` recompiles for every new
  batch length; in eager PyTorch nothing recompiles, and the ladder fixes
  the caching allocator's block sizes instead (a rung's tensors reuse the
  blocks the warm-up left), keeps responses and counters equal to the JAX
  engine's, and gives a later CUDA-graph capture its fixed shapes;
* runs a continuous micro-batcher thread: the moment the device frees, it
  drains the queue into the largest batch available, up to ``max_batch``
  (no linger: the port has no ``linger_ms``, which the JAX engine accepts
  and ignores);
* scores packed columnar requests (``wire.py``) as host column slices —
  no per-record Python on that path;
* screens every record against the bundle's schema contract
  (``quality.RawSchema``) before it reaches the queue, and every result on
  its way out;
* sheds load (``OverloadedError`` → HTTP 429) through the overload
  controller, bounds each device pass with ``run_with_deadline``, and
  serves a batch the compiled path fails on — or every batch while the
  compiled-path breaker is open, or after a failed warm-up — row at a time
  through ``local.score_function`` on the engine's own device, the same
  kernels included; never on the CPU of a CUDA engine.  Such a batch is
  counted (``fallback_batches_total``), recorded "fallback" or "degraded"
  and reported by ``compiled_path_active`` and ``/readyz``;
* watches the checkpoint root and swaps newer valid versions in, warmed
  before they serve, behind a reload breaker.

Every response is tagged with the version that produced it.

``compiled.build_count()`` stands for the JAX ``compiled.trace_count()``:
``warmup_builds_total`` counts the kernel and native libraries the warm-up
built or first loaded (≙ ``warmup_traces_total``), ``online_builds_total``
those a served batch did (≙ ``online_traces_total``, which should stay 0).
An online build is counted, not demoted: it is paid once, where a JAX
trace would recur on every batch.

The engine records into its own ``failure_log`` (passed in, or a new one):
the port has no ambient log, so its breakers and ``run_with_deadline`` get
it explicitly.  Left out: the drift monitor (``attach_drift_monitor``,
``lifecycle/drift.py``), the tenant scope and its memory budget
(``tenants.py``), and the AOT executables' attributes.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..checkpoint import (bundle_version, find_latest_valid, is_bundle_dir,
                          read_manifest)
from ..columns import Column, ColumnBatch, column_from_values, host_array
from ..compiled import build_count
from ..device import DeviceLike, resolve_device
from ..local import extract_raw_value, score_function
from ..quality import (NON_FINITE_VALUE, QualityConfig, RawSchema,
                       RecordQualityError, Violation, batch_nonfinite_rows,
                       mask_nonfinite_result_arrays, result_nonfinite_fields)
from ..resilience import (FailureLog, WatchdogTimeout, maybe_inject,
                          run_with_deadline)
from ..stages.generator import FeatureGeneratorStage
from ..telemetry import MetricsRegistry, TraceContext, span
from ..types import FeatureType, Prediction
from .overload import (BROWNOUT, OverloadConfig, OverloadController,
                       estimate_batch_bytes)
from .wire import concat_result_arrays, result_arrays


class OverloadedError(RuntimeError):
    """Admission control shed this request (HTTP 429); ``retry_after_s`` is
    the controller's estimate of when to come back."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class EngineClosed(RuntimeError):
    """The engine is draining or closed and accepts no new requests."""


class DeadlineExceeded(RuntimeError):
    """The per-request deadline passed before a result was produced."""


def _padding_ladder(max_batch: int) -> List[int]:
    """Powers of two up to and including ``max_batch``: every batch length
    the engine hands the score program."""
    ladder = []
    size = 1
    while size < max_batch:
        ladder.append(size)
        size *= 2
    ladder.append(int(max_batch))
    return ladder


def records_to_batch(raw_features: Sequence, records: List[Dict[str, Any]]
                     ) -> ColumnBatch:
    """Raw records → raw host ``ColumnBatch`` with the stage-0 semantics of
    ``local.score_function`` (``extract_fn``, the monoid zero of a
    non-nullable kind a record lacks)."""
    cols = {}
    for f in raw_features:
        gen = f.origin_stage
        if isinstance(gen, FeatureGeneratorStage):
            cols[f.name] = gen.extract_column(records)
        else:
            vals = [extract_raw_value(f, r).value for r in records]
            cols[f.name] = column_from_values(f.kind, vals)
    return ColumnBatch(cols, len(records))


class _Request:
    __slots__ = ("record", "event", "result", "error", "t_enqueue", "ctx")

    def __init__(self, record: Dict[str, Any],
                 ctx: Optional[TraceContext] = None):
        self.record = record
        self.event = threading.Event()
        self.result: Optional[Tuple[Dict[str, Any], str]] = None
        self.error: Optional[BaseException] = None
        self.t_enqueue = time.perf_counter()
        self.ctx = ctx


class _ColumnarRequest:
    """A raw ``ColumnBatch`` riding the same queue as record requests: it
    counts ``len(batch)`` rows for admission, and the batcher dispatches it
    alone, in ladder-sized chunks."""

    __slots__ = ("batch", "rows", "event", "result", "error", "t_enqueue",
                 "ctx")

    def __init__(self, batch: ColumnBatch,
                 ctx: Optional[TraceContext] = None):
        self.batch = batch
        self.rows = len(batch)
        self.event = threading.Event()
        self.result: Optional[Tuple[Dict[str, Any], str]] = None
        self.error: Optional[BaseException] = None
        self.t_enqueue = time.perf_counter()
        self.ctx = ctx


class _ModelEntry:
    """One loaded version: the model, its identity, its contract, its
    batch scorer (``score_fn``: the model's ``ScoreProgram``) and its
    row-wise local scorer (the fallback)."""

    def __init__(self, model, bundle_path: str, log: FailureLog):
        self.model = model
        self.bundle_path = bundle_path
        self.version = bundle_version(bundle_path)
        self.score: Callable = model.score_fn()      # batch → scored batch
        self.local_fn: Callable = score_function(model)
        self.result_names = [f.name for f in model.result_features]
        created = None
        try:
            created = (read_manifest(bundle_path) or {}).get("createdAt")
        except Exception as e:  # noqa: BLE001 — an unreadable manifest:
            #                     serve, staleness from the load time
            log.record("serving", "degraded", e, point="serving.manifest",
                       bundle=bundle_path,
                       detail="manifest unreadable; model_staleness_seconds "
                              "falls back to process load time")
        self.created_at: Optional[float] = (
            float(created) if isinstance(created, (int, float)) else None)
        self.loaded_at: float = time.time()
        self.schema: RawSchema = (getattr(model, "raw_schema", None)
                                  or RawSchema.for_model(model, bundle_path,
                                                         log))
        self.sparse: bool = any(
            bool(getattr(st, "metadata", None) and st.metadata.get("sparse"))
            for layer in (getattr(model, "fitted_dag", None) or [])
            for st in layer)


def _host_results(scored: ColumnBatch, names: Sequence[str], n: int
                  ) -> Dict[str, Column]:
    """The first ``n`` rows of the result columns on the host, one copy
    from the device per array."""
    out = {}
    for name in names:
        if name not in scored:
            continue
        c = scored[name]
        if isinstance(c.values, dict):
            vals: Any = {k: host_array(v[:n]) for k, v in c.values.items()}
        elif c.is_host_object():
            vals = c.values[:n]
        else:
            vals = host_array(c.values[:n])
        mask = None if c.mask is None else host_array(c.mask[:n])
        out[name] = Column(c.kind, vals, mask, c.meta)
    return out


def _result_row(cols: Dict[str, Column], i: int) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, col in cols.items():
        v = col.row_value(i)
        if isinstance(v, Prediction):
            out[name] = dict(v.value)
        elif isinstance(v, FeatureType):
            out[name] = v.value
        else:
            out[name] = v
    return out


class ScoringEngine:
    """See the module docstring.  Thread-safe: one batcher thread and an
    optional reload-watcher thread."""

    def __init__(self, model_location: str, *, max_batch: int = 64,
                 queue_bound: int = 256,
                 batch_deadline_s: Optional[float] = 30.0,
                 reload_poll_s: float = 0.0, warm: bool = True,
                 warm_record: Optional[Dict[str, Any]] = None,
                 overload: Optional[OverloadConfig] = None,
                 quality_policy: Optional[str] = None,
                 device: DeviceLike = None,
                 failure_log: Optional[FailureLog] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.device = resolve_device(device)
        self.model_location = model_location
        self.max_batch = int(max_batch)
        self.queue_bound = int(queue_bound)
        self.batch_deadline_s = batch_deadline_s
        self.reload_poll_s = float(reload_poll_s)
        self.ladder = _padding_ladder(self.max_batch)
        self._warm_record = dict(warm_record or {})
        self.quality_policy = (quality_policy if quality_policy is not None
                               else QualityConfig.resolve(None).policy)
        self.failure_log = (failure_log if failure_log is not None
                            else FailureLog())

        self._queue: "collections.deque" = collections.deque()
        self._queued_rows = 0   # rows, not entries (guarded by _cv)
        self._cv = threading.Condition()
        self._closed = False
        self._draining = False
        self._swap_lock = threading.Lock()   # guards self._entry
        self._score_lock = threading.Lock()  # serializes device work
        self._compiled_ok = True

        self.metrics = MetricsRegistry()
        self.request_latency = self.metrics.histogram("request_latency")
        self.batch_latency = self.metrics.histogram("batch_latency")
        self.metrics.gauge("queue_depth", lambda: self.queue_depth)
        self.metrics.gauge("compiled_path_active",
                           lambda: int(self._compiled_ok))
        for name in ("warmup_builds_total", "online_builds_total"):
            self.metrics.counter(name)      # read as 0 before any build
        self.overload = OverloadController(
            overload, queue_bound=lambda: self.queue_bound,
            max_batch=self.max_batch, registry=self.metrics,
            log=self.failure_log)

        # batch observers see every scored (records, results) pair; column
        # observers the columnar path's (ColumnBatch, result arrays)
        self._batch_observers: List[Callable] = []
        self._column_observers: List[Callable] = []

        self._entry = self._load_entry()
        if warm:
            self._warm(self._entry)
        self.overload.refresh_health(queue_depth=0, draining=False,
                                     compiled_ok=self._compiled_ok)

        self._batcher = threading.Thread(
            target=self._batch_loop, name="scoring-batcher", daemon=True)
        self._batcher.start()
        self._watcher: Optional[threading.Thread] = None
        if self.reload_poll_s > 0:
            self._watcher = threading.Thread(
                target=self._watch_loop, name="model-watcher", daemon=True)
            self._watcher.start()

    def _record(self, action: str, cause: Any = None, **detail) -> None:
        self.failure_log.record("serving", action, cause, **detail)

    # -- model lifecycle ---------------------------------------------------
    def _load_entry(self, bundle: Optional[str] = None) -> _ModelEntry:
        from ..workflow import WorkflowModel
        path = bundle
        if path is None:
            path = (self.model_location
                    if is_bundle_dir(self.model_location)
                    else find_latest_valid(self.model_location,
                                           self.failure_log))
        with span("serving.load", bundle=os.path.basename(path)):
            model = WorkflowModel.load(path, device=self.device)
        return _ModelEntry(model, path, self.failure_log)

    def _warm(self, entry: _ModelEntry) -> None:
        """Score a synthetic record at every ladder size, so every batch
        length has run once before traffic.  A model whose compiled path
        fails here serves through the local fallback."""
        with self._score_lock:
            for size in self.ladder:
                records = [dict(self._warm_record) for _ in range(size)]
                try:
                    b0 = build_count()
                    self._score_compiled(entry, records)
                    self.metrics.counter("warmup_builds_total").inc(
                        build_count() - b0)
                except Exception as e:  # noqa: BLE001 — degrade, don't die
                    self._compiled_ok = False
                    self._record("degraded", e, point="serving.batch",
                                 fallback="local row scoring",
                                 detail=f"warmup at batch size {size}")
                    return

    @property
    def model_version(self) -> str:
        with self._swap_lock:
            return self._entry.version

    @property
    def active_bundle_path(self) -> str:
        with self._swap_lock:
            return self._entry.bundle_path

    @property
    def model_staleness_s(self) -> float:
        """Seconds since the active bundle was created (the manifest's
        ``createdAt``, else when this process loaded it)."""
        with self._swap_lock:
            entry = self._entry
        ref = entry.created_at if entry.created_at is not None \
            else entry.loaded_at
        return max(0.0, time.time() - ref)

    @property
    def compiled_path_active(self) -> bool:
        return self._compiled_ok

    @property
    def sparse_model_active(self) -> bool:
        """True when the active bundle vectorizes through the sparse COO
        path."""
        with self._swap_lock:
            return self._entry.sparse

    @property
    def quality_quarantine_fraction(self) -> float:
        """Quarantined records over admitted + quarantined ones."""
        c = self.metrics.counters()
        q = c.get("quality.quarantined_records_total", 0)
        total = c.get("requests_total", 0) + q
        return (q / total) if total else 0.0

    def add_batch_observer(self, fn: Callable) -> None:
        """Run ``fn(records, results)`` after each micro-batch (scored
        records only); its errors are recorded "swallowed"."""
        self._batch_observers.append(fn)

    def add_column_observer(self, fn: Callable) -> None:
        """Run ``fn(batch, result_arrays)`` after each columnar request."""
        self._column_observers.append(fn)

    def reload_now(self) -> bool:
        """Check the checkpoint root once and swap in a newer valid version
        (warmed first); True when a swap happened.  The watcher thread
        calls exactly this."""
        if is_bundle_dir(self.model_location):
            return False         # a fixed bundle: nothing to watch
        try:
            latest = find_latest_valid(self.model_location,
                                       self.failure_log)
        except Exception as e:  # noqa: BLE001 — the root may be mid-write
            self._record("skipped", e, point="serving.reload")
            return False
        with self._swap_lock:
            current = self._entry.version
        if bundle_version(latest) == current:
            return False
        breaker = self.overload.reload_breaker
        if not breaker.allow():
            self.metrics.counter("reload_breaker_skipped_total").inc()
            self._record("skipped", f"reload breaker open; next probe in "
                         f"{breaker.retry_after_s():.1f}s",
                         point="serving.reload", bundle=latest)
            return False
        try:
            maybe_inject("serving.reload", key=bundle_version(latest))
            entry = self._load_entry(latest)
        except Exception as e:  # noqa: BLE001 — keep serving the old model
            breaker.record_failure(e)
            self._record("skipped", e, point="serving.reload", bundle=latest)
            return False
        if self._compiled_ok:
            self._warm(entry)
        with self._swap_lock:
            old = self._entry.version
            self._entry = entry
        breaker.record_success()
        self.metrics.counter("reloads_total").inc()
        self._record("reloaded", None, point="serving.reload",
                     previous=old, current=entry.version)
        return True

    def _watch_loop(self) -> None:
        while not self._closed:
            time.sleep(self.reload_poll_s)
            if self._closed:
                return
            try:
                self.reload_now()
            except Exception as e:  # noqa: BLE001 — the watcher survives
                self._record("swallowed", e, point="serving.reload")

    # -- the data-quality screen (before the queue) ------------------------
    def _quarantine(self, violations: List[Violation],
                    ctx: Optional[TraceContext],
                    point: str = "serving.quality",
                    rows: int = 1) -> RecordQualityError:
        """Account ``rows`` quarantined records and build their error.
        Runs before submit: a rejected record takes no queue slot, no
        admission and no breaker outcome."""
        trace_id = ctx.trace_id if ctx else None
        err = RecordQualityError(violations, self.quality_policy)
        self.metrics.counter("quality.quarantined_records_total").inc(
            rows, trace_id=trace_id)
        self.metrics.counter("dead_letter_total").inc(rows,
                                                      trace_id=trace_id)
        self._record("quarantined", err, point=point, trace_id=trace_id,
                     violations=[v.to_json() for v in violations[:4]])
        return err

    def _screen(self, record: Dict[str, Any],
                ctx: Optional[TraceContext]) -> Dict[str, Any]:
        """The record checked against the active contract: returned (the
        same dict when nothing was coerced), or ``RecordQualityError``."""
        policy = self.quality_policy
        if policy == "off":
            return record
        with self._swap_lock:
            entry = self._entry
        out, violations, rejected = entry.schema.screen_record(record, policy)
        if violations:
            trace_id = ctx.trace_id if ctx else None
            self.metrics.counter("quality.violations_total").inc(
                len(violations), trace_id=trace_id)
            for v in violations:
                self.metrics.counter(
                    f"quality.violations_{v.kind}_total").inc()
            nonfinite = sum(1 for v in violations
                            if v.kind == NON_FINITE_VALUE)
            if nonfinite:
                self.metrics.counter("quality.nonfinite_inputs_total").inc(
                    nonfinite, trace_id=trace_id)
        if rejected:
            raise self._quarantine(violations, ctx)
        return out

    # -- public scoring API ------------------------------------------------
    def score_record(self, record: Dict[str, Any],
                     timeout_s: Optional[float] = None,
                     ctx: Optional[TraceContext] = None
                     ) -> Tuple[Dict[str, Any], str]:
        """Score one record; ``(result, model_version)``.  Blocks until its
        batch completes, the engine closes, or ``timeout_s`` passes
        (``DeadlineExceeded``).  ``RecordQualityError`` before the queue
        when the record fails the contract."""
        record = self._screen(record, ctx)
        req = self._submit(record, deadline_s=timeout_s, ctx=ctx)
        if not req.event.wait(timeout_s):
            raise DeadlineExceeded(
                f"no result within {timeout_s}s (queue depth "
                f"{self.queue_depth})")
        if req.error is not None:
            raise req.error
        self.request_latency.observe(time.perf_counter() - req.t_enqueue,
                                     trace_id=ctx.trace_id if ctx else None)
        self.metrics.counter("responses_total").inc()
        return req.result

    def score_records(self, records: List[Dict[str, Any]],
                      timeout_s: Optional[float] = None,
                      ctx: Optional[TraceContext] = None
                      ) -> List[Tuple[Dict[str, Any], str]]:
        """Score a list: every record rides the same queue as single
        requests, admitted as a whole.  Any record failing the contract
        rejects the list up front with row-tagged violations."""
        if self.quality_policy != "off":
            screened: List[Dict[str, Any]] = []
            bad: List[Violation] = []
            for i, rec in enumerate(records):
                try:
                    screened.append(self._screen(rec, ctx))
                except RecordQualityError as e:
                    for v in e.violations:
                        v.row = i
                    bad.extend(e.violations)
            if bad:
                raise RecordQualityError(bad, self.quality_policy)
            records = screened
        with self._cv:
            self._check_admission(extra=len(records), deadline_s=timeout_s,
                                  ctx=ctx)
            reqs = [_Request(r, ctx=ctx) for r in records]
            self._queue.extend(reqs)
            self._queued_rows += len(reqs)
            self.metrics.counter("requests_total").inc(len(reqs))
            self._cv.notify()
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        out = []
        for req in reqs:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            if not req.event.wait(remaining):
                raise DeadlineExceeded(
                    f"no result within {timeout_s}s for list request")
            if req.error is not None:
                raise req.error
            self.request_latency.observe(
                time.perf_counter() - req.t_enqueue,
                trace_id=ctx.trace_id if ctx else None)
            self.metrics.counter("responses_total").inc()
            out.append(req.result)
        return out

    def score_columns(self, batch: ColumnBatch,
                      timeout_s: Optional[float] = None,
                      ctx: Optional[TraceContext] = None
                      ) -> Tuple[Dict[str, Any], str]:
        """Score a raw host ``ColumnBatch`` (the columnar wire path):
        ``(result_arrays, model_version)``, ``{name: (values, mask)}`` as
        ``wire.result_arrays`` gives.  Admission sees ``len(batch)`` rows;
        rows with a non-finite value at a present position are rejected
        first (``RecordQualityError``) under every policy but ``off``."""
        n = len(batch)
        if n < 1:
            raise ValueError("columnar batch must have at least one row")
        if self.quality_policy != "off":
            with self._swap_lock:
                schema = self._entry.schema
            by_row = batch_nonfinite_rows(batch, schema)
            if by_row:
                trace_id = ctx.trace_id if ctx else None
                flat = [v for vs in by_row.values() for v in vs]
                self.metrics.counter("quality.violations_total").inc(
                    len(flat), trace_id=trace_id)
                self.metrics.counter(
                    f"quality.violations_{NON_FINITE_VALUE}_total").inc(
                    len(flat))
                self.metrics.counter("quality.nonfinite_inputs_total").inc(
                    len(by_row), trace_id=trace_id)
                raise self._quarantine(flat, ctx, rows=len(by_row))
        with self._cv:
            self._check_admission(extra=n, deadline_s=timeout_s, ctx=ctx)
            req = _ColumnarRequest(batch, ctx=ctx)
            self._queue.append(req)
            self._queued_rows += n
            self.metrics.counter("requests_total").inc(n)
            self._cv.notify()
        if not req.event.wait(timeout_s):
            raise DeadlineExceeded(
                f"no result within {timeout_s}s for columnar request of "
                f"{n} rows (queue depth {self.queue_depth})")
        if req.error is not None:
            raise req.error
        self.request_latency.observe(time.perf_counter() - req.t_enqueue,
                                     trace_id=ctx.trace_id if ctx else None)
        self.metrics.counter("responses_total").inc(n)
        return req.result

    @property
    def queue_depth(self) -> int:
        """Queued rows awaiting dispatch."""
        return self._queued_rows

    @property
    def raw_features(self) -> Sequence:
        """The active model's raw features (the wire decoder keys columnar
        bodies by them)."""
        with self._swap_lock:
            return self._entry.model.raw_features

    def _check_admission(self, extra: int = 1,
                         deadline_s: Optional[float] = None,
                         ctx: Optional[TraceContext] = None) -> None:
        if self._closed or self._draining:
            raise EngineClosed("engine is shutting down")
        est_bytes = None
        if self.overload.config.batch_bytes_budget is not None:
            width = len(getattr(self._entry.model, "raw_features",
                                ()) or ()) or 1
            est_bytes = estimate_batch_bytes(self._queued_rows + extra,
                                             width)
        decision = self.overload.admit(self._queued_rows, extra,
                                       deadline_s=deadline_s,
                                       est_bytes=est_bytes)
        if decision is not None:
            trace_id = ctx.trace_id if ctx else None
            self.metrics.counter("shed_total").inc(trace_id=trace_id)
            self.metrics.counter(f"shed_{decision.kind}_total").inc(
                trace_id=trace_id)
            self._record("shed", decision.message, point="serving.admit",
                         kind=decision.kind)
            self.overload.refresh_health(
                queue_depth=self._queued_rows, draining=False,
                compiled_ok=self._compiled_ok)
            raise OverloadedError(decision.message,
                                  retry_after_s=decision.retry_after_s)

    def _submit(self, record: Dict[str, Any],
                deadline_s: Optional[float] = None,
                ctx: Optional[TraceContext] = None) -> _Request:
        with self._cv:
            self._check_admission(deadline_s=deadline_s, ctx=ctx)
            req = _Request(record, ctx=ctx)
            self._queue.append(req)
            self._queued_rows += 1
            self.metrics.counter("requests_total").inc()
            self._cv.notify()
        return req

    # -- the continuous micro-batcher --------------------------------------
    def _batch_loop(self) -> None:
        """The instant the previous dispatch returns, drain whatever is
        queued now into one batch (up to ``max_batch``) and dispatch it; a
        columnar request is dispatched alone."""
        while True:
            columnar: Optional[_ColumnarRequest] = None
            batch: List[_Request] = []
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait(0.05)
                if not self._queue:
                    if self._closed:
                        return
                    continue
                head = self._queue.popleft()
                if isinstance(head, _ColumnarRequest):
                    self._queued_rows -= head.rows
                    columnar = head
                else:
                    batch.append(head)
                    self._queued_rows -= 1
                    while (len(batch) < self.max_batch and self._queue
                           and not isinstance(self._queue[0],
                                              _ColumnarRequest)):
                        batch.append(self._queue.popleft())
                        self._queued_rows -= 1
            if columnar is not None:
                self._process_columnar(columnar)
            else:
                self._process(batch)

    def _compiled(self, fn, entry: _ModelEntry, payload, rows: int,
                  links: List[TraceContext], description: str):
        """``fn(entry, payload)`` on the compiled path under the breaker
        and the batch deadline; None when the batch must take the local
        fallback (breaker open, demoted, or the call failed)."""
        use_compiled = self._compiled_ok \
            and self.overload.compiled_breaker.allow()
        if self._compiled_ok and not use_compiled:
            self.metrics.counter("breaker_demoted_batches_total").inc()
        if not use_compiled:
            return None
        try:
            with self._score_lock:
                before = build_count()
                maybe_inject("serving.batch", key=int(
                    self.metrics.counter("batches_total").value))
                with span("serving.execute",
                          ctx=links[0].child() if links else None,
                          links=links, rows=rows):
                    out = run_with_deadline(
                        fn, self.batch_deadline_s, entry, payload,
                        description=description, log=self.failure_log)
                built = build_count() - before
            self.overload.compiled_breaker.record_success()
            if built > 0:
                self.metrics.counter("online_builds_total").inc(built)
            return out
        except WatchdogTimeout as e:
            self.overload.compiled_breaker.record_failure(e)
            self._record("fallback", e, point="serving.batch",
                         fallback="local row scoring")
            self.metrics.counter("batch_deadline_total").inc()
        except Exception as e:  # noqa: BLE001 — per-record fallback
            self.overload.compiled_breaker.record_failure(e)
            self._record("fallback", e, point="serving.batch",
                         fallback="local row scoring")
        return None

    def _finish_batch(self, rows: int, t0: float) -> str:
        self.metrics.counter("batches_total").inc()
        self.metrics.counter("batch_rows_total").inc(rows)
        batch_s = time.perf_counter() - t0
        self.batch_latency.observe(batch_s)
        self.overload.observe_batch(batch_s)
        return self.overload.refresh_health(
            queue_depth=self.queue_depth,
            draining=self._draining or self._closed,
            compiled_ok=self._compiled_ok)

    def _process(self, batch: List[_Request]) -> None:
        # the batch span adopts the first linked request's trace and links
        # every request it serves
        links = [r.ctx for r in batch if r.ctx is not None]
        with span("serving.batch", ctx=links[0].child() if links else None,
                  links=links, rows=len(batch)):
            self._process_inner(batch, links)

    def _process_inner(self, batch: List[_Request],
                       links: List[TraceContext]) -> None:
        with self._swap_lock:
            entry = self._entry
        records = [r.record for r in batch]
        t0 = time.perf_counter()
        results: Optional[List[Any]] = self._compiled(
            self._score_compiled, entry, records, len(records), links,
            f"serving micro-batch of {len(records)}")
        if results is None:
            self.metrics.counter("fallback_batches_total").inc()
            results = []
            for req, rec in zip(batch, records):
                try:
                    results.append(entry.local_fn(rec))
                except Exception as e:  # noqa: BLE001 — isolate bad records
                    # unservable by either path: a serving dead letter
                    trace_id = req.ctx.trace_id if req.ctx else None
                    self.metrics.counter("dead_letter_total").inc(
                        trace_id=trace_id)
                    self._record("dead_letter", e, point="serving.batch",
                                 trace_id=trace_id)
                    results.append(e)
        if self.quality_policy != "off":
            # output screen: a non-finite score dead-letters its row (422
            # to that caller); neighbours keep their results
            for idx, (req, res) in enumerate(zip(batch, results)):
                if isinstance(res, BaseException):
                    continue
                bad = result_nonfinite_fields(res)
                if not bad:
                    continue
                trace_id = req.ctx.trace_id if req.ctx else None
                self.metrics.counter("quality.nonfinite_scores_total").inc(
                    trace_id=trace_id)
                self.metrics.counter("quality.violations_total").inc(
                    len(bad), trace_id=trace_id)
                self.metrics.counter(
                    f"quality.violations_{NON_FINITE_VALUE}_total").inc(
                    len(bad))
                self.metrics.counter("quality.quarantined_records_total"
                                     ).inc(trace_id=trace_id)
                self.metrics.counter("dead_letter_total").inc(
                    trace_id=trace_id)
                err = RecordQualityError(
                    [Violation(NON_FINITE_VALUE, f,
                               "model produced a non-finite score")
                     for f in bad], self.quality_policy)
                self._record("quarantined", err, point="serving.quality",
                             trace_id=trace_id, fields=bad[:4])
                results[idx] = err
        health = self._finish_batch(len(batch), t0)
        if self._batch_observers and health == BROWNOUT:
            # brownout sheds optional work before any user traffic
            self.metrics.counter("brownout_sheds_total").inc()
        elif self._batch_observers:
            ok = [(req.record, res) for req, res in zip(batch, results)
                  if not isinstance(res, BaseException)]
            if ok:
                for fn in list(self._batch_observers):
                    try:
                        fn([r for r, _ in ok], [o for _, o in ok])
                    except Exception as e:  # noqa: BLE001 — observability
                        self._record("swallowed", e, point="serving.batch")
        for req, res in zip(batch, results):
            if isinstance(res, BaseException):
                req.error = res
                self.metrics.counter("errors_total").inc()
            else:
                req.result = (res, entry.version)
            req.event.set()

    def _score_compiled(self, entry: _ModelEntry,
                        records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """One padded pass: pad to the ladder, score through the model's
        ``ScoreProgram`` on its device, copy each result array back once,
        cut the real rows out."""
        n = len(records)
        size = next(s for s in self.ladder if s >= n)
        padded = records + [dict(self._warm_record)
                            for _ in range(size - n)]
        batch = records_to_batch(entry.model.raw_features, padded)
        cols = _host_results(entry.score(batch), entry.result_names, n)
        return [_result_row(cols, i) for i in range(n)]

    # -- the columnar path -------------------------------------------------
    @staticmethod
    def _slice_columns(batch: ColumnBatch, lo: int, hi: int) -> ColumnBatch:
        """Rows [lo, hi) as array views."""
        cols = {}
        for name, c in batch.items():
            mask = None if c.mask is None else c.mask[lo:hi]
            cols[name] = Column(c.kind, c.values[lo:hi], mask=mask,
                                meta=c.meta)
        return ColumnBatch(cols, hi - lo)

    @staticmethod
    def _pad_columns(batch: ColumnBatch, size: int) -> ColumnBatch:
        """Pad to a ladder rung by repeating the last row (scoring is row
        independent and the pad rows are cut off the result)."""
        n = len(batch)
        if size == n:
            return batch
        pad = size - n
        cols = {}
        for name, c in batch.items():
            vals = np.concatenate([c.values,
                                   np.repeat(c.values[-1:], pad, axis=0)])
            mask = None if c.mask is None else np.concatenate(
                [c.mask, np.repeat(c.mask[-1:], pad)])
            cols[name] = Column(c.kind, vals, mask=mask, meta=c.meta)
        return ColumnBatch(cols, size)

    def _score_columns_compiled(self, entry: _ModelEntry, chunk: ColumnBatch
                                ) -> Dict[str, Any]:
        n = len(chunk)
        size = next(s for s in self.ladder if s >= n)
        scored = entry.score(self._pad_columns(chunk, size))
        return result_arrays(scored, entry.result_names, n)

    def _local_fallback_columns(self, entry: _ModelEntry, chunk: ColumnBatch,
                                ctx: Optional[TraceContext] = None
                                ) -> Dict[str, Any]:
        """Row-at-a-time local scoring of a columnar chunk.  A row that
        fails here too is a dead letter and fails the whole request (arrays
        cannot carry a per-row exception)."""
        rows = []
        for i in range(len(chunk)):
            rec = {name: c.row_value(i).value for name, c in chunk.items()}
            try:
                row = entry.local_fn(rec)
            except Exception as e:
                trace_id = ctx.trace_id if ctx else None
                self.metrics.counter("dead_letter_total").inc(
                    trace_id=trace_id)
                self._record("dead_letter", e, point="serving.batch", row=i,
                             trace_id=trace_id)
                raise
            flat: Dict[str, Any] = {}
            for name, v in row.items():
                if isinstance(v, dict):
                    for k2, v2 in v.items():
                        flat[f"{name}.{k2}"] = v2
                else:
                    flat[name] = v
            rows.append(flat)
        keys = list(dict.fromkeys(k for r in rows for k in r))
        out: Dict[str, Any] = {}
        for k in keys:
            vals = [r.get(k) for r in rows]
            if any(isinstance(v, str) for v in vals):
                out[k] = (np.array(vals, dtype=object), None)
            else:
                mask = np.array([v is not None for v in vals], dtype=bool)
                arr = np.array([0.0 if v is None else float(v)
                                for v in vals], dtype=np.float64)
                out[k] = (arr, None if mask.all() else mask)
        return out

    def _process_columnar(self, req: _ColumnarRequest) -> None:
        links = [req.ctx] if req.ctx is not None else []
        with span("serving.batch", ctx=links[0].child() if links else None,
                  links=links, rows=req.rows, columnar=True):
            try:
                self._process_columnar_inner(req, links)
            except BaseException as e:  # noqa: BLE001 — fail the request,
                #                         never the batcher thread
                self.metrics.counter("errors_total").inc()
                req.error = e
                req.event.set()

    def _process_columnar_inner(self, req: _ColumnarRequest,
                                links: List[TraceContext]) -> None:
        with self._swap_lock:
            entry = self._entry
        chunks: List[Dict[str, Any]] = []
        health = None
        for lo in range(0, req.rows, self.max_batch):
            hi = min(lo + self.max_batch, req.rows)
            chunk = self._slice_columns(req.batch, lo, hi)
            t0 = time.perf_counter()
            arrays = self._compiled(
                self._score_columns_compiled, entry, chunk, hi - lo, links,
                f"serving columnar chunk of {hi - lo}")
            if arrays is None:
                self.metrics.counter("fallback_batches_total").inc()
                arrays = self._local_fallback_columns(entry, chunk,
                                                      ctx=req.ctx)
            if self.quality_policy != "off":
                # arrays cannot carry a per-row error: non-finite score
                # cells are masked absent and counted
                arrays, bad_rows = mask_nonfinite_result_arrays(arrays)
                nbad = int(np.asarray(bad_rows).sum())
                if nbad:
                    trace_id = req.ctx.trace_id if req.ctx else None
                    self.metrics.counter(
                        "quality.nonfinite_scores_total").inc(
                        nbad, trace_id=trace_id)
                    self.metrics.counter("dead_letter_total").inc(
                        nbad, trace_id=trace_id)
                    self._record(
                        "quarantined",
                        f"{nbad} non-finite score row(s) masked absent",
                        point="serving.quality", trace_id=trace_id,
                        rows=[int(i) + lo for i in
                              np.nonzero(np.asarray(bad_rows))[0][:8]])
            health = self._finish_batch(hi - lo, t0)
            chunks.append(arrays)
        merged = concat_result_arrays(chunks)
        if self._column_observers and health == BROWNOUT:
            self.metrics.counter("brownout_sheds_total").inc()
        elif self._column_observers:
            for fn in list(self._column_observers):
                try:
                    fn(req.batch, merged)
                except Exception as e:  # noqa: BLE001 — observability
                    self._record("swallowed", e, point="serving.batch")
        elif self._batch_observers:
            # record observers would need per-row dicts: skipped, counted
            self.metrics.counter("columnar_observer_skips_total").inc(
                req.rows)
        req.result = (merged, entry.version)
        req.event.set()

    # -- metrics / shutdown ------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._swap_lock:
            version = self._entry.version
        return {"counters": self.metrics.counters(),
                "queue_depth": self.queue_depth,
                "device": str(self.device),
                "quality_policy": self.quality_policy,
                "quality_quarantine_fraction":
                    self.quality_quarantine_fraction,
                "model_version": version,
                "compiled_path_active": self._compiled_ok,
                "failures": self.failure_log.summary(),
                "overload": self.overload.snapshot(),
                "request_latency": self.request_latency.snapshot(),
                "batch_latency": self.batch_latency.snapshot()}

    def close(self, drain: bool = True,
              timeout_s: Optional[float] = 30.0) -> None:
        """Stop accepting requests; with ``drain`` the batcher finishes
        what is queued before its thread exits (the SIGTERM path)."""
        self.overload.refresh_health(queue_depth=self.queue_depth,
                                     draining=True,
                                     compiled_ok=self._compiled_ok)
        with self._cv:
            self._draining = True
            if not drain:
                for req in self._queue:
                    req.error = EngineClosed("engine closed before scoring")
                    req.event.set()
                self._queue.clear()
                self._queued_rows = 0
            self._cv.notify_all()
        if drain:
            deadline = (time.monotonic() + timeout_s
                        if timeout_s is not None else None)
            while self._queue:
                if deadline is not None and time.monotonic() > deadline:
                    break
                time.sleep(0.005)
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._batcher.join(timeout=5.0)
