"""Stdlib HTTP front end for the ScoringEngine (port of
``transmogrifai_tpu/serving/server.py``, single-bundle serving).

Endpoints:

* ``POST /v1/score`` — body ``{...record...}`` or ``[{...}, ...]``;
  response ``{"modelVersion": v, "result": {...}}`` or
  ``{"modelVersion": v, "results": [...]}`` (a list response carries the
  version that served its first record; per-item versions are in
  ``results[i]["_modelVersion"]`` only when a hot swap landed mid-list).
  400 on a malformed body, 422 with the violations when a record fails the
  schema contract, 429 + ``Retry-After`` under shed load, 504 on deadline,
  503 while draining.

  With ``Content-Type: application/x-transmogrifai-columnar`` the body is
  the packed columnar format (``wire.py``) and so is the response, with the
  model version in ``X-Model-Version``; 415 when the server was started
  with ``wire_format="json"``.
* ``GET /healthz`` — liveness: 200 while the process answers, with the
  health state (``SERVING`` / ``DEGRADED`` / ``BROWNOUT`` / ``DRAINING``)
  and its reason.
* ``GET /readyz`` — 200 only when the model is loaded, the compiled-path
  breaker is not open and the server is not draining; 503 +
  ``Retry-After`` otherwise.
* ``GET /metrics`` — Prometheus text: request and batch counters, queue
  depth, overload, breaker and health families, data-quality families and
  latency summaries with p50 / p95 / p99.  ``online_builds_total`` stands
  where the JAX server has ``online_traces_total`` (see ``engine.py``).

``start_server(..., device=None)`` serves on CUDA unless the caller passes
``device="cpu"``; ``serve_main`` runs under ``preemption_guard``: SIGTERM
stops the accept loop, drains the queued batches, then returns.

Left out with ``tenants.py``, ``pool.py`` and the AOT registry:
``/v1/score/<tenant>``, the ``X-Model-Id`` route, the registry endpoints,
the ``model_root``, tenant and ``reuse_port`` arguments, and the families
read from the JAX package's process registry (XLA compile, AOT and registry, racing, host-link, sparse
transform volumes, drift, lifecycle and the streaming dead-letter queue).
"""

from __future__ import annotations

import json
import math
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from ..checkpoint import (bundle_version, preemption_guard,
                          shutdown_requested)
from ..device import DeviceLike
from ..quality import VIOLATION_KINDS, RecordQualityError
from ..resilience import CircuitBreaker, WatchdogTimeout
from ..telemetry import TraceContext, span
from . import wire
from .engine import (DeadlineExceeded, EngineClosed, OverloadedError,
                     ScoringEngine)
from .overload import HEALTH_CODES, OverloadConfig

_METRIC_PREFIX = "transmogrifai_serving"

_BREAKER_CODES = {CircuitBreaker.CLOSED: 0, CircuitBreaker.HALF_OPEN: 1,
                  CircuitBreaker.OPEN: 2}


def _retry_after(seconds: float) -> str:
    """HTTP Retry-After is whole seconds; never advertise less than 1."""
    try:
        return str(max(1, int(math.ceil(float(seconds)))))
    except (TypeError, ValueError):
        return "1"


def render_metrics(engine: ScoringEngine) -> str:
    """The engine's stats in Prometheus text exposition format."""
    s = engine.stats()
    lines: List[str] = []

    def _exemplar_suffix(ex) -> str:
        """OpenMetrics exemplar: `` # {trace_id="..."} value`` appended to
        a sample line — Prometheus/Grafana link the sample to the trace."""
        if not ex:
            return ""
        return f' # {{trace_id="{ex["traceId"]}"}} {ex["value"]:.6g}'

    def counter(name: str, value, help_: str, exemplar=None) -> None:
        full = f"{_METRIC_PREFIX}_{name}"
        lines.append(f"# HELP {full} {help_}")
        lines.append(f"# TYPE {full} counter")
        lines.append(f"{full} {value}{_exemplar_suffix(exemplar)}")

    def gauge(name: str, value, help_: str) -> None:
        full = f"{_METRIC_PREFIX}_{name}"
        lines.append(f"# HELP {full} {help_}")
        lines.append(f"# TYPE {full} gauge")
        lines.append(f"{full} {value}")

    c = s["counters"]
    counter("requests_total", c.get("requests_total", 0),
            "Records accepted into the scoring queue")
    counter("responses_total", c.get("responses_total", 0),
            "Records scored and returned")
    counter("errors_total", c.get("errors_total", 0),
            "Records that failed to score")
    counter("shed_total", c.get("shed_total", 0),
            "Requests shed by admission control (HTTP 429)",
            exemplar=engine.metrics.counter("shed_total").exemplar())
    counter("batches_total", c.get("batches_total", 0),
            "Coalesced micro-batches dispatched")
    counter("batch_rows_total", c.get("batch_rows_total", 0),
            "Records across all dispatched micro-batches")
    counter("fallback_batches_total", c.get("fallback_batches_total", 0),
            "Micro-batches served by the local row path")
    counter("reloads_total", c.get("reloads_total", 0),
            "Hot model reloads performed")
    counter("online_builds_total", c.get("online_builds_total", 0),
            "Kernel or native libraries built or first loaded by traffic "
            "after warmup (should be 0)")
    counter("dead_letter_total", c.get("dead_letter_total", 0),
            "Records unservable by both the compiled and local paths")
    counter("columnar_observer_skips_total",
            c.get("columnar_observer_skips_total", 0),
            "Rows that bypassed batch observers on the columnar path")
    # data-quality firewall families (quality.py): violation volume by
    # kind, quarantine volume and non-finite interceptions at both seams —
    # the violation counter carries a trace-id exemplar so one bad record
    # links straight to its request trace
    counter("quality_violations_total", c.get("quality.violations_total", 0),
            "Schema-contract violations observed across all records",
            exemplar=engine.metrics.counter(
                "quality.violations_total").exemplar())
    kind_family = f"{_METRIC_PREFIX}_quality_violations_by_kind_total"
    lines.append(f"# HELP {kind_family} Schema-contract violations by "
                 "taxonomy kind")
    lines.append(f"# TYPE {kind_family} counter")
    for kind in VIOLATION_KINDS:
        v = c.get(f"quality.violations_{kind}_total", 0)
        lines.append(f'{kind_family}{{kind="{kind}"}} {v}')
    counter("quality_quarantined_records_total",
            c.get("quality.quarantined_records_total", 0),
            "Records quarantined (HTTP 422) by the data-quality firewall",
            exemplar=engine.metrics.counter(
                "quality.quarantined_records_total").exemplar())
    counter("quality_nonfinite_inputs_total",
            c.get("quality.nonfinite_inputs_total", 0),
            "Records/rows rejected at the host-to-device seam for "
            "non-finite input values")
    counter("quality_nonfinite_scores_total",
            c.get("quality.nonfinite_scores_total", 0),
            "Scored rows intercepted because the model produced a "
            "non-finite score")
    gauge("quality_quarantine_fraction",
          round(engine.quality_quarantine_fraction, 6),
          "Quarantined records over all offered records since start")
    gauge("queue_depth", s["queue_depth"],
          "Requests currently waiting for a micro-batch")
    gauge("compiled_path_active", int(s["compiled_path_active"]),
          "1 when batches go through the score program")
    gauge("sparse_model_active", int(engine.sparse_model_active),
          "1 when the active bundle vectorizes text through the sparse "
          "COO path")
    gauge("model_staleness_seconds", round(engine.model_staleness_s, 3),
          "Seconds since the active bundle was created")
    # overload control plane: health state machine, adaptive admission and
    # both circuit breakers
    ov = s.get("overload") or {}
    health = ov.get("health") or {}
    gauge("health_state", HEALTH_CODES.get(health.get("state"), 0),
          "Engine health: 0 SERVING / 1 DEGRADED / 2 BROWNOUT / 3 DRAINING")
    state_name = health.get("state", "SERVING")
    lines.append(f"# HELP {_METRIC_PREFIX}_health_info Current health "
                 "state and transition reason")
    lines.append(f"# TYPE {_METRIC_PREFIX}_health_info gauge")
    lines.append(f'{_METRIC_PREFIX}_health_info{{state="{state_name}",'
                 f'reason={json.dumps(health.get("reason", ""))}}} 1')
    gauge("admission_limit", ov.get("admission_limit", 0),
          "Queue slots currently granted by the adaptive AIMD limit "
          "(queue_bound is its ceiling)")
    counter("shed_limit_total", c.get("shed_limit_total", 0),
            "Requests shed because the queue passed the admission limit",
            exemplar=engine.metrics.counter("shed_limit_total").exemplar())
    counter("shed_deadline_total", c.get("shed_deadline_total", 0),
            "Requests shed because the queue wait would blow their "
            "deadline",
            exemplar=engine.metrics.counter(
                "shed_deadline_total").exemplar())
    counter("shed_memory_total", c.get("shed_memory_total", 0),
            "Requests shed because the estimated queued-batch footprint "
            "exceeded the device memory budget (batchBytesBudget)",
            exemplar=engine.metrics.counter("shed_memory_total").exemplar())
    counter("brownout_sheds_total", c.get("brownout_sheds_total", 0),
            "Batch-observer runs skipped while in BROWNOUT")
    counter("health_transitions_total", c.get("health_transitions_total", 0),
            "Health state machine transitions")
    for short, brk in (("compiled", ov.get("compiled_breaker") or {}),
                       ("reload", ov.get("reload_breaker") or {})):
        gauge(f"{short}_breaker_state",
              _BREAKER_CODES.get(brk.get("state"), 0),
              f"The {short} circuit breaker: 0 closed / 1 half-open / "
              "2 open")
        name = brk.get("name", "")
        for transition in ("open", "half_open", "closed"):
            counter(f"{short}_breaker_{transition}_transitions_total",
                    c.get(f"breaker.{name}.{transition}_total", 0),
                    f"Times the {short} breaker entered {transition}")
    counter("breaker_demoted_batches_total",
            c.get("breaker_demoted_batches_total", 0),
            "Micro-batches routed to the local fallback because the "
            "compiled-path breaker was open")
    counter("reload_breaker_skipped_total",
            c.get("reload_breaker_skipped_total", 0),
            "Hot-reload attempts skipped while the reload breaker was open")
    lines.append(f"# HELP {_METRIC_PREFIX}_model_info Serving model version")
    lines.append(f"# TYPE {_METRIC_PREFIX}_model_info gauge")
    lines.append(f'{_METRIC_PREFIX}_model_info'
                 f'{{version="{s["model_version"]}"}} 1')
    for hist_name, hist, snap in (
            ("request_latency_seconds", engine.request_latency,
             s["request_latency"]),
            ("batch_latency_seconds", engine.batch_latency,
             s["batch_latency"])):
        full = f"{_METRIC_PREFIX}_{hist_name}"
        lines.append(f"# HELP {full} End-to-end latency summary")
        lines.append(f"# TYPE {full} summary")
        # the slowest-bucket exemplar rides the highest quantile: a p99
        # spike in Prometheus links straight to a concrete request trace
        slow_ex = hist.exemplar(slowest=True)
        for q in ("0.5", "0.95", "0.99"):
            key = "p" + q.replace("0.", "").ljust(2, "0")
            v = snap.get(key)
            if v is not None:
                suffix = _exemplar_suffix(slow_ex) if q == "0.99" else ""
                lines.append(f'{full}{{quantile="{q}"}} {v:.6g}{suffix}')
        lines.append(f"{full}_sum {snap['sum']:.6g}")
        lines.append(f"{full}_count {snap['count']}"
                     f"{_exemplar_suffix(hist.exemplar())}")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: "ScoringHTTPServer"

    # quiet by default; the engine's FailureLog is the observability channel
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def _request_context(self) -> TraceContext:
        """The per-request W3C position: continue the client's trace when
        it sent a valid ``traceparent``, start a fresh one otherwise.  A
        malformed or oversized header parses to None and falls through to
        a fresh context — never an error."""
        parent = TraceContext.parse(self.headers.get("traceparent"))
        ctx = parent.child() if parent else TraceContext.new()
        self._req_ctx = ctx
        self._req_span = None
        return ctx

    def _reply(self, code: int, payload: Any,
               content_type: str = "application/json",
               extra_headers: Optional[Dict[str, str]] = None) -> None:
        body = (payload if isinstance(payload, bytes)
                else json.dumps(payload).encode()
                if content_type == "application/json"
                else str(payload).encode())
        ctx: Optional[TraceContext] = getattr(self, "_req_ctx", None)
        if ctx is None:
            ctx = self._request_context()
        sp = getattr(self, "_req_span", None)
        if sp is not None:
            sp.attrs.setdefault("httpStatus", code)
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        # EVERY response — including 400/415/429/503/504 sheds — carries
        # the request's trace position, so a client can correlate any
        # outcome with the server-side trace
        self.send_header("traceparent", ctx.to_traceparent())
        self.send_header("X-Request-Id", ctx.trace_id)
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away; nothing to salvage

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        self._request_context()
        engine = self.server.engine
        if self.path == "/healthz":
            # liveness, not readiness: a draining process is still alive
            # (restarting it would abort the drain) — /readyz is the probe
            # that takes it out of rotation
            health = engine.overload.health.snapshot()
            status = ("draining" if self.server.draining else "ok")
            self._reply(200, {"status": status,
                              "health": health["state"],
                              "healthReason": health["reason"],
                              "modelVersion": engine.model_version,
                              "bundleVersion": bundle_version(
                                  engine.active_bundle_path),
                              "modelStalenessS": round(
                                  engine.model_staleness_s, 3),
                              "queueDepth": engine.queue_depth,
                              "qualityPolicy": engine.quality_policy,
                              "qualityQuarantineFraction": round(
                                  engine.quality_quarantine_fraction, 6)})
        elif self.path == "/readyz":
            health = engine.overload.health.snapshot()
            breaker = engine.overload.compiled_breaker
            reasons: List[str] = []
            if self.server.draining or health["state"] == "DRAINING":
                reasons.append("draining")
            if breaker.current_state() == breaker.OPEN:
                reasons.append("compiled-path breaker open")
            if not reasons:
                self._reply(200, {"ready": True,
                                  "health": health["state"],
                                  "modelVersion": engine.model_version})
            else:
                retry = (breaker.retry_after_s()
                         if "compiled-path breaker open" in reasons
                         and not self.server.draining else 30.0)
                self._reply(503, {"ready": False,
                                  "health": health["state"],
                                  "reasons": reasons},
                            extra_headers={
                                "Retry-After": _retry_after(retry)})
        elif self.path == "/metrics":
            self._reply(200, render_metrics(engine).encode(),
                        content_type="text/plain; version=0.0.4")
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self) -> None:  # noqa: N802
        ctx = self._request_context()
        if self.path != "/v1/score":
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length)
        ctype = (self.headers.get("Content-Type") or
                 "").split(";")[0].strip().lower()
        timeout_s = self.server.request_deadline_s
        columnar = ctype == wire.CONTENT_TYPE
        # the request span is pinned to the request's W3C position, so the
        # engine's batch span, which links back to it, shares its trace id
        with span("serving.request", ctx=ctx,
                  wire="columnar" if columnar else "json") as req_sp:
            self._req_span = req_sp
            if columnar:
                self._post_columnar(self.server.engine, body, timeout_s, ctx)
            else:
                self._post_json(self.server.engine, body, timeout_s, ctx)

    def _post_columnar(self, engine: ScoringEngine, body: bytes,
                       timeout_s: Optional[float],
                       ctx: TraceContext) -> None:
        if self.server.wire_format == "json":
            self._reply(415, {"error": "columnar wire format is "
                                       "disabled on this server "
                                       "(wire_format=json); send JSON"})
            return
        try:
            batch = wire.decode_batch(body, engine.raw_features)
            arrays, version = engine.score_columns(batch, timeout_s,
                                                   ctx=ctx)
            out = wire.encode_result_arrays(arrays, len(batch))
            self._reply(200, out, content_type=wire.CONTENT_TYPE,
                        extra_headers={"X-Model-Version": version})
        except wire.WireFormatError as e:
            # malformed body = client bug, never a worker crash: a
            # structured 400 names exactly what failed to parse — with the
            # quality-taxonomy kind when the decoder could classify it
            detail: Dict[str, Any] = {"error": "malformed columnar body",
                                      "detail": str(e)}
            kind = getattr(e, "violation_kind", None)
            if kind:
                detail["violationKind"] = kind
            self._reply(400, detail)
        except RecordQualityError as e:
            # rows identified by the firewall: 422 with the per-row
            # violation list; other queued requests scored normally
            self._reply(422, {
                "error": "record failed data-quality validation",
                "policy": e.policy, "violations": e.to_json()})
        except OverloadedError as e:
            self._reply(429, {"error": str(e)},
                        extra_headers={"Retry-After": _retry_after(
                            getattr(e, "retry_after_s", 1.0))})
        except (DeadlineExceeded, WatchdogTimeout) as e:
            self._reply(504, {"error": str(e)})
        except EngineClosed as e:
            self._reply(503, {"error": str(e)},
                        extra_headers={"Retry-After": "30"})
        except Exception as e:  # noqa: BLE001 — see JSON path below
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    def _post_json(self, engine: ScoringEngine, body: bytes,
                   timeout_s: Optional[float], ctx: TraceContext) -> None:
        try:
            payload = json.loads(body or b"null")
        except (ValueError, TypeError) as e:
            self._reply(400, {"error": f"invalid JSON body: {e}"})
            return
        self._score_json(engine, payload, timeout_s, ctx)

    def _score_json(self, engine: ScoringEngine, payload: Any,
                    timeout_s: Optional[float], ctx: TraceContext) -> None:
        try:
            if isinstance(payload, dict):
                result, version = engine.score_record(payload, timeout_s,
                                                      ctx=ctx)
                self._reply(200, {"modelVersion": version, "result": result})
            elif isinstance(payload, list):
                if not all(isinstance(r, dict) for r in payload):
                    self._reply(400, {"error": "list items must be objects"})
                    return
                pairs = engine.score_records(payload, timeout_s, ctx=ctx)
                versions = {v for _, v in pairs}
                out: Dict[str, Any] = {
                    "modelVersion": pairs[0][1] if pairs else
                    engine.model_version,
                    "results": [r for r, _ in pairs]}
                if len(versions) > 1:   # a hot swap landed mid-list
                    for (r, v), slot in zip(pairs, out["results"]):
                        slot["_modelVersion"] = v
                self._reply(200, out)
            else:
                self._reply(400, {"error": "body must be an object or a "
                                           "list of objects"})
        except RecordQualityError as e:
            # the poison record (or the offending rows of a list, tagged
            # with their index) gets its own structured 422; co-batched
            # neighbors in other requests score normally
            self._reply(422, {
                "error": "record failed data-quality validation",
                "policy": e.policy, "violations": e.to_json()})
        except OverloadedError as e:
            self._reply(429, {"error": str(e)},
                        extra_headers={"Retry-After": _retry_after(
                            getattr(e, "retry_after_s", 1.0))})
        except (DeadlineExceeded, WatchdogTimeout) as e:
            self._reply(504, {"error": str(e)})
        except EngineClosed as e:
            self._reply(503, {"error": str(e)},
                        extra_headers={"Retry-After": "30"})
        except Exception as e:  # noqa: BLE001 — a bad record must not 500
            #                     the whole connection with a stack trace
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})


class ScoringHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer bound to a ScoringEngine."""

    daemon_threads = True
    allow_reuse_address = True
    # socketserver's default listen backlog of 5 resets connections under a
    # burst of concurrent clients; serving is exactly that workload
    request_queue_size = 128

    def __init__(self, engine: ScoringEngine, host: str = "127.0.0.1",
                 port: int = 8180,
                 request_deadline_s: Optional[float] = 30.0,
                 wire_format: str = "auto"):
        super().__init__((host, port), _Handler)
        self.engine = engine
        self.request_deadline_s = request_deadline_s
        self.wire_format = wire_format  # "auto" | "json" (columnar → 415)
        self.draining = False

    @property
    def port(self) -> int:
        return self.server_address[1]

    def drain_and_close(self, timeout_s: Optional[float] = 30.0) -> None:
        """Stop accepting, finish queued work, release the socket."""
        self.draining = True
        self.engine.close(drain=True, timeout_s=timeout_s)
        self.shutdown()
        self.server_close()


def start_server(model_location: str, *, host: str = "127.0.0.1",
                 port: int = 0, max_batch: int = 64,
                 queue_bound: int = 256,
                 request_deadline_s: Optional[float] = 30.0,
                 reload_poll_s: float = 0.0, warm: bool = True,
                 overload: Optional[OverloadConfig] = None,
                 wire_format: str = "auto",
                 quality_policy: Optional[str] = None,
                 device: DeviceLike = None
                 ) -> Tuple[ScoringHTTPServer, threading.Thread]:
    """Build the engine (on ``device``: CUDA unless ``"cpu"`` is passed)
    and the server, and start the accept loop in a daemon thread.
    ``port=0`` binds an ephemeral port (``server.port``)."""
    engine = ScoringEngine(model_location, max_batch=max_batch,
                           queue_bound=queue_bound,
                           reload_poll_s=reload_poll_s, warm=warm,
                           overload=overload, quality_policy=quality_policy,
                           device=device)
    try:
        server = ScoringHTTPServer(engine, host=host, port=port,
                                   request_deadline_s=request_deadline_s,
                                   wire_format=wire_format)
    except BaseException:
        engine.close(drain=False)
        raise
    thread = threading.Thread(target=server.serve_forever,
                              name="scoring-http", daemon=True)
    thread.start()
    return server, thread


def serve_main(model_location: str, *, host: str = "127.0.0.1",
               port: int = 8180, max_batch: int = 64,
               queue_bound: int = 256,
               request_deadline_s: Optional[float] = 30.0,
               reload_poll_s: float = 10.0,
               overload: Optional[OverloadConfig] = None,
               wire_format: str = "auto",
               quality_policy: Optional[str] = None,
               device: DeviceLike = None) -> int:
    """Serve until SIGTERM / SIGINT, then drain the queued batches and
    return 0."""
    with preemption_guard("serve"):
        server, thread = start_server(
            model_location, host=host, port=port, max_batch=max_batch,
            queue_bound=queue_bound,
            request_deadline_s=request_deadline_s,
            reload_poll_s=reload_poll_s, overload=overload,
            wire_format=wire_format, quality_policy=quality_policy,
            device=device)
        print(f"serving {server.engine.model_version} on "
              f"http://{host}:{server.port} ({server.engine.device}, "
              f"max_batch={max_batch})", flush=True)
        try:
            while not shutdown_requested("serve"):
                time.sleep(0.2)
        finally:
            print("draining...", flush=True)
            server.drain_and_close()
            thread.join(timeout=5.0)
    return 0


def free_port(host: str = "127.0.0.1") -> int:
    """An ephemeral port for tests and smoke runs."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]
