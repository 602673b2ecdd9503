"""The serving overload control plane (port of
``transmogrifai_tpu/serving/overload.py``, the whole module).

* ``AdaptiveConcurrencyLimit`` (AIMD on observed batch latency) is the
  admission signal; ``queue_bound`` is the ceiling above it.
* Queue-deadline shedding: from the batch-latency EWMA the controller
  estimates how long a new request would wait; one that cannot meet its
  deadline is refused now, with an honest ``Retry-After``.
* A ``CircuitBreaker`` around the compiled batch path sends batches to the
  row-at-a-time fallback (on the engine's own device, through the same
  kernels) while the compiled path keeps failing, and probes it again
  (half-open) after its reset timeout.
* A second breaker around hot reload stops a corrupt candidate bundle from
  being verified and loaded again on every watcher poll.
* ``HealthStateMachine`` — ``SERVING`` / ``DEGRADED`` / ``BROWNOUT`` /
  ``DRAINING`` — exported through ``/healthz``, ``/readyz``, ``/metrics``
  and telemetry events.
* The device-memory admission budget (``batch_bytes_budget``) reads
  ``estimate_batch_bytes``: the port's copy of the JAX package's
  ``parallel/memory.py:315-321`` estimate, rows x width x 4 bytes under the
  same headroom factor (``TRANSMOGRIFAI_MEMORY_HEADROOM``, default 1.5).

The breakers record their transitions into the engine's ``FailureLog``
(``log=``), since the port has no ambient log.
"""

from __future__ import annotations

import math
import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional

from ..resilience import AdaptiveConcurrencyLimit, CircuitBreaker, FailureLog
from ..telemetry import event

_DEFAULT_HEADROOM = 1.5


def memory_headroom() -> float:
    """The estimate's safety factor (``TRANSMOGRIFAI_MEMORY_HEADROOM``, at
    least 1; default 1.5)."""
    try:
        v = float(os.environ.get("TRANSMOGRIFAI_MEMORY_HEADROOM",
                                 str(_DEFAULT_HEADROOM)))
    except ValueError:
        return _DEFAULT_HEADROOM
    return v if v >= 1.0 else _DEFAULT_HEADROOM


def estimate_batch_bytes(rows: int, features: int,
                         dtype_bytes: int = 4) -> int:
    """The device footprint estimate of a scoring batch: rows x feature
    width x dtype bytes x the headroom factor."""
    return int(rows * max(1, int(features)) * dtype_bytes
               * memory_headroom())


# -- health states (the degradation ladder, mildest first) ------------------
SERVING = "SERVING"      # compiled path healthy, all optional work runs
DEGRADED = "DEGRADED"    # user traffic OK, but on the local fallback path
BROWNOUT = "BROWNOUT"    # queue pressure: optional work shed, traffic kept
DRAINING = "DRAINING"    # shutting down: no new work accepted

HEALTH_STATES = (SERVING, DEGRADED, BROWNOUT, DRAINING)
HEALTH_CODES = {SERVING: 0, DEGRADED: 1, BROWNOUT: 2, DRAINING: 3}


@dataclass
class OverloadConfig:
    """Knobs for the serving overload control plane; ``from_params`` reads
    a ``servingParams`` dict (camelCase keys)."""

    latency_target_ms: float = 50.0     # AIMD target for batch latency
    adaptive: bool = True               # False → static queue_bound only
    min_limit: int = 4                  # AIMD floor
    queue_deadline_ms: Optional[float] = None  # extra queue-wait budget cap
    brownout_high: float = 0.75         # queue/limit ratio entering BROWNOUT
    brownout_low: float = 0.50          # ratio that exits it (hysteresis)
    breaker_window: int = 16            # compiled-path breaker window
    breaker_failures: int = 3           # consecutive failures that open it
    breaker_rate: float = 0.5           # windowed failure-rate trip wire
    breaker_min_calls: int = 8          # min window size for the rate rule
    breaker_reset_s: float = 5.0        # open → half-open delay
    half_open_probes: int = 1           # probes that must succeed to close
    reload_breaker_failures: int = 3    # reload failures that open its breaker
    reload_breaker_reset_s: float = 10.0
    # device-memory admission budget: estimated bytes the queued rows would
    # occupy on the device (estimate_batch_bytes); None = memory admission
    # off, the default
    batch_bytes_budget: Optional[int] = None

    _PARAM_KEYS = {
        "latencyTargetMs": "latency_target_ms",
        "adaptiveLimit": "adaptive",
        "minLimit": "min_limit",
        "queueDeadlineMs": "queue_deadline_ms",
        "brownoutHigh": "brownout_high",
        "brownoutLow": "brownout_low",
        "breakerWindow": "breaker_window",
        "breakerFailures": "breaker_failures",
        "breakerRate": "breaker_rate",
        "breakerMinCalls": "breaker_min_calls",
        "breakerResetS": "breaker_reset_s",
        "halfOpenProbes": "half_open_probes",
        "reloadBreakerFailures": "reload_breaker_failures",
        "reloadBreakerResetS": "reload_breaker_reset_s",
        "batchBytesBudget": "batch_bytes_budget",
    }

    @classmethod
    def from_params(cls, serving: Optional[Dict[str, Any]]
                    ) -> "OverloadConfig":
        """Build from a ``servingParams`` dict, ignoring unrelated keys
        (host, port, maxBatch, ... are consumed by the server itself)."""
        kwargs = {}
        for key, attr in cls._PARAM_KEYS.items():
            if serving and key in serving:
                kwargs[attr] = serving[key]
        return cls(**kwargs)


@dataclass
class ShedDecision:
    """Why admission refused a request, and when to come back."""

    kind: str            # "limit" (queue past the adaptive limit),
    #                      "deadline" (queue wait would blow the deadline),
    #                      or "memory" (queued rows past the byte budget)
    message: str
    retry_after_s: float


class HealthStateMachine:
    """Current engine health plus the reason it got there.

    Transitions record a telemetry event (``serving.health``) and count in
    the engine registry; the gauge ``health_state`` exports the numeric
    code (0 SERVING / 1 DEGRADED / 2 BROWNOUT / 3 DRAINING)."""

    def __init__(self, registry: Optional[Any] = None):
        self._lock = threading.Lock()
        self._state = SERVING
        self._reason = "startup"
        self._registry = registry
        if registry is not None:
            registry.gauge("health_state",
                           lambda: HEALTH_CODES[self._state])

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def reason(self) -> str:
        with self._lock:
            return self._reason

    @property
    def code(self) -> int:
        return HEALTH_CODES[self.state]

    def set_state(self, to: str, reason: str) -> bool:
        """Move to ``to``; returns True when this was an actual transition.
        DRAINING is terminal — nothing transitions out of it."""
        if to not in HEALTH_CODES:
            raise ValueError(f"unknown health state {to!r}")
        with self._lock:
            if self._state == to or self._state == DRAINING:
                return False
            frm, self._state = self._state, to
            self._reason = reason
        event("serving.health", from_state=frm, to_state=to, reason=reason)
        if self._registry is not None:
            self._registry.counter("health_transitions_total").inc()
            self._registry.counter(f"health.{to}_total").inc()
        return True

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"state": self._state, "reason": self._reason,
                    "code": HEALTH_CODES[self._state]}


class OverloadController:
    """One controller per engine: admission, breakers, health.

    The engine owns the queue and the locks; this object owns the *policy*
    — every method is a pure decision or a bookkeeping update, safe to call
    from request threads and the batcher thread concurrently."""

    def __init__(self, config: Optional[OverloadConfig] = None, *,
                 queue_bound: Any, max_batch: int,
                 registry: Optional[Any] = None,
                 scope: Optional[str] = None,
                 log: Optional[FailureLog] = None):
        self.config = config or OverloadConfig()
        # a scoped controller suffixes its breaker names with ``@<scope>``
        # (the JAX package's tenant bulkheads); None keeps the plain names
        self.scope = scope
        suffix = f"@{scope}" if scope else ""
        # int for a fixed ceiling, or a callable for a live one (the engine
        # passes ``lambda: self.queue_bound`` so runtime retuning is seen)
        if callable(queue_bound):
            self._queue_bound_fn = queue_bound
        else:
            self._queue_bound_fn = lambda bound=int(queue_bound): bound
        self.max_batch = max(1, int(max_batch))
        cfg = self.config
        self.limit: Optional[AdaptiveConcurrencyLimit] = None
        if cfg.adaptive:
            self.limit = AdaptiveConcurrencyLimit(
                target_latency_s=cfg.latency_target_ms / 1000.0,
                max_limit=self.queue_bound, min_limit=cfg.min_limit)
        self.compiled_breaker = CircuitBreaker(
            f"serving.batch{suffix}", window=cfg.breaker_window,
            failure_threshold=cfg.breaker_failures,
            failure_rate=cfg.breaker_rate,
            min_calls=cfg.breaker_min_calls,
            reset_timeout_s=cfg.breaker_reset_s,
            half_open_probes=cfg.half_open_probes, registry=registry,
            log=log)
        self.reload_breaker = CircuitBreaker(
            f"serving.reload{suffix}",
            failure_threshold=cfg.reload_breaker_failures,
            # reload attempts are sparse (one per watcher poll): consecutive
            # failures are the only meaningful trip wire
            window=max(4, cfg.reload_breaker_failures),
            failure_rate=1.1, min_calls=10 ** 9,
            reset_timeout_s=cfg.reload_breaker_reset_s,
            half_open_probes=1, registry=registry, log=log)
        self.health = HealthStateMachine(registry=registry)
        self._registry = registry
        self._lock = threading.Lock()
        self._ewma_batch_s: Optional[float] = None
        self._brownout_latched = False
        if registry is not None:
            registry.gauge("admission_limit", self.admission_limit)

    # -- admission ---------------------------------------------------------
    @property
    def queue_bound(self) -> int:
        return int(self._queue_bound_fn())

    def admission_limit(self) -> int:
        """Queue slots currently granted: the adaptive limit when enabled,
        else the static ``queue_bound`` (always the hard ceiling)."""
        if self.limit is None:
            return self.queue_bound
        return min(self.limit.limit, self.queue_bound)

    def ewma_batch_latency_s(self) -> float:
        with self._lock:
            return self._ewma_batch_s or 0.0

    def estimate_wait_s(self, queue_depth: int) -> float:
        """Expected queue wait for a request arriving at ``queue_depth``:
        batches ahead of it times the smoothed batch latency.  The
        continuous batcher dispatches the instant the device frees, so
        there is no linger constant in this estimate — batch latency is
        the whole story.  Zero until the first batch lands (no signal)."""
        with self._lock:
            ewma = self._ewma_batch_s
        if ewma is None:
            return 0.0
        batches_ahead = math.ceil((queue_depth + 1) / self.max_batch)
        return batches_ahead * ewma

    def admit(self, queue_depth: int, extra: int = 1,
              deadline_s: Optional[float] = None,
              est_bytes: Optional[int] = None
              ) -> Optional[ShedDecision]:
        """Decide whether ``extra`` records may join a queue currently
        ``queue_depth`` deep.  None = admitted; a ``ShedDecision``
        otherwise (the engine translates it into ``OverloadedError``).

        ``est_bytes`` — the engine's device-memory estimate for the queue
        WITH this request admitted — is checked against
        ``batch_bytes_budget`` when both are set: a batch that would blow
        the device budget sheds honestly at the door instead of OOM-ing
        the scoring program mid-flight."""
        budget_bytes = self.config.batch_bytes_budget
        if (budget_bytes is not None and est_bytes is not None
                and est_bytes > budget_bytes):
            wait = self.estimate_wait_s(queue_depth)
            return ShedDecision(
                kind="memory",
                message=(f"estimated queued-batch footprint {est_bytes} "
                         f"bytes exceeds the {budget_bytes}-byte device "
                         "memory budget (batchBytesBudget)"),
                retry_after_s=max(1.0, wait))
        limit = self.admission_limit()
        if queue_depth + extra > limit:
            wait = self.estimate_wait_s(queue_depth)
            return ShedDecision(
                kind="limit",
                message=(f"queue depth {queue_depth} + {extra} exceeds "
                         f"admission limit {limit} "
                         f"(queue_bound={self.queue_bound})"),
                retry_after_s=max(1.0, wait))
        budget = deadline_s
        cfg_deadline = self.config.queue_deadline_ms
        if cfg_deadline is not None:
            cfg_deadline_s = cfg_deadline / 1000.0
            budget = (cfg_deadline_s if budget is None
                      else min(budget, cfg_deadline_s))
        if budget is not None:
            wait = self.estimate_wait_s(queue_depth + extra - 1)
            if wait > budget:
                return ShedDecision(
                    kind="deadline",
                    message=(f"estimated queue wait {wait:.3f}s exceeds "
                             f"the {budget:g}s deadline; rejecting now "
                             "rather than timing out in queue"),
                    retry_after_s=max(1.0, wait - budget))
        return None

    # -- feedback from the batcher -----------------------------------------
    def observe_batch(self, latency_s: float) -> None:
        """Feed one completed batch's latency: updates the AIMD limit and
        the EWMA the deadline shedder uses."""
        with self._lock:
            if self._ewma_batch_s is None:
                self._ewma_batch_s = float(latency_s)
            else:
                self._ewma_batch_s += 0.3 * (latency_s - self._ewma_batch_s)
        if self.limit is not None:
            self.limit.observe(latency_s)

    # -- health ------------------------------------------------------------
    def refresh_health(self, *, queue_depth: int, draining: bool,
                       compiled_ok: bool) -> str:
        """Recompute the health state from current signals.  Priority:
        DRAINING > BROWNOUT > DEGRADED > SERVING; brownout enters at
        ``brownout_high`` queue utilization and exits at ``brownout_low``
        (hysteresis, so the state doesn't flap batch-to-batch)."""
        if draining:
            self.health.set_state(DRAINING, "engine close requested")
            return self.health.state
        limit = max(1, self.admission_limit())
        util = queue_depth / limit
        with self._lock:
            if util >= self.config.brownout_high:
                self._brownout_latched = True
            elif util <= self.config.brownout_low:
                self._brownout_latched = False
            browned = self._brownout_latched
        if browned:
            self.health.set_state(
                BROWNOUT, f"queue utilization {util:.0%} of limit {limit}")
            return self.health.state
        breaker_state = self.compiled_breaker.current_state()
        if not compiled_ok or breaker_state != CircuitBreaker.CLOSED:
            why = ("compiled-path breaker " + breaker_state
                   if compiled_ok else "compiled path demoted at warmup")
            self.health.set_state(DEGRADED, why)
            return self.health.state
        self.health.set_state(SERVING, "all signals nominal")
        # the machine may refuse (DRAINING is terminal): report what it IS
        return self.health.state

    def snapshot(self) -> Dict[str, Any]:
        return {"health": self.health.snapshot(),
                "scope": self.scope,
                "admission_limit": self.admission_limit(),
                "queue_bound": self.queue_bound,
                "adaptive": (self.limit.snapshot()
                             if self.limit is not None else None),
                "ewma_batch_latency_s": self.ewma_batch_latency_s(),
                "compiled_breaker": self.compiled_breaker.snapshot(),
                "reload_breaker": self.reload_breaker.snapshot()}
