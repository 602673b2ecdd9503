"""Failure records, watchdog deadlines, circuit breakers, the adaptive
admission limit and fault injection (the port's copy of the parts of
``transmogrifai_tpu/resilience.py`` it uses: ``FailureLog``,
``record_failure``, ``AllCandidatesFailed`` (JAX :64-247),
``run_with_deadline`` (:269-360), ``CircuitBreaker`` (:414-632),
``AdaptiveConcurrencyLimit`` (:633-696) and ``FaultInjector`` with
``maybe_inject`` / ``inject_faults`` (:697-790)).

A candidate family that cannot fit the feature matrix (a tree family on a
``SparseMatrix``) is skipped by the validator: its (fold x grid) block gets
NaN metrics and one "skipped" event here, and the sweep goes on.  The
selector raises ``AllCandidatesFailed`` only when no candidate is left.

Unlike the JAX package there is no ambient, process-global log: a train
owns one ``FailureLog`` (``Workflow.train`` hands it to the selector and
the validator, which record skipped, resumed and degraded work into it, and
leaves it on the model as ``failure_log``), ``WorkflowModel.save`` /
``load`` record into the model's ``failure_log`` ("swallowed", ≙
stages/serialization.py:67-91; "degraded", ≙ workflow.py:816-931), and a
serving engine owns the log its breakers, its ``run_with_deadline`` calls
and its batcher record into (``ScoringEngine.failure_log``).  An explicit
log keeps two engines, or an engine and a training run, in one process
from writing into each other's records, which an ambient stack shared by
threads cannot.  ``RetryPolicy`` is not ported: its callers, the streaming
runner and the tenant registry, are not either.
"""

from __future__ import annotations

import hashlib
import threading
import time
from contextlib import contextmanager
from typing import (Any, Callable, Dict, Iterable, List, NamedTuple,
                    Optional, Tuple)

class AllCandidatesFailed(RuntimeError):
    """Every (model x grid-point) candidate of a selector sweep failed;
    carries the per-candidate causes."""

    def __init__(self, message: str, causes: Optional[Dict[str, str]] = None):
        self.causes = dict(causes or {})
        if self.causes:
            detail = "; ".join(f"{k}: {v}" for k, v in
                               sorted(self.causes.items()))
            message = f"{message} — per-candidate causes: {detail}"
        super().__init__(message)


class InjectedFault(RuntimeError):
    """Raised by ``FaultInjector`` at an armed injection point."""


# the exceptions of a candidate fit that mean "this family cannot fit this
# matrix" (≙ the skip at transmogrifai_tpu/tuning.py:1395-1407), and a fault
# injected at the ``selector.candidate_fit`` seam: anything else (a CUDA
# error, an out-of-memory, a failed kernel build) still raises
SKIPPABLE = (NotImplementedError, TypeError, InjectedFault)


class WatchdogTimeout(TimeoutError):
    """A watchdogged call did not return before its deadline; its worker
    thread is abandoned (a hung native call cannot be interrupted from
    Python)."""


def _format_cause(cause: Any) -> str:
    if cause is None:
        return ""
    if isinstance(cause, BaseException):
        return f"{type(cause).__name__}: {cause}"
    return str(cause)


class FailureEvent(NamedTuple):
    """One skipped, dropped, degraded or served-around unit of work."""

    stage: str                  # model name, stage uid or subsystem
    action: str                 # one of FailureLog.ACTIONS
    cause: str                  # "ExcType: message", or the message
    point: str                  # the site, e.g. "serving.batch"
    detail: Dict[str, Any]      # e.g. the folds and grid points

    def to_json(self) -> Dict[str, Any]:
        d = {"stage": self.stage, "action": self.action,
             "cause": self.cause, "point": self.point}
        if self.detail:
            d["detail"] = dict(self.detail)
        return d


class FailureLog:
    """Append-only, thread-safe record of one run's or one engine's
    failure events (≙ ``FailureLog``, resilience.py:96, passed explicitly
    instead of read from the ambient stack)."""

    ACTIONS = ("skipped",      # unit of work abandoned, sweep continues
               "degraded",     # loaded or served without an optional part
               "swallowed",    # best-effort side work failed (dropped)
               "dead_letter",  # unservable by every path
               "fallback",     # the row-at-a-time path served a batch
               "quarantined",  # the data-quality screen excluded a record
               "reloaded",     # serving swapped in a newer model version
               "recovered",    # a path came back after a failure
               "shed",         # admission control refused work up front
               "preempted",    # a graceful stop was requested
               "resumed",      # work replayed from a sweep checkpoint
               "breaker_open",       # circuit breaker tripped
               "breaker_half_open",  # breaker probing for recovery
               "breaker_closed")     # breaker recovered

    def __init__(self):
        self._events: List[FailureEvent] = []
        self._lock = threading.Lock()

    def record(self, stage: str, action: str, cause: Any = None, *,
               point: str = "", **detail) -> FailureEvent:
        if action not in self.ACTIONS:
            raise ValueError(f"unknown failure action {action!r}; "
                             f"expected one of {self.ACTIONS}")
        if "span_id" not in detail:
            from .telemetry import current_span_id
            sid = current_span_id()
            if sid is not None:
                detail["span_id"] = sid
        ev = FailureEvent(str(stage), action, _format_cause(cause), point,
                          detail)
        with self._lock:
            self._events.append(ev)
        return ev

    @property
    def events(self) -> List[FailureEvent]:
        with self._lock:
            return list(self._events)

    def by_action(self, action: str) -> List[FailureEvent]:
        return [e for e in self.events if e.action == action]

    def summary(self) -> Dict[str, int]:
        """Event counts by action."""
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.action] = out.get(e.action, 0) + 1
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def __iter__(self):
        return iter(self.events)


def record_failure(log: Optional[FailureLog], stage: str, action: str,
                   cause: Any = None, *, point: str = "", **detail) -> None:
    """Record into ``log`` (≙ ``record_failure``, resilience.py:247, with the
    log passed instead of read from the ambient stack); no log, no
    record."""
    if log is not None:
        log.record(stage, action, cause, point=point, **detail)


def _stable_uniform(*parts: Any) -> float:
    """Uniform [0, 1) as a pure function of the parts."""
    h = hashlib.sha256("|".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


# --------------------------------------------------------------------------
# watchdog
# --------------------------------------------------------------------------

def run_with_deadline(fn: Callable[..., Any], timeout_s: Optional[float],
                      *args, description: str = "",
                      log: Optional[FailureLog] = None, **kwargs) -> Any:
    """Run ``fn`` with a deadline; raise ``WatchdogTimeout`` if it blows it
    (≙ resilience.py:269).  The call runs in a daemon worker thread and
    the caller waits at most ``timeout_s``; a call that never returns is
    abandoned, and its worker records into ``log`` if it finishes later.
    Worker exceptions re-raise in the caller.  ``timeout_s=None`` runs
    inline."""
    if timeout_s is None:
        return fn(*args, **kwargs)
    box: Dict[str, Any] = {}
    done = threading.Event()
    state_lock = threading.Lock()
    abandoned = False
    label = description or getattr(fn, "__name__", "call")

    def target():
        err: Optional[BaseException] = None
        try:
            value = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 — re-raised in the caller
            err, value = e, None
        with state_lock:
            orphaned = abandoned
            if not orphaned:
                if err is None:
                    box["value"] = value
                else:
                    box["error"] = err
        done.set()
        if orphaned:
            record_failure(log, "watchdog", "swallowed",
                           err if err is not None else
                           "worker completed after its deadline; result "
                           "dropped", point="watchdog.orphan",
                           description=label)

    worker = threading.Thread(target=target, daemon=True,
                              name=f"watchdog:{label}")
    worker.start()
    if not done.wait(timeout_s):
        with state_lock:
            if "value" not in box and "error" not in box:
                abandoned = True
        if abandoned:
            record_failure(log, "watchdog", "degraded",
                           f"{label} worker thread abandoned after "
                           f"{timeout_s:g}s (thread leaked)",
                           point="watchdog.abandoned", description=label)
            raise WatchdogTimeout(
                f"{label} exceeded its {timeout_s:g}s deadline; worker "
                "thread abandoned (a hung native call cannot be "
                "interrupted from Python)")
    if "error" in box:
        err = box["error"]
        raise err.with_traceback(err.__traceback__)
    return box.get("value")


# --------------------------------------------------------------------------
# circuit breaker
# --------------------------------------------------------------------------

class CircuitOpenError(RuntimeError):
    """The breaker is open: the protected call was skipped.
    ``retry_after_s`` says how long until a recovery probe."""

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class CircuitBreaker:
    """Thread-safe closed → open → half-open breaker (≙ resilience.py:431).

    Closed: outcomes feed a sliding window; it opens on
    ``failure_threshold`` consecutive failures, or when the window holds at
    least ``min_calls`` outcomes and the failure fraction reaches
    ``failure_rate``.  Open: ``allow()`` refuses until ``reset_timeout_s``
    has passed.  Half-open: exactly ``half_open_probes`` calls are granted;
    all succeeding closes it, any failing re-opens it.  Transitions go into
    ``log`` (``breaker_open`` / ``_half_open`` / ``_closed``), as telemetry
    events and, with a registry, as per-breaker counters and a state gauge
    (0 closed / 1 half-open / 2 open)."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"
    _STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

    def __init__(self, name: str, *, window: int = 20,
                 failure_threshold: int = 5, failure_rate: float = 0.5,
                 min_calls: int = 10, reset_timeout_s: float = 30.0,
                 half_open_probes: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 registry: Optional[Any] = None,
                 log: Optional[FailureLog] = None):
        self.name = str(name)
        self.window = max(1, int(window))
        self.failure_threshold = max(1, int(failure_threshold))
        self.failure_rate = float(failure_rate)
        self.min_calls = max(1, int(min_calls))
        self.reset_timeout_s = float(reset_timeout_s)
        self.half_open_probes = max(1, int(half_open_probes))
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._outcomes: List[bool] = []   # sliding window, True = failure
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_permits = 0
        self._probe_successes = 0
        self._last_cause = ""
        self._registry = registry
        self.log = log
        if registry is not None:
            registry.gauge(f"breaker.{self.name}.state", self.state_code)

    def state_code(self) -> int:
        return self._STATE_CODES[self.current_state()]

    def current_state(self) -> str:
        """The visible state: an open breaker past its reset timeout reads
        as half-open without changing anything."""
        with self._lock:
            if (self._state == self.OPEN and self._clock() - self._opened_at
                    >= self.reset_timeout_s):
                return self.HALF_OPEN
            return self._state

    def retry_after_s(self) -> float:
        """Seconds until a recovery probe is granted (0 when not open)."""
        with self._lock:
            return self._retry_after_locked()

    def _retry_after_locked(self) -> float:
        if self._state != self.OPEN:
            return 0.0
        return max(0.0, self._opened_at + self.reset_timeout_s
                   - self._clock())

    def snapshot(self) -> Dict[str, Any]:
        state = self.current_state()
        with self._lock:
            return {"name": self.name, "state": state,
                    "window_calls": len(self._outcomes),
                    "window_failures": sum(self._outcomes),
                    "consecutive_failures": self._consecutive_failures,
                    "last_cause": self._last_cause,
                    "retry_after_s": self._retry_after_locked()}

    def allow(self) -> bool:
        """May this call proceed?  Open → half-open happens here, on the
        first call after the reset timeout."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if self._clock() - self._opened_at < self.reset_timeout_s:
                    return False
                self._transition(self.HALF_OPEN,
                                 f"reset timeout {self.reset_timeout_s:g}s "
                                 "elapsed")
                self._probe_permits = self.half_open_probes
                self._probe_successes = 0
            if self._probe_permits > 0:
                self._probe_permits -= 1
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            if self._state == self.HALF_OPEN:
                self._probe_successes += 1
                if self._probe_successes >= self.half_open_probes:
                    self._transition(
                        self.CLOSED, f"{self._probe_successes} recovery "
                        "probe(s) succeeded")
                    self._outcomes.clear()
                    self._last_cause = ""
                return
            if self._state == self.CLOSED:
                self._push_outcome(False)

    def record_failure(self, cause: Any = None) -> None:
        with self._lock:
            self._last_cause = _format_cause(cause)
            if self._state == self.HALF_OPEN:
                self._open(f"recovery probe failed: {self._last_cause}")
                return
            if self._state == self.OPEN:
                return
            self._push_outcome(True)
            self._consecutive_failures += 1
            failures = sum(self._outcomes)
            if self._consecutive_failures >= self.failure_threshold:
                self._open(f"{self._consecutive_failures} consecutive "
                           f"failures; last: {self._last_cause}")
            elif (len(self._outcomes) >= self.min_calls
                    and failures / len(self._outcomes)
                    >= self.failure_rate):
                self._open(f"failure rate {failures}/{len(self._outcomes)} "
                           f">= {self.failure_rate:g}; last: "
                           f"{self._last_cause}")

    def call(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` under the breaker: ``CircuitOpenError`` without
        calling it when open, else its outcome is recorded."""
        if not self.allow():
            raise CircuitOpenError(
                f"breaker {self.name!r} is open "
                f"(last: {self._last_cause or 'unknown'})",
                retry_after_s=self.retry_after_s())
        try:
            result = fn()
        except BaseException as e:
            self.record_failure(e)
            raise
        self.record_success()
        return result

    # -- internals (the lock held) -----------------------------------------
    def _push_outcome(self, failed: bool) -> None:
        self._outcomes.append(failed)
        if len(self._outcomes) > self.window:
            del self._outcomes[:len(self._outcomes) - self.window]

    def _open(self, reason: str) -> None:
        self._opened_at = self._clock()
        self._probe_permits = 0
        self._probe_successes = 0
        self._transition(self.OPEN, reason)

    def _transition(self, to: str, reason: str) -> None:
        frm, self._state = self._state, to
        action = {self.OPEN: "breaker_open",
                  self.HALF_OPEN: "breaker_half_open",
                  self.CLOSED: "breaker_closed"}[to]
        record_failure(self.log, "breaker", action, reason,
                       point=f"breaker.{self.name}", breaker=self.name)
        from .telemetry import event
        event("breaker.transition", breaker=self.name, from_state=frm,
              to_state=to, reason=reason)
        if self._registry is not None:
            self._registry.counter(f"breaker.{self.name}.{to}_total").inc()


# --------------------------------------------------------------------------
# adaptive concurrency limit (AIMD)
# --------------------------------------------------------------------------

class AdaptiveConcurrencyLimit:
    """AIMD admission limit driven by batch latency against a target (≙
    resilience.py:633): a batch at or under ``target_latency_s`` adds
    ``increase`` to the limit, one over it multiplies the limit by
    ``decrease``; the limit stays within ``[min_limit, max_limit]``."""

    def __init__(self, *, target_latency_s: float, max_limit: int,
                 min_limit: int = 4, increase: float = 1.0,
                 decrease: float = 0.75, initial: Optional[int] = None):
        if max_limit < 1:
            raise ValueError("max_limit must be >= 1")
        self.target_latency_s = float(target_latency_s)
        self.max_limit = int(max_limit)
        self.min_limit = max(1, min(int(min_limit), self.max_limit))
        self.increase = float(increase)
        self.decrease = float(decrease)
        if not 0.0 < self.decrease < 1.0:
            raise ValueError("decrease must be in (0, 1)")
        start = float(initial if initial is not None else self.max_limit)
        self._limit = min(max(start, self.min_limit), self.max_limit)
        self._lock = threading.Lock()
        self._observations = 0
        self._decreases = 0

    @property
    def limit(self) -> int:
        with self._lock:
            return int(self._limit)

    def observe(self, latency_s: float) -> int:
        """Feed one batch latency; returns the updated limit."""
        with self._lock:
            self._observations += 1
            if latency_s <= self.target_latency_s:
                self._limit = min(self.max_limit, self._limit + self.increase)
            else:
                self._decreases += 1
                self._limit = max(self.min_limit,
                                  self._limit * self.decrease)
            return int(self._limit)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"limit": int(self._limit), "min_limit": self.min_limit,
                    "max_limit": self.max_limit,
                    "target_latency_s": self.target_latency_s,
                    "observations": self._observations,
                    "decreases": self._decreases}


# --------------------------------------------------------------------------
# fault injection
# --------------------------------------------------------------------------

class FaultInjector:
    """Deterministic chaos harness over named injection points (≙
    resilience.py:697).  Whether (point, key) fails is a hash of (seed,
    point, key) against the point's rate, or membership in ``fail_keys``:
    the same key fails every time and a seed reproduces its failure set."""

    def __init__(self, rates: Optional[Dict[str, float]] = None,
                 fail_keys: Optional[Dict[str, Iterable[Any]]] = None,
                 seed: int = 0):
        self.rates = {k: float(v) for k, v in (rates or {}).items()}
        self.fail_keys = {p: {str(k) for k in ks}
                          for p, ks in (fail_keys or {}).items()}
        self.seed = int(seed)
        self.fired: List[Tuple[str, str]] = []   # every raise, in order
        self._auto_counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def should_fail(self, point: str, key: Any = None) -> bool:
        if key is None:
            with self._lock:
                key = self._auto_counts.get(point, 0)
                self._auto_counts[point] = key + 1
        key = str(key)
        if key in self.fail_keys.get(point, ()):
            return True
        rate = self.rates.get(point, 0.0)
        return rate > 0.0 and _stable_uniform(self.seed, point, key) < rate

    def check(self, point: str, key: Any = None) -> None:
        """Raise ``InjectedFault`` when (point, key) is armed."""
        if self.should_fail(point, key):
            with self._lock:
                self.fired.append((point, str(key)))
            raise InjectedFault(f"injected fault at {point!r} (key={key!r})")


_INJECTOR: Optional[FaultInjector] = None


def maybe_inject(point: str, key: Any = None) -> None:
    """Injection-point hook: a no-op unless a ``FaultInjector`` is
    installed."""
    inj = _INJECTOR
    if inj is not None:
        inj.check(point, key)


@contextmanager
def inject_faults(injector: FaultInjector):
    """Install ``injector`` for the dynamic extent (restores the previous).
    Injection is process-wide, as in the JAX package: it is a test
    harness, not a record, so it needs no owner."""
    global _INJECTOR
    prev = _INJECTOR
    _INJECTOR = injector
    try:
        yield injector
    finally:
        _INJECTOR = prev
