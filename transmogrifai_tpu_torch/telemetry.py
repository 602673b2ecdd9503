"""Trace spans and serving metrics (the port's copy of the parts of
``transmogrifai_tpu/telemetry.py`` and ``profiling.py`` that serving uses).

* ``TraceContext`` (JAX telemetry.py:81-138) — a W3C ``traceparent``
  position: parsed from a request header, handed to the batch that serves
  the request, written back on every response.
* ``Span``, ``Tracer``, ``use_tracer``, ``span``, ``event`` and
  ``current_span_id`` (JAX :139-490) — nested, timed spans on an ambient
  tracer; with no tracer installed the module-level ``span`` / ``event``
  cost one attribute check.  Spans are host wall times: the engine's batch
  span covers its device work only because the score reads its results
  back before the span closes.
* ``Counter``, ``Gauge``, ``MetricsRegistry`` (JAX :504-613) and
  ``LatencyHistogram`` (JAX profiling.py:224), the sketch
  ``MetricsRegistry.histogram`` returns: log-spaced buckets with exact
  count and sum and OpenMetrics exemplars.

Left out until the tracing slice: the process-default ``REGISTRY`` and its
read-through gauges (XLA compile stats, racing, host-link bytes, the
sparse transform's volumes), Chrome trace export, trace merging, the
bundled ``telemetry.json`` summary and the trace-summary table.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import os
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

# --------------------------------------------------------------------------
# W3C trace context
# --------------------------------------------------------------------------

_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")
_TRACEPARENT_MAX_LEN = 64     # longer headers are dropped unparsed


@dataclass(frozen=True)
class TraceContext:
    """A W3C trace position: the 128-bit ``trace_id`` one distributed
    request shares and the 64-bit ``span_id`` of the current position
    (lowercase hex)."""

    trace_id: str
    span_id: str
    flags: int = 1          # 01 = sampled

    @staticmethod
    def new() -> "TraceContext":
        """A fresh root context."""
        return TraceContext(trace_id=os.urandom(16).hex(),
                            span_id=os.urandom(8).hex())

    def child(self) -> "TraceContext":
        """Same trace, a fresh span id — the position handed to a callee."""
        return TraceContext(self.trace_id, os.urandom(8).hex(), self.flags)

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags:02x}"

    @staticmethod
    def parse(header: Optional[str]) -> Optional["TraceContext"]:
        """Strict W3C parse; a malformed, oversized, uppercase or all-zero
        header gives None (the caller starts a fresh context)."""
        if not header or not isinstance(header, str):
            return None
        header = header.strip()
        if len(header) > _TRACEPARENT_MAX_LEN:
            return None
        m = _TRACEPARENT_RE.match(header)
        if m is None:
            return None
        trace_id, span_id, flags = m.group(1), m.group(2), m.group(3)
        if trace_id == "0" * 32 or span_id == "0" * 16:
            return None
        return TraceContext(trace_id, span_id, int(flags, 16))


# --------------------------------------------------------------------------
# spans
# --------------------------------------------------------------------------

@dataclass
class Span:
    """One timed unit of work in the trace tree."""

    name: str
    span_id: str
    parent_id: Optional[str]
    start_s: float              # monotonic, from the tracer's epoch
    end_s: Optional[float] = None
    status: str = "ok"          # "ok" | "error"
    attrs: Dict[str, Any] = field(default_factory=dict)
    thread: int = 0
    trace_id: str = ""
    w3c_id: str = ""
    links: List[Dict[str, str]] = field(default_factory=list)

    @property
    def duration_s(self) -> float:
        return (self.end_s if self.end_s is not None else self.start_s) \
            - self.start_s


class Tracer:
    """Thread-safe span collector (≙ telemetry.py:189).  Each thread nests
    its own spans; a thread with no open span parents to the innermost
    open span of the thread that installed the tracer.  Completed spans
    are kept in a ring of ``MAX_SPANS`` (a server records forever)."""

    MAX_SPANS = 65536

    def __init__(self, run_name: str = "run"):
        self.run_name = run_name
        self.trace_id = os.urandom(16).hex()
        self.t0_mono = time.monotonic()
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._spans: "collections.deque[Span]" = collections.deque(
            maxlen=self.MAX_SPANS)
        self._stacks: Dict[int, List[Span]] = {}
        self._install_thread: Optional[int] = None

    def _parent(self, tid: int) -> Optional[Span]:
        stack = self._stacks.get(tid)
        if stack:
            return stack[-1]
        root = self._stacks.get(self._install_thread)
        return root[-1] if root else None

    def current_span_id(self) -> Optional[str]:
        with self._lock:
            sp = self._parent(threading.get_ident())
        return sp.span_id if sp is not None else None

    def _new(self, name, ctx, links, attrs, end: bool) -> Span:
        tid = threading.get_ident()
        now = time.monotonic() - self.t0_mono
        parent = self._parent(tid)
        return Span(name=name, span_id=f"s{next(self._ids)}",
                    parent_id=parent.span_id if parent else None,
                    start_s=now, end_s=now if end else None,
                    attrs=dict(attrs), thread=tid,
                    trace_id=ctx.trace_id if ctx else self.trace_id,
                    w3c_id=ctx.span_id if ctx else os.urandom(8).hex(),
                    links=[{"traceId": l.trace_id, "spanId": l.span_id}
                           for l in (links or [])])

    @contextlib.contextmanager
    def span(self, name: str, *, ctx: Optional[TraceContext] = None,
             links: Optional[List[TraceContext]] = None, **attrs):
        """Record one span; ``ctx`` pins it to a request's W3C position,
        ``links`` name the requests a batch span served."""
        tid = threading.get_ident()
        with self._lock:
            sp = self._new(name, ctx, links, attrs, end=False)
            self._stacks.setdefault(tid, []).append(sp)
        try:
            yield sp
        except BaseException as e:
            sp.status = "error"
            sp.attrs.setdefault("error", f"{type(e).__name__}: {e}")
            raise
        finally:
            sp.end_s = time.monotonic() - self.t0_mono
            with self._lock:
                stack = self._stacks.get(tid, [])
                for i in range(len(stack) - 1, -1, -1):
                    if stack[i] is sp:
                        del stack[i]
                        break
                self._spans.append(sp)

    def event(self, name: str, *, ctx: Optional[TraceContext] = None,
              **attrs) -> Span:
        """A zero-duration marker span."""
        with self._lock:
            sp = self._new(name, ctx, None, attrs, end=True)
            self._spans.append(sp)
        return sp

    @property
    def spans(self) -> List[Span]:
        """Completed spans, in finish order."""
        with self._lock:
            return list(self._spans)


_TRACER_STACK: List[Tracer] = []
_TRACER_LOCK = threading.Lock()


def active_tracer() -> Optional[Tracer]:
    with _TRACER_LOCK:
        return _TRACER_STACK[-1] if _TRACER_STACK else None


@contextlib.contextmanager
def use_tracer(tracer: Tracer):
    """Install ``tracer`` as the ambient tracer for the dynamic extent."""
    with _TRACER_LOCK:
        _TRACER_STACK.append(tracer)
        if tracer._install_thread is None:
            tracer._install_thread = threading.get_ident()
    try:
        yield tracer
    finally:
        with _TRACER_LOCK:
            for i in range(len(_TRACER_STACK) - 1, -1, -1):
                if _TRACER_STACK[i] is tracer:
                    del _TRACER_STACK[i]
                    break


@contextlib.contextmanager
def span(name: str, *, ctx: Optional[TraceContext] = None,
         links: Optional[List[TraceContext]] = None, **attrs):
    """A span on the ambient tracer; yields None when tracing is off."""
    tracer = active_tracer()
    if tracer is None:
        yield None
        return
    with tracer.span(name, ctx=ctx, links=links, **attrs) as sp:
        yield sp


def event(name: str, *, ctx: Optional[TraceContext] = None,
          **attrs) -> Optional[Span]:
    """A marker on the ambient tracer (None when tracing is off)."""
    tracer = active_tracer()
    return None if tracer is None else tracer.event(name, ctx=ctx, **attrs)


def current_span_id() -> Optional[str]:
    """The calling thread's open span id on the ambient tracer, or None."""
    tracer = active_tracer()
    return None if tracer is None else tracer.current_span_id()


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------

class LatencyHistogram:
    """Thread-safe latency sketch (≙ profiling.py:224): log-spaced bucket
    counts (100 µs to ~100 s, x1.3 a bucket) plus exact count, sum, min and
    max; quantiles interpolate inside the bucket and are clamped to
    [min, max].  The last traced observation of each bucket is kept as its
    exemplar."""

    _BOUNDS = tuple(1e-4 * (1.3 ** i) for i in range(54))

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = [0] * (len(self._BOUNDS) + 1)
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self._bucket_exemplars: Dict[int, Dict[str, Any]] = {}
        self._last_exemplar: Optional[Dict[str, Any]] = None

    def observe(self, seconds: float, trace_id: Optional[str] = None) -> None:
        s = float(seconds)
        i = bisect.bisect_left(self._BOUNDS, s)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += s
            if self._min is None or s < self._min:
                self._min = s
            if self._max is None or s > self._max:
                self._max = s
            if trace_id:
                ex = {"traceId": trace_id, "value": s}
                self._bucket_exemplars[i] = ex
                self._last_exemplar = ex

    def exemplar(self, slowest: bool = False) -> Optional[Dict[str, Any]]:
        """The last traced observation, or with ``slowest`` the one of the
        highest occupied bucket; None before any traced observation."""
        with self._lock:
            if not self._bucket_exemplars:
                return None
            if slowest:
                return dict(self._bucket_exemplars[
                    max(self._bucket_exemplars)])
            return dict(self._last_exemplar)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> Optional[float]:
        with self._lock:
            total, counts = self._count, list(self._counts)
            mn, mx = self._min, self._max
        if total == 0:
            return None
        if q <= 0.0:
            return mn
        if q >= 1.0:
            return mx
        target, seen, est = q * total, 0.0, self._BOUNDS[-1]
        for i, c in enumerate(counts):
            if c == 0:
                continue
            lo = self._BOUNDS[i - 1] if i > 0 else 0.0
            hi = self._BOUNDS[i] if i < len(self._BOUNDS) else lo * 1.3
            if seen + c >= target:
                est = lo + (hi - lo) * (target - seen) / c
                break
            seen += c
        return min(max(est, mn), mx)

    def snapshot(self) -> Dict[str, Optional[float]]:
        return {"count": self.count, "sum": round(self.sum, 6),
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


class Counter:
    """Monotonic thread-safe counter; ``inc(trace_id=...)`` keeps the last
    incrementing trace as its OpenMetrics exemplar."""

    __slots__ = ("name", "_value", "_lock", "_exemplar")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()
        self._exemplar: Optional[Dict[str, Any]] = None

    def inc(self, n: Union[int, float] = 1,
            trace_id: Optional[str] = None) -> None:
        with self._lock:
            self._value += n
            if trace_id:
                self._exemplar = {"traceId": trace_id, "value": n}

    def exemplar(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return dict(self._exemplar) if self._exemplar else None

    @property
    def value(self) -> Union[int, float]:
        with self._lock:
            return self._value


class Gauge:
    """A value read through a callback (a failing callback reads as 0)."""

    __slots__ = ("name", "_fn")

    def __init__(self, name: str, fn: Callable[[], Any]):
        self.name = name
        self._fn = fn

    @property
    def value(self) -> Any:
        try:
            return self._fn()
        except Exception:  # noqa: BLE001 — a dead source reads as 0
            return 0


class MetricsRegistry:
    """Named counters, gauges and latency histograms; ``counter`` /
    ``gauge`` / ``histogram`` get or create, so call sites never race on
    registration."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, LatencyHistogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str, fn: Callable[[], Any]) -> Gauge:
        """The gauge ``name``, reading ``fn`` (a later call rebinds it)."""
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, fn)
            else:
                g._fn = fn
            return g

    def histogram(self, name: str) -> LatencyHistogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = LatencyHistogram()
            return h

    def counters(self) -> Dict[str, Union[int, float]]:
        with self._lock:
            items = list(self._counters.items())
        return {k: c.value for k, c in items}

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            hists = list(self._histograms.items())
        return {"counters": {k: c.value for k, c in counters},
                "gauges": {k: g.value for k, g in gauges},
                "histograms": {k: h.snapshot() for k, h in hists}}
