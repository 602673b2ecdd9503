"""The port's overload control plane and resilience primitives against the
JAX package's, fed the same call sequences.

``CircuitBreaker``, ``AdaptiveConcurrencyLimit``, ``OverloadController``
and ``HealthStateMachine`` make the same decisions and reach the same
states; time is controlled the same way in both (a fake clock handed to
each breaker), and the breakers' transitions land in the port's explicit
``FailureLog`` with the actions and points the JAX package records in its
ambient one.  ``run_with_deadline``, ``FaultInjector`` and
``estimate_batch_bytes`` agree too; the engine's breakers demote, shed and
recover as the JAX engine's do (``tests/test_overload.py``).
"""

import threading
import time

import pytest

torch = pytest.importorskip("torch")

import transmogrifai_tpu.resilience as JR  # noqa: E402
import transmogrifai_tpu.serving.overload as JO  # noqa: E402
import transmogrifai_tpu_torch.resilience as R  # noqa: E402
import transmogrifai_tpu_torch.serving.overload as O  # noqa: E402
from transmogrifai_tpu_torch.telemetry import (MetricsRegistry,  # noqa: E402
                                               Tracer, use_tracer)


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _breakers(**kw):
    """(port breaker, its log, JAX breaker, its log, the shared clock)."""
    from transmogrifai_tpu.telemetry import MetricsRegistry as JReg
    clk = _Clock()
    log, jlog = R.FailureLog(), JR.FailureLog()
    reg, jreg = MetricsRegistry(), JReg()
    p = R.CircuitBreaker("t", clock=clk, registry=reg, log=log, **kw)
    j = JR.CircuitBreaker("t", clock=clk, registry=jreg, **kw)
    return p, log, reg, j, jlog, jreg, clk


# the call sequences: ("ok"), ("fail"), ("allow"), ("advance", dt)
SEQUENCES = {
    "full_cycle": (dict(failure_threshold=3, reset_timeout_s=10,
                        half_open_probes=2),
                   ["allow", "fail", "fail", "fail", "allow",
                    ("advance", 10.1), "allow", "allow", "allow", "ok", "ok",
                    "allow"]),
    "probe_fails": (dict(failure_threshold=2, reset_timeout_s=5),
                    ["fail", "fail", ("advance", 5.1), "allow", "fail",
                     "allow", ("advance", 2.0), "allow", ("advance", 3.2),
                     "allow", "ok"]),
    "windowed_rate": (dict(window=10, failure_threshold=100,
                           failure_rate=0.5, min_calls=10),
                      ["ok", "fail"] * 5 + ["allow"]),
    "window_slides": (dict(window=4, failure_threshold=10, failure_rate=0.75,
                           min_calls=4),
                      ["fail", "ok", "ok", "ok", "fail", "fail", "ok",
                       "fail", "fail", "allow"]),
    "reload_shape": (dict(failure_threshold=3, window=4, failure_rate=1.1,
                          min_calls=10 ** 9, reset_timeout_s=10),
                     ["fail", "ok", "fail", "fail", "fail", "allow",
                      ("advance", 10), "allow", "ok"]),
}


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_breakers_make_the_same_decisions(name):
    kw, seq = SEQUENCES[name]
    p, log, reg, j, jlog, jreg, clk = _breakers(**kw)
    tracer = Tracer("breaker")
    with JR.use_failure_log(jlog), use_tracer(tracer):
        for step in seq:
            if isinstance(step, tuple):
                clk.t += step[1]
            elif step == "allow":
                assert p.allow() == j.allow()
            elif step == "ok":
                p.record_success()
                j.record_success()
            else:
                p.record_failure(RuntimeError(f"boom {clk.t}"))
                j.record_failure(RuntimeError(f"boom {clk.t}"))
            assert p.current_state() == j.current_state()
            assert p.snapshot() == j.snapshot()
            assert p.retry_after_s() == j.retry_after_s()
            assert p.state_code() == j.state_code()
    assert [(e.action, e.point, e.cause) for e in log.events] == \
        [(e.action, e.point, e.cause) for e in jlog.events]
    assert reg.counters() == jreg.counters()
    assert [s.name for s in tracer.spans] == \
        ["breaker.transition"] * len(log)


def test_call_raises_circuit_open_error_in_both():
    p, _, _, j, _, _, _ = _breakers(failure_threshold=1, reset_timeout_s=60)
    for br, err in ((p, R.CircuitOpenError), (j, JR.CircuitOpenError)):
        with pytest.raises(ValueError):
            br.call(lambda: (_ for _ in ()).throw(ValueError("x")))
        with pytest.raises(err) as ei:
            br.call(lambda: 42)
        assert ei.value.retry_after_s == 60.0
    assert str(ei.value).startswith("breaker 't' is open")


@pytest.mark.parametrize("kw", [dict(), dict(min_limit=2, increase=2.0,
                                             decrease=0.5, initial=10)])
def test_adaptive_limit_follows_the_jax_aimd(kw):
    p = R.AdaptiveConcurrencyLimit(target_latency_s=0.05, max_limit=64, **kw)
    j = JR.AdaptiveConcurrencyLimit(target_latency_s=0.05, max_limit=64,
                                    **kw)
    lat = [0.01] * 5 + [0.2] * 12 + [0.04] * 30 + [0.06, 0.01] * 10
    for x in lat:
        assert p.observe(x) == j.observe(x)
        assert p.limit == j.limit
    assert p.snapshot() == j.snapshot()
    with pytest.raises(ValueError):
        R.AdaptiveConcurrencyLimit(target_latency_s=1, max_limit=0)


def _controllers(cfg_kw, queue_bound=100, max_batch=4):
    from transmogrifai_tpu.telemetry import MetricsRegistry as JReg
    clk = _Clock()
    reg, jreg = MetricsRegistry(), JReg()
    p = O.OverloadController(O.OverloadConfig(**cfg_kw),
                             queue_bound=queue_bound, max_batch=max_batch,
                             registry=reg, log=R.FailureLog())
    j = JO.OverloadController(JO.OverloadConfig(**cfg_kw),
                              queue_bound=queue_bound, max_batch=max_batch,
                              registry=jreg)
    for c in (p, j):
        c.compiled_breaker._clock = clk
        c.reload_breaker._clock = clk
    return p, reg, j, jreg, clk


# admission and health sequences: ("admit", depth, extra, deadline,
# est_bytes) / ("batch", latency) / ("health", depth, draining, compiled_ok)
# / ("fail", ) on the compiled breaker / ("advance", dt) / ("allow", )
CONTROLLER_CASES = {
    "static_limit": (dict(adaptive=False), 8, [
        ("admit", 7, 1, None, None), ("admit", 8, 1, None, None),
        ("admit", 3, 6, None, None), ("batch", 0.3),
        ("admit", 8, 1, None, None)]),
    "adaptive_tightens": (dict(latency_target_ms=10.0, min_limit=4), 100, [
        ("admit", 50, 1, None, None)] + [("batch", 1.0)] * 50 + [
        ("admit", 4, 1, None, None), ("admit", 3, 1, None, None)]
        + [("batch", 0.001)] * 7 + [("admit", 10, 1, None, None)]),
    "deadline": (dict(adaptive=False), 1000, [
        ("admit", 500, 1, 0.01, None)] + [("batch", 0.5)] * 10 + [
        ("admit", 500, 1, 0.01, None), ("admit", 10, 1, 60.0, None),
        ("admit", 3, 1, 0.3, None), ("admit", 3, 2, 0.3, None)]),
    "queue_deadline_ms": (dict(adaptive=False, queue_deadline_ms=1.0), 1000,
                          [("batch", 0.2), ("admit", 50, 1, None, None),
                           ("admit", 0, 1, 5.0, None)]),
    "memory_budget": (dict(adaptive=False, batch_bytes_budget=4096), 1000, [
        ("admit", 0, 1, None, 4000), ("admit", 0, 1, None, 4097),
        ("batch", 2.5), ("admit", 9, 1, None, 10 ** 6)]),
    "brownout_and_draining": (dict(adaptive=False, brownout_high=0.75,
                                   brownout_low=0.5), 100, [
        ("health", 0, False, True), ("health", 80, False, True),
        ("health", 60, False, True), ("health", 10, False, True),
        ("health", 0, False, False), ("fail",), ("fail",), ("fail",),
        ("health", 0, False, True), ("advance", 5.5),
        ("health", 0, False, True), ("allow",), ("ok",),
        ("health", 0, False, True), ("health", 0, True, True),
        ("health", 0, False, True)]),
}


# the one reason worded apart: the port demotes only at warm-up (an online
# kernel build is paid once, where an online JAX trace recurs)
JAX_REASON = "compiled path demoted at warmup or by online traces"


def _jax_snapshot(j):
    snap = j.snapshot()
    if snap["health"]["reason"] == JAX_REASON:
        snap["health"]["reason"] = "compiled path demoted at warmup"
    return snap


@pytest.mark.parametrize("name", list(CONTROLLER_CASES))
def test_controllers_make_the_same_decisions(name):
    cfg, bound, seq = CONTROLLER_CASES[name]
    p, reg, j, jreg, clk = _controllers(cfg, queue_bound=bound)
    for step in seq:
        op = step[0]
        if op == "admit":
            _, depth, extra, deadline, est = step
            g = p.admit(depth, extra, deadline_s=deadline, est_bytes=est)
            w = j.admit(depth, extra, deadline_s=deadline, est_bytes=est)
            assert (g is None) == (w is None), step
            if g is not None:
                assert (g.kind, g.message, g.retry_after_s) == \
                    (w.kind, w.message, w.retry_after_s)
        elif op == "batch":
            p.observe_batch(step[1])
            j.observe_batch(step[1])
        elif op == "health":
            kw = dict(queue_depth=step[1], draining=step[2],
                      compiled_ok=step[3])
            assert p.refresh_health(**kw) == j.refresh_health(**kw)
        elif op == "fail":
            p.compiled_breaker.record_failure("x")
            j.compiled_breaker.record_failure("x")
        elif op == "ok":
            p.compiled_breaker.record_success()
            j.compiled_breaker.record_success()
        elif op == "allow":
            assert p.compiled_breaker.allow() == j.compiled_breaker.allow()
        else:
            clk.t += step[1]
        assert p.snapshot() == _jax_snapshot(j)
        assert p.admission_limit() == j.admission_limit()
        assert p.estimate_wait_s(7) == j.estimate_wait_s(7)
    assert reg.counters() == jreg.counters()
    assert reg.snapshot()["gauges"] == jreg.snapshot()["gauges"]


def test_health_machine_and_config_are_the_jax_packages():
    assert O.HEALTH_STATES == JO.HEALTH_STATES
    assert O.HEALTH_CODES == JO.HEALTH_CODES
    params = {"latencyTargetMs": 25.0, "adaptiveLimit": False,
              "queueDeadlineMs": 500, "breakerFailures": 7,
              "brownoutHigh": 0.9, "batchBytesBudget": 1 << 20, "port": 1}
    got = O.OverloadConfig.from_params(params)
    want = JO.OverloadConfig.from_params(params)
    assert got.__dict__ == want.__dict__
    assert O.OverloadConfig.from_params(None).__dict__ == \
        JO.OverloadConfig().__dict__
    reg = MetricsRegistry()
    h, jh = O.HealthStateMachine(reg), JO.HealthStateMachine()
    for to, why in (("SERVING", "a"), ("BROWNOUT", "b"), ("DEGRADED", "c"),
                    ("DRAINING", "d"), ("SERVING", "e")):
        assert h.set_state(to, why) == jh.set_state(to, why)
        assert h.snapshot() == jh.snapshot()
    assert reg.counters()["health_transitions_total"] == 3
    with pytest.raises(ValueError):
        h.set_state("BOGUS", "x")


@pytest.mark.parametrize("headroom", [None, "2.5", "0.5", "junk"])
def test_estimate_batch_bytes_is_the_jax_packages(monkeypatch, headroom):
    from transmogrifai_tpu.parallel.memory import estimate_batch_bytes
    if headroom is None:
        monkeypatch.delenv("TRANSMOGRIFAI_MEMORY_HEADROOM", raising=False)
    else:
        monkeypatch.setenv("TRANSMOGRIFAI_MEMORY_HEADROOM", headroom)
    for rows, width in ((1, 1), (64, 28), (4096, 1596), (3, 0)):
        assert O.estimate_batch_bytes(rows, width) == \
            estimate_batch_bytes(rows, width)


def test_run_with_deadline_returns_raises_and_times_out_as_jax():
    for mod in (R, JR):
        assert mod.run_with_deadline(lambda a, b=0: a + b, 5.0, 2, b=3) == 5
        assert mod.run_with_deadline(lambda: 7, None) == 7
        with pytest.raises(KeyError, match="inner"):
            mod.run_with_deadline(
                lambda: (_ for _ in ()).throw(KeyError("inner")), 5.0)
        with pytest.raises(mod.WatchdogTimeout):
            mod.run_with_deadline(time.sleep, 0.05, 0.5, description="nap")


def test_an_abandoned_worker_records_into_the_given_log():
    log = R.FailureLog()
    release = threading.Event()
    with pytest.raises(R.WatchdogTimeout, match="slow"):
        R.run_with_deadline(release.wait, 0.05, 5.0, description="slow",
                            log=log)
    (ev,) = log.by_action("degraded")
    assert ev.point == "watchdog.abandoned"
    release.set()
    deadline = time.monotonic() + 5
    while not log.by_action("swallowed") and time.monotonic() < deadline:
        time.sleep(0.01)
    (orphan,) = log.by_action("swallowed")
    assert orphan.point == "watchdog.orphan"


def test_fault_injection_decides_as_the_jax_package():
    kw = dict(rates={"serving.batch": 0.3, "serving.reload": 0.7},
              fail_keys={"serving.batch": [3, "x"]}, seed=11)
    p, j = R.FaultInjector(**kw), JR.FaultInjector(**kw)
    for point in ("serving.batch", "serving.reload", "other"):
        for key in list(range(40)) + ["x", None, None]:
            assert p.should_fail(point, key) == j.should_fail(point, key)
    with R.inject_faults(R.FaultInjector(fail_keys={"p": [1]})) as inj:
        R.maybe_inject("p", 0)
        with pytest.raises(R.InjectedFault):
            R.maybe_inject("p", 1)
        assert inj.fired == [("p", "1")]
    R.maybe_inject("p", 1)                       # uninstalled: a no-op


def test_failure_log_refuses_unknown_actions_and_summarises():
    log = R.FailureLog()
    for a in ("shed", "shed", "fallback"):
        log.record("serving", a, "why", point="serving.admit")
    assert log.summary() == {"shed": 2, "fallback": 1}
    assert set(R.FailureLog.ACTIONS) <= set(JR.FailureLog.ACTIONS)
    with pytest.raises(ValueError, match="unknown failure action"):
        log.record("x", "exploded")
    R.record_failure(None, "x", "shed")          # no log, no record
    assert log.events[0].to_json() == {
        "stage": "serving", "action": "shed", "cause": "why",
        "point": "serving.admit"}


# --------------------------------------------------------------------------
# the engine's breakers in its hot path (≙ tests/test_overload.py)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from test_torch_serving import _train_port
    from transmogrifai_tpu_torch.checkpoint import next_version_dir
    r = str(tmp_path_factory.mktemp("overload") / "ckpts")
    model = _train_port(0, False)
    model.save(next_version_dir(r))
    return r, model


def test_compiled_breaker_demotes_then_recovers_on_the_engine_device(root):
    from transmogrifai_tpu_torch.serving import ScoringEngine
    path, _ = root
    eng = ScoringEngine(path, max_batch=4, device="cpu",
                        overload=O.OverloadConfig(
                            breaker_failures=2, breaker_window=8,
                            breaker_min_calls=100, breaker_reset_s=0.2))
    rec = {"x": 0.5}
    try:
        want, _ = eng.score_record(rec, timeout_s=30)
        n = int(eng.metrics.counter("batches_total").value)
        with R.inject_faults(R.FaultInjector(
                fail_keys={"serving.batch": [n, n + 1]})):
            for _ in range(2):
                assert eng.score_record(rec, timeout_s=30)[0] == want
        br = eng.overload.compiled_breaker
        assert br.current_state() == br.OPEN
        assert eng.compiled_path_active
        assert eng.score_record(rec, timeout_s=30)[0] == want
        c = eng.metrics.counters()
        assert c["breaker_demoted_batches_total"] >= 1
        assert c["fallback_batches_total"] == 3
        assert eng.stats()["overload"]["health"]["state"] == O.DEGRADED
        fb = eng.failure_log.by_action("fallback")
        assert len(fb) == 2 and all(e.point == "serving.batch" for e in fb)
        assert eng.failure_log.by_action("breaker_open")
        time.sleep(0.25)
        deadline = time.monotonic() + 5.0
        while br.current_state() != br.CLOSED \
                and time.monotonic() < deadline:
            eng.score_record(rec, timeout_s=30)
        assert br.current_state() == br.CLOSED
        assert eng.failure_log.by_action("breaker_closed")
        assert eng.stats()["failures"]["breaker_half_open"] == 1
    finally:
        eng.close()


def test_reload_breaker_stops_a_tight_retry_loop(root, tmp_path):
    import shutil

    from transmogrifai_tpu_torch.checkpoint import (bundle_version,
                                                    next_version_dir)
    from transmogrifai_tpu_torch.serving import ScoringEngine
    path, model = root
    r = str(tmp_path / "ckpts")
    shutil.copytree(path, r)
    eng = ScoringEngine(r, max_batch=2, device="cpu", warm=False,
                        overload=O.OverloadConfig(reload_breaker_failures=2,
                                                  reload_breaker_reset_s=0.3))
    try:
        v2 = next_version_dir(r)
        model.save(v2)
        inj = R.FaultInjector(fail_keys={"serving.reload":
                                         [bundle_version(v2)]})
        with R.inject_faults(inj):
            assert not eng.reload_now()
            assert not eng.reload_now()
            fired = len(inj.fired)
            assert not eng.reload_now()
            assert len(inj.fired) == fired
        assert eng.metrics.counter("reload_breaker_skipped_total").value >= 1
        time.sleep(0.35)
        assert eng.reload_now()
        assert eng.model_version == bundle_version(v2)
    finally:
        eng.close()


def test_brownout_sheds_observers_before_traffic(root):
    from transmogrifai_tpu_torch.serving import ScoringEngine
    path, _ = root
    eng = ScoringEngine(path, max_batch=4, device="cpu", warm=False,
                        overload=O.OverloadConfig(brownout_high=0.0,
                                                  brownout_low=-1.0))
    try:
        seen = []
        eng.add_batch_observer(lambda recs, res: seen.append(len(recs)))
        assert eng.score_record({"x": 1.0}, timeout_s=30)
        assert seen == []
        assert eng.metrics.counter("brownout_sheds_total").value >= 1
        assert eng.stats()["overload"]["health"]["state"] == O.BROWNOUT
    finally:
        eng.close()


def test_deadline_shed_raises_overloaded_with_retry_after(root):
    from transmogrifai_tpu_torch.serving import OverloadedError, ScoringEngine
    path, _ = root
    eng = ScoringEngine(path, max_batch=4, device="cpu", warm=False,
                        overload=O.OverloadConfig(adaptive=False))
    try:
        for _ in range(5):
            eng.overload.observe_batch(2.0)
        with pytest.raises(OverloadedError) as ei:
            eng.score_record({"x": 1.0}, timeout_s=0.01)
        assert ei.value.retry_after_s >= 1.0
        assert eng.metrics.counter("shed_deadline_total").value == 1
        (ev,) = eng.failure_log.by_action("shed")
        assert ev.detail["kind"] == "deadline"
    finally:
        eng.close()


def test_readyz_fails_while_the_breaker_is_open_healthz_stays_200(root):
    import json
    import urllib.error
    import urllib.request

    from transmogrifai_tpu_torch.serving import start_server
    path, _ = root
    srv, th = start_server(path, port=0, max_batch=2, device="cpu",
                           overload=O.OverloadConfig(breaker_failures=1,
                                                     breaker_reset_s=30))
    try:
        srv.engine.overload.compiled_breaker.record_failure("down")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz") as r:
            assert r.status == 200
            assert json.loads(r.read())["health"] == "SERVING"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/readyz")
        assert e.value.code == 503
        assert int(e.value.headers["Retry-After"]) >= 29
        assert json.loads(e.value.read())["reasons"] == [
            "compiled-path breaker open"]
    finally:
        srv.drain_and_close()
        th.join(timeout=10)
