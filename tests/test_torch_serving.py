"""The port's serving engine and HTTP server against the JAX package's, on
the CPU.

Two bundles, each trained once a test session and shared by the xdist
workers (a lock file beside it): a y ~ x logistic regression trained by
the JAX package (``tests/test_serving.py``'s model) and the same workflow
trained by the port.  Each is served by both packages: the port's engines
with ``device="cpu"`` and ``max_batch=4``, the JAX package's as its own
tests make them.  Held: predictions equal, probabilities within 1e-6
absolute, margins within max(1e-6, 16 f32 ulps)
(``tests/test_torch_persistence.py::assert_scores_close``); version tags,
status codes, JSON bodies (scores within the same bound), failure actions,
points and trace ids equal.  A second version of each model (the label
relation flipped) drives the hot-reload cases.
"""

import fcntl
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_persistence import assert_scores_close  # noqa: E402
from transmogrifai_tpu_torch.checkpoint import next_version_dir  # noqa: E402
from transmogrifai_tpu_torch.serving import (EngineClosed,  # noqa: E402
                                             OverloadedError, ScoringEngine,
                                             wire)
from transmogrifai_tpu_torch.serving.server import (  # noqa: E402
    render_metrics, start_server)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINERS = ("jax", "port")
MAX_BATCH = 4


# --------------------------------------------------------------------------
# the bundles
# --------------------------------------------------------------------------

def _data(seed, flip):
    rng = np.random.default_rng(seed)
    sgn = -1.0 if flip else 1.0
    y = np.array([float(i % 2) for i in range(120)])
    x = np.array([sgn * (float(rng.normal()) + (i % 2)) for i in range(120)])
    return x, y


def _train_jax(seed, flip):
    from transmogrifai_tpu.features import FeatureBuilder
    from transmogrifai_tpu.models.linear import OpLogisticRegression
    from transmogrifai_tpu.ops.transmogrify import transmogrify
    from transmogrifai_tpu.selector import (BinaryClassificationModelSelector,
                                            ModelCandidate, grid)
    from transmogrifai_tpu.workflow import Workflow
    x, y = _data(seed, flip)
    label = FeatureBuilder.RealNN("y").as_response()
    xf = FeatureBuilder.Real("x").as_predictor()
    sel = BinaryClassificationModelSelector(models=[ModelCandidate(
        OpLogisticRegression(), grid(reg_param=[0.01]), "LR")])
    sel.set_input(label, transmogrify([xf]))
    records = [{"y": float(a), "x": float(b)} for a, b in zip(y, x)]
    return (Workflow().set_input_records(records)
            .set_result_features(sel.get_output()).train())


def _train_port(seed, flip):
    from transmogrifai_tpu_torch.columns import Column, ColumnBatch
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.models.linear import OpLogisticRegression
    from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    from transmogrifai_tpu_torch.selector import (
        BinaryClassificationModelSelector, ModelCandidate, grid)
    from transmogrifai_tpu_torch.types import Real, RealNN
    from transmogrifai_tpu_torch.workflow import Workflow
    x, y = _data(seed, flip)
    label = FeatureBuilder.RealNN("y").as_response()
    xf = FeatureBuilder.Real("x").as_predictor()
    sel = BinaryClassificationModelSelector(models=[ModelCandidate(
        OpLogisticRegression(), grid(reg_param=[0.01]), "LR")])
    sel.set_input(label, transmogrify([xf]))
    batch = ColumnBatch({"y": Column(RealNN, y.astype(np.float32)),
                         "x": Column(Real, x.astype(np.float32),
                                     mask=np.ones(len(x), bool))}, len(x))
    return (Workflow(device="cpu").set_input_batch(batch)
            .set_result_features(sel.get_output()).train())


@pytest.fixture(scope="session")
def shared_root(tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    return str(base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base)


def shared_bundle(root, trainer, version=1):
    """The bundle of ``trainer``'s model (version 2: the flipped label
    relation), trained and saved once a session under a lock."""
    path = os.path.join(root, f"serving-{trainer}-v{version}")
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(os.path.join(path, "done")):
            shutil.rmtree(path, ignore_errors=True)
            train = _train_jax if trainer == "jax" else _train_port
            train(7 if version == 2 else 0, version == 2).save(
                os.path.join(path, "bundle"))
            open(os.path.join(path, "done"), "w").close()
    return os.path.join(path, "bundle")


@pytest.fixture(scope="module", params=TRAINERS)
def served(request, shared_root):
    """(trainer, bundle path, prediction name, port engine, JAX engine)."""
    from transmogrifai_tpu.serving import ScoringEngine as JaxEngine
    path = shared_bundle(shared_root, request.param)
    port = ScoringEngine(path, max_batch=MAX_BATCH, device="cpu")
    jax_eng = JaxEngine(path, max_batch=MAX_BATCH)
    (pred,) = [f.name for f in port._entry.model.result_features]
    yield request.param, path, pred, port, jax_eng
    port.close()
    jax_eng.close()


def _arrays(results, pred):
    """JSON result rows → prediction arrays for ``assert_scores_close``."""
    rows = [r[pred] for r in results]
    out = {"prediction": np.array([r["prediction"] for r in rows])}
    for base in ("probability", "rawPrediction"):
        out[base] = np.array([[r[f"{base}_{j}"] for j in range(2)]
                              for r in rows])
    return out


def _assert_json_close(got, want, path="$"):
    """Equal JSON, numbers within ``assert_scores_close``'s bound."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_json_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_json_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        if path.endswith("prediction"):
            assert got == want, path
        else:
            bound = max(1e-6, 16 * float(np.spacing(np.float32(abs(want)))))
            assert abs(got - want) <= bound, (path, got, want)
    else:
        assert got == want, (path, got, want)


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

def test_records_and_lists_score_as_the_jax_engine(served):
    _, _, pred, port, jax_eng = served
    one = {"x": 1.25}
    got, gv = port.score_record(one, timeout_s=60)
    want, wv = jax_eng.score_record(one, timeout_s=60)
    assert gv == wv == port.model_version
    assert_scores_close(_arrays([got], pred), _arrays([want], pred))
    for n in (3, MAX_BATCH):
        recs = [{"x": (i - 1.5) / 2.0} for i in range(n)]
        recs[1] = {"x": None}
        got = port.score_records(recs, timeout_s=60)
        want = jax_eng.score_records(recs, timeout_s=60)
        assert [v for _, v in got] == [v for _, v in want]
        assert_scores_close(_arrays([r for r, _ in got], pred),
                            _arrays([r for r, _ in want], pred))
    s = port.stats()
    assert s["counters"]["online_builds_total"] == 0
    assert s["compiled_path_active"] and s["device"] == "cpu"
    assert s["counters"].get("fallback_batches_total", 0) == 0


def test_concurrent_clients_score_as_the_jax_engine(served):
    """8 concurrent clients x 10 records through each engine."""
    _, _, pred, port, jax_eng = served
    outs = {}

    def run(eng, key):
        res = [None] * 80
        errors = []

        def client(c):
            try:
                for j in range(10):
                    i = c * 10 + j
                    res[i] = eng.score_record({"x": (i - 40) / 8.0},
                                              timeout_s=60)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors[:3]
        outs[key] = res

    b0 = port.stats()["counters"].get("batches_total", 0)
    run(port, "port")
    run(jax_eng, "jax")
    assert [v for _, v in outs["port"]] == [v for _, v in outs["jax"]]
    assert_scores_close(_arrays([r for r, _ in outs["port"]], pred),
                        _arrays([r for r, _ in outs["jax"]], pred))
    c = port.stats()["counters"]
    assert c["online_builds_total"] == 0
    assert c["batches_total"] - b0 <= 80


def test_batcher_coalesces_and_pads_to_the_ladder(served):
    """8 records queued behind a held device lock leave as two batches of
    ``max_batch``; the warm-up scored every rung."""
    _, _, _, port, _ = served
    assert port.ladder == [1, 2, 4]
    c0 = {k: port.stats()["counters"].get(k, 0)
          for k in ("batch_rows_total", "batches_total")}
    got = []
    with port._score_lock:
        t = threading.Thread(target=lambda: got.extend(port.score_records(
            [{"x": float(i)} for i in range(8)], timeout_s=60)))
        t.start()
        deadline = time.monotonic() + 10
        while port.queue_depth != 4 and time.monotonic() < deadline:
            time.sleep(0.002)
        assert port.queue_depth == 4
    t.join(timeout=60)
    c1 = port.stats()["counters"]
    assert len(got) == 8
    assert c1["batch_rows_total"] - c0["batch_rows_total"] == 8
    assert c1["batches_total"] - c0["batches_total"] == 2
    assert "warmup_builds_total" in c1


def test_columnar_scores_equal_the_json_path_bit_for_bit(served):
    _, _, pred, port, jax_eng = served
    recs = [{"x": -0.25}, {"x": 0.1}, {"x": 2.0}, {"x": -3.0}, {"x": None},
            {"x": 0.75}]
    body = wire.encode_records(recs)
    arrays, version = port.score_columns(
        wire.decode_batch(body, port.raw_features), timeout_s=60)
    assert version == port.model_version
    rows = [r for r, _ in port.score_records(recs, timeout_s=60)]
    for field in ("prediction", "probability_0", "probability_1",
                  "rawPrediction_0", "rawPrediction_1"):
        cvals = np.asarray(arrays[f"{pred}.{field}"][0], np.float64)
        jvals = np.array([r[pred][field] for r in rows], np.float64)
        assert np.array_equal(cvals.view(np.uint64), jvals.view(np.uint64))
    from transmogrifai_tpu.serving import wire as jwire
    jarrays, _ = jax_eng.score_columns(
        jwire.decode_batch(body, jax_eng.raw_features), timeout_s=60)
    assert sorted(arrays) == sorted(jarrays)
    got = {"prediction": arrays[f"{pred}.prediction"][0],
           **{b: np.stack([arrays[f"{pred}.{b}_{j}"][0] for j in range(2)],
                          1) for b in ("probability", "rawPrediction")}}
    want = {"prediction": jarrays[f"{pred}.prediction"][0],
            **{b: np.stack([jarrays[f"{pred}.{b}_{j}"][0] for j in range(2)],
                           1) for b in ("probability", "rawPrediction")}}
    assert_scores_close(got, want)


def test_engine_defaults_to_cuda_and_raises_without_it(served):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device serves")
    _, path, _, _, _ = served
    with pytest.raises(RuntimeError, match="CUDA"):
        ScoringEngine(path, max_batch=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        start_server(path, port=0, max_batch=2)


def test_failed_warmup_serves_through_the_row_path_on_the_engine_device(
        served):
    """A compiled path that fails at warm-up demotes the engine: every
    batch is served row at a time by ``local.score_function`` on the
    engine's device, with a "degraded" record, ``compiled_path_active`` 0
    and DEGRADED on ``/readyz`` — scores equal to the compiled path's."""
    _, path, pred, port, _ = served
    eng = ScoringEngine(path, max_batch=2, device="cpu", warm=False)
    srv = None
    try:
        def boom(entry, records):
            raise RuntimeError("compiled path down")
        eng._score_compiled = boom
        eng._warm(eng._entry)
        assert not eng.compiled_path_active
        (ev,) = eng.failure_log.by_action("degraded")
        assert ev.point == "serving.batch" and "warmup" in ev.detail["detail"]
        assert eng._entry.model.device.type == "cpu"
        got, _ = eng.score_record({"x": 0.5}, timeout_s=60)
        want, _ = port.score_record({"x": 0.5}, timeout_s=60)
        assert_scores_close(_arrays([got], pred), _arrays([want], pred))
        s = eng.stats()
        assert s["counters"]["fallback_batches_total"] == 1
        assert s["failures"] == {"degraded": 1}
        assert "compiled_path_active 0" in render_metrics(eng)
        from transmogrifai_tpu_torch.serving import ScoringHTTPServer
        srv = ScoringHTTPServer(eng, port=0)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        status, body, _ = _get(srv.port, "/readyz")
        assert status == 200
        assert json.loads(body)["health"] == "DEGRADED"
    finally:
        if srv is not None:
            srv.drain_and_close()
            th.join(timeout=10)
        eng.close()


# --------------------------------------------------------------------------
# hot reload
# --------------------------------------------------------------------------

def _root_with(shared_root, trainer, tmp_path, versions):
    root = str(tmp_path / "ckpts")
    for v in versions:
        shutil.copytree(shared_bundle(shared_root, trainer, v),
                        next_version_dir(root))
    return root


@pytest.mark.parametrize("trainer", TRAINERS)
def test_reload_swaps_in_the_newer_version(shared_root, trainer, tmp_path):
    from transmogrifai_tpu.serving import ScoringEngine as JaxEngine
    root = _root_with(shared_root, trainer, tmp_path, [1])
    port = ScoringEngine(root, max_batch=2, device="cpu")
    jax_eng = JaxEngine(root, max_batch=2)
    try:
        v1 = port.model_version
        assert "ckpt-000001" in v1 and v1 == jax_eng.model_version
        assert not port.reload_now()
        shutil.copytree(shared_bundle(shared_root, trainer, 2),
                        next_version_dir(root))
        assert port.reload_now() and jax_eng.reload_now()
        v2 = port.model_version
        assert "ckpt-000002" in v2 and v2 == jax_eng.model_version
        assert port.stats()["counters"]["reloads_total"] == 1
        (ev,) = port.failure_log.by_action("reloaded")
        assert ev.point == "serving.reload"
        assert ev.detail["previous"] == v1 and ev.detail["current"] == v2
        (pred,) = [f.name for f in port._entry.model.result_features]
        got, gv = port.score_record({"x": 1.0}, timeout_s=60)
        want, wv = jax_eng.score_record({"x": 1.0}, timeout_s=60)
        assert gv == wv == v2
        assert_scores_close(_arrays([got], pred), _arrays([want], pred))
        assert port.stats()["counters"]["online_builds_total"] == 0
    finally:
        port.close()
        jax_eng.close()


@pytest.mark.parametrize("trainer", TRAINERS)
def test_corrupt_candidate_is_skipped(shared_root, trainer, tmp_path):
    root = _root_with(shared_root, trainer, tmp_path, [1])
    eng = ScoringEngine(root, max_batch=1, device="cpu", warm=False)
    try:
        v1 = eng.model_version
        bad = next_version_dir(root)
        shutil.copytree(shared_bundle(shared_root, trainer, 2), bad)
        with open(os.path.join(bad, "params.npz"), "r+b") as fh:
            fh.write(b"\xff\xff\xff\xff")          # digest mismatch
        assert not eng.reload_now()
        assert eng.model_version == v1
        assert eng.stats()["counters"].get("reloads_total", 0) == 0
        skipped = eng.failure_log.by_action("skipped")
        assert any("ckpt-000002" in e.detail.get("bundle", "")
                   for e in skipped)
    finally:
        eng.close()


def test_reload_racing_close_neither_deadlocks_nor_raises(shared_root,
                                                          tmp_path):
    root = _root_with(shared_root, "port", tmp_path, [1])
    eng = ScoringEngine(root, max_batch=2, device="cpu", warm=False)
    barrier = threading.Barrier(2)
    errs = []

    def reloader():
        barrier.wait()
        try:
            for _ in range(5):
                eng.reload_now()
        except EngineClosed:
            pass
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    def closer():
        barrier.wait()
        eng.close(drain=True, timeout_s=30)

    threads = [threading.Thread(target=reloader),
               threading.Thread(target=closer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errs
    eng.close()
    with pytest.raises(EngineClosed):
        eng.score_record({"x": 0.0}, timeout_s=5)


# --------------------------------------------------------------------------
# failure accounting (≙ tests/test_serving.py::TestFailureAccounting)
# --------------------------------------------------------------------------

def _jax_events(run):
    from transmogrifai_tpu.resilience import FailureLog, use_failure_log
    log = FailureLog()
    with use_failure_log(log):
        run()
    return log


@pytest.mark.parametrize("path_kind", ["json", "columnar"])
def test_dead_letters_carry_the_jax_action_point_and_trace_id(served,
                                                              path_kind):
    from transmogrifai_tpu.serving import ScoringEngine as JaxEngine
    from transmogrifai_tpu.serving import wire as jwire
    from transmogrifai_tpu.telemetry import TraceContext as JaxCtx
    from transmogrifai_tpu_torch.telemetry import TraceContext
    _, path, _, _, _ = served
    ctx = TraceContext.new()
    events = {}
    for pkg in ("port", "jax"):
        eng = (ScoringEngine(path, max_batch=4, device="cpu", warm=False)
               if pkg == "port" else JaxEngine(path, max_batch=4, warm=False))
        c = ctx if pkg == "port" else JaxCtx(ctx.trace_id, ctx.span_id)
        try:
            eng._compiled_ok = False
            orig = eng._entry.local_fn

            def poisoned(rec, orig=orig):
                if path_kind == "columnar" or rec.get("x") == 666.0:
                    raise RuntimeError("poisoned row")
                return orig(rec)
            eng._entry.local_fn = poisoned

            def run():
                with pytest.raises(RuntimeError, match="poisoned row"):
                    if path_kind == "json":
                        eng.score_record({"x": 666.0}, timeout_s=60, ctx=c)
                    else:
                        w = wire if pkg == "port" else jwire
                        eng.score_columns(w.decode_batch(
                            w.encode_records([{"x": 1.0}]),
                            eng.raw_features), timeout_s=60, ctx=c)
                if path_kind == "json":
                    eng.score_record({"x": 0.5}, timeout_s=60)
            log = eng.failure_log if pkg == "port" else _jax_events(run)
            if pkg == "port":
                run()
            (ev,) = log.by_action("dead_letter")
            events[pkg] = (ev.action, ev.point, ev.detail["trace_id"],
                           ev.detail.get("row"))
            assert eng.stats()["counters"]["dead_letter_total"] == 1
        finally:
            eng.close()
    assert events["port"] == events["jax"]
    assert events["port"][2] == ctx.trace_id


def test_quarantine_events_match_the_jax_engine(served):
    from transmogrifai_tpu.telemetry import TraceContext as JaxCtx
    from transmogrifai_tpu_torch.quality import RecordQualityError
    from transmogrifai_tpu_torch.telemetry import TraceContext
    _, _, _, port, jax_eng = served
    ctx = TraceContext.new()
    n0 = len(port.failure_log.by_action("quarantined"))
    with pytest.raises(RecordQualityError) as pe:
        port.score_record({"x": "junk"}, timeout_s=30, ctx=ctx)

    def run():
        with pytest.raises(Exception) as je:
            jax_eng.score_record({"x": "junk"}, timeout_s=30,
                                 ctx=JaxCtx(ctx.trace_id, ctx.span_id))
        assert type(je.value).__name__ == "RecordQualityError"
        run.err = je.value
    jlog = _jax_events(run)
    assert pe.value.to_json() == run.err.to_json()
    ev = port.failure_log.by_action("quarantined")[n0]
    (jev,) = jlog.by_action("quarantined")
    assert (ev.action, ev.point, ev.detail["trace_id"],
            ev.detail["violations"], ev.cause) == (
        jev.action, jev.point, jev.detail["trace_id"],
        jev.detail["violations"], jev.cause)


# --------------------------------------------------------------------------
# HTTP
# --------------------------------------------------------------------------

def _post(port, payload, raw=None, ctype="application/json", timeout=60):
    body = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/score",
                                 data=body, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _get(port, path, timeout=30):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


@pytest.fixture(scope="module")
def servers(served):
    """(port server, JAX server) on the same bundle."""
    from transmogrifai_tpu.serving.server import start_server as jax_start
    trainer, path, pred, _, _ = served
    ps, pt = start_server(path, port=0, max_batch=MAX_BATCH, queue_bound=64,
                          device="cpu")
    js, jt = jax_start(path, port=0, max_batch=MAX_BATCH, queue_bound=64)
    yield ps, js, pred
    for s, t in ((ps, pt), (js, jt)):
        s.drain_and_close()
        t.join(timeout=10)


def _both(servers, fn):
    ps, js, _ = servers
    return fn(ps), fn(js)


def _same_json_reply(got, want):
    assert got[0] == want[0]
    _assert_json_close(json.loads(got[1]), json.loads(want[1]))


REQUESTS = {
    "one": ({"x": -0.25}, None, "application/json"),
    "list": ([{"x": 0.1}, {"x": 2.0}, {"x": None}], None,
             "application/json"),
    "not_an_object": ("not-an-object", None, "application/json"),
    "list_of_non_objects": ([{"x": 1.0}, 5], None, "application/json"),
    "malformed_json": (None, b"{nope", "application/json"),
    "nan": (None, b'{"x": NaN}', "application/json"),
    "string_in_a_number": ({"x": "abc"}, None, "application/json"),
    "list_with_a_bad_row": ([{"x": 1.0}, {"x": "1e999"}], None,
                            "application/json"),
    "unknown_field_coerced": ({"x": "2.5", "z": 1}, None,
                              "application/json"),
}
STATUS = {"one": 200, "list": 200, "not_an_object": 400,
          "list_of_non_objects": 400, "malformed_json": 400, "nan": 422,
          "string_in_a_number": 422, "list_with_a_bad_row": 422,
          "unknown_field_coerced": 200}


@pytest.mark.parametrize("name", list(REQUESTS))
def test_json_requests_get_the_jax_status_and_body(servers, name):
    payload, raw, ctype = REQUESTS[name]
    got, want = _both(servers, lambda s: _post(s.port, payload, raw, ctype))
    assert got[0] == STATUS[name]
    _same_json_reply(got, want)
    assert got[2]["traceparent"].startswith("00-")


def test_columnar_requests_get_the_jax_status_and_bytes(servers):
    ps, js, pred = servers
    recs = [{"x": -0.25}, {"x": 0.1}, {"x": None}, {"x": 5.0}, {"x": 0.0}]
    body = wire.encode_records(recs)
    got, want = _both(servers, lambda s: _post(s.port, None, body,
                                               wire.CONTENT_TYPE))
    assert got[0] == want[0] == 200
    assert got[2]["Content-Type"] == wire.CONTENT_TYPE
    assert got[2]["X-Model-Version"] == want[2]["X-Model-Version"]
    g, w = wire.decode_response(got[1]), wire.decode_response(want[1])
    assert list(g) == list(w)
    assert_scores_close(
        {"prediction": g[f"{pred}.prediction"][0],
         "probability": np.stack([g[f"{pred}.probability_{j}"][0]
                                  for j in range(2)], 1)},
        {"prediction": w[f"{pred}.prediction"][0],
         "probability": np.stack([w[f"{pred}.probability_{j}"][0]
                                  for j in range(2)], 1)})
    corrupt = bytearray(wire.encode_records([{"x": 1.0}]))
    corrupt[18 + len("x")] = 99
    nan = wire.encode_records([{"x": 1.0}, {"x": float("nan")}])
    typed = wire.encode_records([{"x": "a"}])
    for bad, code in ((b"", 400), (b"garbage-not-columnar", 400),
                      (body[:12], 400), (body[:-3], 400),
                      (b"XXXX" + body[4:], 400), (bytes(corrupt), 400),
                      (typed, 400), (nan, 422)):
        got, want = _both(servers, lambda s: _post(s.port, None, bad,
                                                   wire.CONTENT_TYPE))
        assert got[0] == code, bad
        _same_json_reply(got, want)


def test_healthz_readyz_and_unknown_paths_answer_as_the_jax_server(servers):
    for path in ("/healthz", "/readyz", "/nope"):
        got, want = _both(servers, lambda s: _get(s.port, path))
        assert got[0] == want[0]
        g, w = json.loads(got[1]), json.loads(want[1])
        if path == "/healthz":
            assert g.pop("modelStalenessS") == pytest.approx(
                w.pop("modelStalenessS"), abs=5.0)
            g.pop("queueDepth"), w.pop("queueDepth")
            g.pop("qualityQuarantineFraction")
            w.pop("qualityQuarantineFraction")
            assert "@" in g["bundleVersion"]
        assert g == w
    ps, js, _ = servers
    for s in (ps, js):
        s.draining = True
    try:
        got, want = _both(servers, lambda s: _get(s.port, "/healthz"))
        assert json.loads(got[1])["status"] == "draining" == \
            json.loads(want[1])["status"]
        got, want = _both(servers, lambda s: _get(s.port, "/readyz"))
        assert got[0] == want[0] == 503
        assert json.loads(got[1]) == json.loads(want[1])
        assert got[2]["Retry-After"] == want[2]["Retry-After"] == "30"
    finally:
        for s in (ps, js):
            s.draining = False


def test_wire_format_json_refuses_columnar_with_415(served):
    from transmogrifai_tpu.serving.server import start_server as jax_start
    _, path, _, _, _ = served
    ps, pt = start_server(path, port=0, max_batch=2, queue_bound=16,
                          wire_format="json", device="cpu", warm=False)
    js, jt = jax_start(path, port=0, max_batch=2, queue_bound=16,
                       wire_format="json", warm=False)
    try:
        body = wire.encode_records([{"x": 1.0}])
        got, want = [_post(s.port, None, body, wire.CONTENT_TYPE)
                     for s in (ps, js)]
        assert got[0] == want[0] == 415
        _same_json_reply(got, want)
    finally:
        for s, t in ((ps, pt), (js, jt)):
            s.drain_and_close()
            t.join(timeout=10)


def _shed(server, post):
    """Two requests in flight behind the held device lock with
    ``queue_bound=2``, then a third: (its reply, the first two codes)."""
    eng = server.engine
    old = eng.queue_bound
    eng.queue_bound = 2
    codes = []
    try:
        with eng._score_lock:
            t = threading.Thread(target=lambda: codes.append(
                post(server.port, {"x": 0.0})[0]))
            t.start()
            time.sleep(0.2)
            t2 = threading.Thread(target=lambda: codes.append(
                post(server.port, [{"x": 1.0}, {"x": 2.0}])[0]))
            t2.start()
            deadline = time.monotonic() + 10
            while eng.queue_depth != 2 and time.monotonic() < deadline:
                time.sleep(0.002)
            assert eng.queue_depth == 2
            out = post(server.port, {"x": 3.0})
        t.join(timeout=60)
        t2.join(timeout=60)
        return out, codes
    finally:
        eng.queue_bound = old


def test_shed_load_gets_429_with_retry_after_as_the_jax_server(servers):
    got, want = _both(servers, lambda s: _shed(s, _post))
    assert got[0][0] == want[0][0] == 429
    assert got[0][2]["Retry-After"] == want[0][2]["Retry-After"] == "1"
    _same_json_reply(got[0], want[0])
    assert got[1] == want[1] == [200, 200]
    ps = servers[0]
    (ev,) = [e for e in ps.engine.failure_log.by_action("shed")][-1:]
    assert ev.point == "serving.admit" and ev.detail["kind"] == "limit"


# the JAX families the port does not render, with the slice that would
# bring each: XLA compile and AOT (no jit, no executables), the AOT
# registry, racing and host-link counters of the JAX process registry, the
# sparse transform's volumes, drift (item 13) and lifecycle (item 12)
LEFT_OUT = {
    "compile_seconds_total", "backend_compiles_total",
    "compile_cache_hits_total", "compile_cache_misses_total",
    "aot_executables_loaded_total", "aot_fallback_total",
    "aot_registry_hits_total", "aot_registry_misses_total",
    "aot_registry_publishes_total", "aot_registry_evictions_total",
    "aot_registry_shared_hits_total", "aot_registry_bytes",
    "racing_cv_fits_saved_total", "racing_points_pruned_total",
    "host_link_bytes_total", "sparse_nnz_total", "sparse_matrices_total",
    "sparse_matrix_density", "drift_feature_psi",
    "drift_feature_fill_delta", "drift_score_psi", "drift_rows_observed",
    "drift_evaluations_total", "drift_breaches_total",
    "lifecycle_retrains_total", "lifecycle_promotions_total",
    "lifecycle_rejections_total", "lifecycle_preemptions_total",
    "lifecycle_failed_retrains_total",
    "streaming_dead_letters_evicted_total"}
# the JAX family → the port's counterpart
RENAMED = {"online_traces_total": "online_builds_total"}


def _families(text):
    out = set()
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            out.add(ln.split()[2][len("transmogrifai_serving_"):])
    return out


def test_metrics_families_are_the_jax_servers_minus_the_left_out(servers):
    for s in servers[:2]:
        assert _post(s.port, {"x": 0.5})[0] == 200
    got, want = _both(servers, lambda s: _get(s.port, "/metrics"))
    assert got[0] == want[0] == 200
    text = got[1].decode()
    port_f, jax_f = _families(text), _families(want[1].decode())
    assert port_f == {RENAMED.get(f, f) for f in jax_f - LEFT_OUT}
    assert "transmogrifai_serving_online_builds_total 0" in text
    for ln in text.splitlines():
        assert (ln.startswith("# HELP") or ln.startswith("# TYPE")
                or ln.startswith("transmogrifai_serving_"))
    p99 = [ln for ln in text.splitlines() if ln.startswith(
        "transmogrifai_serving_request_latency_seconds")
        and 'quantile="0.99"' in ln]
    assert p99 and float(p99[0].split()[1]) > 0.0


def test_serve_main_drains_on_sigterm(shared_root, tmp_path):
    """``serve_main`` on the CPU: up, scoring, then SIGTERM drains it and it
    returns 0."""
    from transmogrifai_tpu_torch.serving.server import free_port
    root = _root_with(shared_root, "port", tmp_path, [1])
    port = free_port()
    boot = ("import sys; from transmogrifai_tpu_torch.serving import "
            f"serve_main; sys.exit(serve_main({root!r}, port={port}, "
            "max_batch=2, reload_poll_s=0, device='cpu'))")
    proc = subprocess.Popen([sys.executable, "-c", boot], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        deadline = time.monotonic() + 120
        up = False
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                up = _get(port, "/healthz", timeout=2)[0] == 200
                break
            except OSError:
                time.sleep(0.2)
        assert up, proc.stderr.read() if proc.poll() is not None else ""
        assert _post(port, {"x": 0.5})[0] == 200
        proc.terminate()
        rc = proc.wait(timeout=60)
        out, err = proc.communicate()
        assert rc == 0, err[-2000:]
        assert "draining" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_overloaded_error_carries_retry_after(served):
    """Past ``queue_bound`` the engine refuses with ``OverloadedError`` and
    a whole-second retry estimate, records "shed" and counts it."""
    _, _, _, port, _ = served
    old = port.queue_bound
    port.queue_bound = 1
    shed0 = port.stats()["counters"].get("shed_limit_total", 0)
    threads = [threading.Thread(target=lambda v=v: port.score_record(
        {"x": v}, timeout_s=60)) for v in (0.0, 1.0)]
    try:
        with port._score_lock:
            threads[0].start()
            time.sleep(0.2)              # the batcher holds it, waiting
            threads[1].start()
            deadline = time.monotonic() + 10
            while port.queue_depth != 1 and time.monotonic() < deadline:
                time.sleep(0.002)
            with pytest.raises(OverloadedError) as e:
                port.score_record({"x": 2.0}, timeout_s=60)
            assert e.value.retry_after_s >= 1.0
        for t in threads:
            t.join(timeout=60)
        assert port.stats()["counters"]["shed_limit_total"] == shed0 + 1
    finally:
        port.queue_bound = old


def _train_port_text():
    """The port's y ~ x + t logistic regression, ``t`` a hashed text field
    (its scoring loads the ``fasttok`` native helper)."""
    from transmogrifai_tpu_torch.columns import (Column, ColumnBatch,
                                                 text_column)
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.models.linear import OpLogisticRegression
    from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    from transmogrifai_tpu_torch.selector import (
        BinaryClassificationModelSelector, ModelCandidate, grid)
    from transmogrifai_tpu_torch.types import Real, RealNN, Text
    from transmogrifai_tpu_torch.workflow import Workflow
    x, y = _data(0, False)
    words = [("red fox", "blue jay")[int(v)] for v in y]
    label = FeatureBuilder.RealNN("y").as_response()
    feats = [FeatureBuilder.Real("x").as_predictor(),
             FeatureBuilder.Text("t").as_predictor()]
    sel = BinaryClassificationModelSelector(models=[ModelCandidate(
        OpLogisticRegression(), grid(reg_param=[0.01]), "LR")])
    sel.set_input(label, transmogrify(feats))
    batch = ColumnBatch({"y": Column(RealNN, y.astype(np.float32)),
                         "x": Column(Real, x.astype(np.float32),
                                     mask=np.ones(len(x), bool)),
                         "t": text_column(Text, words)}, len(x))
    return (Workflow(device="cpu").set_input_batch(batch)
            .set_result_features(sel.get_output()).train())


# a fresh process: what its warm-up and its traffic load is counted; then a
# helper is dropped from the loader's table, as if never loaded, and the
# next request's first load is counted online
_COUNT_BUILDS = """
import json, sys
from transmogrifai_tpu_torch import compiled, cuda_build, native
from transmogrifai_tpu_torch.serving import ScoringEngine
before = compiled.build_count()
eng = ScoringEngine(sys.argv[1], max_batch=4, device="cpu")
warm = eng.stats()["counters"]["warmup_builds_total"]
eng.score_record({"x": 0.5, "t": "red fox"}, timeout_s=60)
online = eng.stats()["counters"]["online_builds_total"]
cuda_build._libs.clear()
native._mods.clear()
eng.score_record({"x": 1.5, "t": "blue jay"}, timeout_s=60)
again = eng.stats()["counters"]["online_builds_total"]
active = eng.stats()["compiled_path_active"]
eng.close()
print(json.dumps([before, warm, online, again, active]))
"""


def test_library_loads_are_counted_in_warm_up_and_online(shared_root):
    """In a fresh process the warm-up's first load of the text helper is
    ``warmup_builds_total`` and the first requests load nothing; a helper
    loaded anew while traffic flows is ``online_builds_total``, without
    leaving the compiled path."""
    path = os.path.join(shared_root, "serving-port-text")
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(os.path.join(path, "done")):
            shutil.rmtree(path, ignore_errors=True)
            _train_port_text().save(os.path.join(path, "bundle"))
            open(os.path.join(path, "done"), "w").close()
    out = subprocess.run(
        [sys.executable, "-c", _COUNT_BUILDS, os.path.join(path, "bundle")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    before, warm, online, again, active = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert before == 0
    assert warm >= 1
    assert online == 0
    assert again >= 1
    assert active
