"""Resumable selector sweeps in the port against the JAX package, on the
CPU: ``SweepCheckpoint`` signatures equal as strings across the packages
for every family of the three default selectors and the bench set, sweep
directories that resume across the packages in both directions, and the
port's counterparts of ``tests/test_checkpoint.py``'s sweep-bundle,
preemption and resume cases and ``tests/test_racing.py``'s signature
cases, on the bench's dense workflow (400 x 6; ``test_torch_workflow``).
Tolerances: replayed metrics, winners and signatures exact; a resumed
train's refit arrays bit-equal to an uninterrupted train's."""

import importlib
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_workflow import _build, _data  # noqa: E402

JAX, PORT = "transmogrifai_tpu", "transmogrifai_tpu_torch"
FAMILIES = ("lr", "rf", "gbt")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _racing(pkg, validator, G):
    """The racing configuration a family of ``G`` grid points is signed
    with in ``pkg``'s validator."""
    if pkg == JAX:
        on, eta, mins = validator._racing_config()
        raced = on and validator.num_folds >= 2 and \
            max(mins, int(np.ceil(G / eta))) < G
    else:
        on, eta, mins = (validator.racing, validator.racing_eta,
                         validator.racing_min_survivors)
        raced = on and validator.num_folds >= 2 and \
            validator._survivor_count(G) < G
    return ({"enabled": True, "eta": eta, "minSurvivors": mins} if raced
            else {"enabled": False})


def _signatures(pkg, selector):
    cp = _mod(pkg, "checkpoint").SweepCheckpoint
    v = selector.validator
    return [(c.model_name, cp.candidate_signature(
        c.model_name, ci, c.grid, racing=_racing(pkg, v, len(c.grid))))
        for ci, c in enumerate(selector.models)]


def _selector(pkg, which, racing=True):
    S = _mod(pkg, "selector")
    if which == "bench":
        wf, _, pred = _build(pkg, *_data(), FAMILIES,
                             **({"device": "cpu"} if pkg == PORT else {}))
        sel = pred.origin_stage
    else:
        sel = getattr(S, which)()
    sel.validator.racing = racing
    return sel


@pytest.mark.parametrize("racing", [True, False])
@pytest.mark.parametrize("which", [
    "BinaryClassificationModelSelector", "RegressionModelSelector",
    "MultiClassificationModelSelector", "bench"])
def test_candidate_signatures_equal_across_packages(which, racing):
    ref = _signatures(JAX, _selector(JAX, which, racing))
    port = _signatures(PORT, _selector(PORT, which, racing))
    assert port == ref
    assert len({s for _, s in port}) == len(port)


def test_signature_changes_with_grid_index_and_racing():
    cp = _mod(PORT, "checkpoint").SweepCheckpoint
    s1 = cp.candidate_signature("LR", 0, [{"reg": 0.1}])
    s2 = cp.candidate_signature("LR", 0, [{"reg": 0.2}])
    s3 = cp.candidate_signature("LR", 1, [{"reg": 0.1}])
    assert len({s1, s2, s3}) == 3
    assert s1 == cp.candidate_signature("LR", 0, [{"reg": 0.1}])
    g = [{"reg_param": 0.01}, {"reg_param": 0.1}]
    base = cp.candidate_signature(
        "m", 0, g, racing={"enabled": True, "eta": 3.0, "minSurvivors": 2})
    assert base != cp.candidate_signature("m", 0, g,
                                          racing={"enabled": False})
    assert base != cp.candidate_signature(
        "m", 0, g, racing={"enabled": True, "eta": 2.0, "minSurvivors": 2})
    assert base == cp.candidate_signature(
        "m", 0, g, racing={"minSurvivors": 2, "eta": 3.0, "enabled": True})
    # an int grid value signs differently from the same float
    assert cp.candidate_signature("m", 0, [{"max_iter": 50}]) != \
        cp.candidate_signature("m", 0, [{"max_iter": 50.0}])


# -- the sweep bundle ----------------------------------------------------------

def test_bundle_roundtrip_scores_and_fitted_arrays(tmp_path):
    C = _mod(PORT, "checkpoint")
    path = str(tmp_path / "sweep")
    cp = C.SweepCheckpoint(path)
    sig = cp.candidate_signature("LR", 0, [{"reg": 0.1}, {"reg": 0.2}])
    fitted = [[{"coef": torch.arange(4.0), "kind": "binary",
                "n_iter": torch.tensor([3, 4], dtype=torch.int32)},
               {"coef": np.arange(2.0), "kind": "binary", "eta": 0.5}]]
    cp.record_candidate(sig, "LR", 0,
                        [{"params": {"reg": 0.1}, "metricValues": [0.8, 0.9]}],
                        fitted_grid=fitted)
    cp.flush()
    assert C.verify_bundle(path)["kind"] == "selector-sweep"
    assert cp.flushes and cp.flushes[0]["npzBytes"] > 0
    re = C.SweepCheckpoint(path)
    assert sig in re and len(re) == 1
    assert re.results_for(sig)[0]["metricValues"] == [0.8, 0.9]
    fg = re.fitted_grid(sig)
    assert fg[0][0]["kind"] == "binary" and fg[0][1]["eta"] == 0.5
    np.testing.assert_array_equal(fg[0][0]["coef"], np.arange(4.0))
    np.testing.assert_array_equal(fg[0][0]["n_iter"], [3, 4])
    assert fg[0][0]["n_iter"].dtype == np.int32
    np.testing.assert_array_equal(fg[0][1]["coef"], np.arange(2.0))
    # the JAX package reads it under the same keys
    J = _mod(JAX, "checkpoint").SweepCheckpoint(path)
    np.testing.assert_array_equal(J.fitted_grid(sig)[0][0]["coef"],
                                  np.arange(4.0))


def test_host_copies_keep_shapes_and_dtypes():
    C = _mod(PORT, "checkpoint")
    ts = [torch.arange(6.0).reshape(2, 3), torch.tensor([1, 2], dtype=torch.int32),
          torch.tensor(7.0), torch.ones(0), torch.arange(3.0)]
    out = C._host_copies(ts)
    for t, a in zip(ts, out):
        assert a.shape == tuple(t.shape) and a.dtype == t.numpy().dtype
        np.testing.assert_array_equal(a, t.numpy())


def test_winner_persists(tmp_path):
    C = _mod(PORT, "checkpoint")
    cp = C.SweepCheckpoint(str(tmp_path / "sweep"))
    cp.set_winner("RF", {"depth": 3}, 0.91)
    assert C.SweepCheckpoint(str(tmp_path / "sweep")).winner == {
        "modelName": "RF", "params": {"depth": 3}, "metric": 0.91}


# -- the preemption guard ------------------------------------------------------

def test_injected_preemption_sets_the_flag_and_records_it():
    C, R = _mod(PORT, "checkpoint"), _mod(PORT, "resilience")
    log = R.FailureLog()
    with C.preemption_guard("train", log=log) as g:
        with R.inject_faults(R.FaultInjector(
                fail_keys={"preemption": ["candidate-x"]})):
            assert not C.shutdown_requested(key="candidate-y")
            assert C.shutdown_requested(key="candidate-x")
        assert g.stop_requested
        assert C.shutdown_requested(key="candidate-y")   # sticky
    (ev,) = log.by_action("preempted")
    assert ev.stage == "train" and ev.point == "preemption"
    with C.preemption_guard("train") as g2:
        assert not g2.stop_requested


# -- resume ---------------------------------------------------------------------

def _workflow(pkg, racing=False, families=FAMILIES):
    kw = {"device": "cpu"} if pkg == PORT else {}
    wf, _, pred = _build(pkg, *_data(), families, **kw)
    pred.origin_stage.validator.racing = racing
    return wf


def _faults(pkg, **fail_keys):
    R = _mod(pkg, "resilience")
    return R.inject_faults(R.FaultInjector(fail_keys=fail_keys))


def _vr(model):
    return [(r.model_name, r.params, r.metric_values, r.raced_out)
            for r in model.selected_model.summary.validation_results]


def _best(model):
    s = model.selected_model.summary
    return s.best_model_name, s.validation_results and [
        r.params for r in s.validation_results
        if r.model_name == s.best_model_name]


def _resumed(model, stage=None):
    return [e for e in model.failure_log if e.action == "resumed"
            and (stage is None or e.stage == stage)]


@pytest.fixture(scope="module")
def uninterrupted():
    return _workflow(PORT).train()


@pytest.fixture(scope="module")
def preempted_then_resumed(tmp_path_factory):
    """Run 1 is preempted at the forest's boundary; run 2 resumes with the
    LR fit armed; run 3 resumes the sealed sweep with every fit armed."""
    C = _mod(PORT, "checkpoint")
    d = str(tmp_path_factory.mktemp("resume") / "sweep")
    with _faults(PORT, preemption=["OpRandomForestClassifier"]):
        with pytest.raises(C.TrainingPreempted) as ei:
            _workflow(PORT).train(resume_from=d)
    after_1 = len(C.SweepCheckpoint(d))
    with _faults(PORT, **{"selector.candidate_fit": ["OpLogisticRegression"]}):
        m2 = _workflow(PORT).train(resume_from=d)
    with _faults(PORT, **{"selector.candidate_fit": list(
            ("OpLogisticRegression", "OpRandomForestClassifier",
             "OpGBTClassifier"))}):
        m3 = _workflow(PORT).train(resume_from=d)
    return {"dir": d, "exc": ei.value, "after_1": after_1, "m2": m2,
            "m3": m3}


def test_preempt_at_the_forest_checkpoints_exactly_lr(preempted_then_resumed):
    r = preempted_then_resumed
    assert r["exc"].resume_from == os.path.abspath(r["dir"])
    assert r["after_1"] == 1
    log = r["exc"].failure_log
    assert log is not None
    (ev,) = log.by_action("preempted")
    assert ev.point == "preemption"


def test_resume_replays_lr_and_matches_the_uninterrupted_train(
        preempted_then_resumed, uninterrupted):
    m2 = preempted_then_resumed["m2"]
    assert _resumed(m2, "OpLogisticRegression")
    assert _resumed(m2, "train")
    assert not m2.failure_log.by_action("skipped")
    lr = [r for r in m2.selected_model.summary.validation_results
          if r.model_name == "OpLogisticRegression"]
    assert lr and all(math.isfinite(v) for r in lr
                      for v in r.metric_values.values())
    assert _vr(m2) == _vr(uninterrupted)
    assert _best(m2) == _best(uninterrupted)
    C = _mod(PORT, "checkpoint")
    cp = C.SweepCheckpoint(preempted_then_resumed["dir"])
    assert len(cp) == 3 and cp.winner["modelName"] == _best(m2)[0]


def test_resumed_refit_arrays_are_bit_equal(preempted_then_resumed,
                                            uninterrupted):
    for m in (preempted_then_resumed["m2"], preempted_then_resumed["m3"]):
        a = m.selected_model.best_model.fitted
        b = uninterrupted.selected_model.best_model.fitted
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], torch.Tensor):
                assert torch.equal(a[k], b[k]), k
            else:
                assert a[k] == b[k], k


def test_fully_replayed_sweep_refits_only_the_winner(preempted_then_resumed,
                                                     uninterrupted):
    m3 = preempted_then_resumed["m3"]
    assert len(_resumed(m3)) == 4          # the train's and three families'
    assert not m3.failure_log.by_action("skipped")
    assert _vr(m3) == _vr(uninterrupted)
    assert set(m3.selected_model.selector_seconds) == {"refit",
                                                       "train_evaluation"}


def test_train_without_resume_from_is_unchanged(uninterrupted):
    assert not _resumed(uninterrupted)
    assert not uninterrupted.failure_log.by_action("degraded")
    assert set(uninterrupted.selected_model.selector_seconds) >= {
        "OpLogisticRegression", "OpRandomForestClassifier", "OpGBTClassifier"}


def test_the_resumed_model_saves_and_loads(preempted_then_resumed, tmp_path):
    C, W = _mod(PORT, "checkpoint"), _mod(PORT, "workflow")
    m2 = preempted_then_resumed["m2"]
    m2.save(str(tmp_path / "model"))
    assert C.verify_bundle(str(tmp_path / "model")) is not None
    assert W.WorkflowModel.load(str(tmp_path / "model"), device="cpu")


def test_a_failed_flush_degrades_and_is_not_fatal(tmp_path):
    d = str(tmp_path / "sweep")
    with _faults(PORT, **{"checkpoint.save": ["sweep"]}):
        model = _workflow(PORT).train(resume_from=d)
    assert model.selected_model.summary.best_model_name
    degraded = [e for e in model.failure_log
                if e.action == "degraded" and e.point == "checkpoint.save"]
    assert len(degraded) == 4          # three families and the winner
    assert not os.path.exists(d)


# -- across the packages --------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)])
def test_a_sweep_resumes_across_the_packages(writer, reader, tmp_path):
    """The writer runs the whole sweep (racing on: LR x4 raced, RF and GBT
    whole); the reader resumes it with every family's fit armed, so each
    family must be replayed, and gets the writer's validation results and
    winner."""
    d = str(tmp_path / "sweep")
    first = _workflow(writer, racing=True).train(resume_from=d)
    with _faults(reader, **{"selector.candidate_fit": [
            "OpLogisticRegression", "OpRandomForestClassifier",
            "OpGBTClassifier"]}):
        second = _workflow(reader, racing=True).train(resume_from=d)
    assert len([e for e in second.failure_log if e.action == "resumed"
                and e.stage != "train"]) == 3
    assert not [e for e in second.failure_log if e.action == "skipped"]
    assert _vr(second) == _vr(first)
    assert sum(r for *_, r in _vr(second)) == 2
    assert _best(second) == _best(first)


# -- racing and resume (tests/test_racing.py:160-195) ---------------------------

def test_resume_with_changed_racing_refits(tmp_path):
    d = str(tmp_path / "sweep")
    m1 = _workflow(PORT, racing=True, families=("lr",)).train(resume_from=d)
    assert any(r for *_, r in _vr(m1))
    assert len(_mod(PORT, "checkpoint").SweepCheckpoint(d)) == 1
    m2 = _workflow(PORT, racing=False, families=("lr",)).train(resume_from=d)
    assert not _resumed(m2, "OpLogisticRegression")
    assert not any(r for *_, r in _vr(m2))
    m3 = _workflow(PORT, racing=False, families=("lr",)).train(resume_from=d)
    assert _resumed(m3, "OpLogisticRegression")
    assert _vr(m3) == _vr(m2)
