"""Model bundles moving both ways between the JAX package and the port, on
the CPU.

Each case trains one workflow in one package, saves its bundle
(``op-model.json``, ``params.npz``, ``MANIFEST.json``) and scores a fresh
batch in memory; the other package (or the port again) loads the bundle and
scores the same batch.  The cases: the dense binary workflow with LR, RF
and GBT winners forced in turn through ``models=``, a transmog workflow, a
sparse-text workflow, the regression selector with linear, forest and GBT
winners and the multiclass selector with softmax LR, forest, naive Bayes
and MLP winners.  A bundle trained by one package is trained once a test
session and shared by the xdist workers (a lock file beside it).

Tolerances: JAX → port and port → JAX, ``prediction`` equal for the
classifiers and ``probability`` within 1e-6 absolute.  ``rawPrediction``
and a regressor's ``prediction`` are held to 1e-6 absolute or ULPS = 16
f32 ulps of the value, whichever is larger: from 16 up, one ulp exceeds
1e-6.  The tree walk's sum reassociated by XLA is 1 ulp off a
sequential one; a linear margin is an f32 dot product summed in another
order, 2 ulps off on the multiclass LR and naive Bayes winners and 16 on
the Boston linear regressor, whose prediction cancels larger terms.  Port
→ port the same bits.  A GLM
winner raises ``KeyError`` on load in both packages (the JAX package's
``MODEL_REGISTRY`` has no ``GLMPredictionModel``).  The error paths mirror
``tests/test_checkpoint.py::TestAtomicSave`` and ``::TestLoadVerification``
on a port-saved bundle.
"""

import fcntl
import json
import os
import shutil
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import importlib  # noqa: E402

import multiclass_grid_reference as mgr  # noqa: E402
import sparse_reference as sr  # noqa: E402
import test_torch_workflow as tw  # noqa: E402
import transmog_reference as tr  # noqa: E402
from transmogrifai_tpu_torch.checkpoint import (  # noqa: E402
    BUNDLE_FORMAT_VERSION, MANIFEST_NAME, CorruptModelError,
    ModelVersionError, atomic_bundle_write, bundle_version,
    find_latest_valid, next_version_dir, prune_versions, verify_bundle,
    write_json_atomic)
from transmogrifai_tpu_torch.workflow import \
    WorkflowModel as PortModel  # noqa: E402

JAX, PORT = "transmogrifai_tpu", "transmogrifai_tpu_torch"
BOSTON = os.path.join(ROOT, "data", "boston", "housingData.csv")
BOSTON_HEADERS = ["rowId", "crim", "zn", "indus", "chas", "nox", "rm", "age",
                  "dis", "rad", "tax", "ptratio", "b", "lstat", "medv"]
TRANSMOG_ROWS, SPARSE_ROWS, SPARSE_HASHES = 300, 300, 4096
TOL = 1e-6
ULPS = 16


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _kw(pkg):
    return {"device": "cpu"} if pkg == PORT else {}


# --------------------------------------------------------------------------
# the cases: (train in pkg → (model, prediction name), fresh batch in pkg)
# --------------------------------------------------------------------------

def _dense(families):
    def train(pkg):
        X, y = tw._data(0)
        wf, _, pred = tw._build(pkg, X, y, families, **_kw(pkg))
        return wf.train()

    def fresh(pkg, model):
        X, y = tw._data(5)
        C, TY = _mod(pkg, "columns"), _mod(pkg, "types")
        cols = {"label": C.Column(TY.RealNN, y)}
        for i in range(X.shape[1]):
            cols[f"f{i}"] = C.Column(TY.RealNN, X[:, i])
        return C.ColumnBatch(cols, len(y))
    return train, fresh


def _transmog():
    def train(pkg):
        cols, schema = tr.columns(pkg, TRANSMOG_ROWS)
        wf, _, _ = tr.build(pkg, cols, schema, TRANSMOG_ROWS, **_kw(pkg))
        return wf.train()

    def fresh(pkg, model):
        cols, _ = tr.columns(pkg, TRANSMOG_ROWS, seed=7)
        return _mod(pkg, "columns").ColumnBatch(cols, TRANSMOG_ROWS)
    return train, fresh


def _sparse():
    def train(pkg):
        wf, _, _ = sr.build(pkg, SPARSE_ROWS, num_hashes=SPARSE_HASHES,
                            **_kw(pkg))
        return wf.train()

    def fresh(pkg, model):
        return sr.raw_batch(pkg, model.raw_features, SPARSE_ROWS, seed=7)
    return train, fresh


def boston_batch(pkg, seed=None):
    """Boston housing typed as ``tests/test_torch_regression.py`` types it;
    with a ``seed``, the reals jittered by 5% and 5% of them null."""
    C, TY = _mod(pkg, "columns"), _mod(pkg, "types")
    raw = np.loadtxt(BOSTON, delimiter=",")
    rng = None if seed is None else np.random.default_rng(seed)
    cols = {}
    for j, h in enumerate(BOSTON_HEADERS):
        v = raw[:, j]
        if h == "rowId":
            continue
        if h == "medv":
            cols[h] = C.Column(TY.RealNN, v.astype(np.float32))
        elif h == "chas":
            cols[h] = C.text_column(TY.PickList, [str(int(x)) for x in v])
        elif h == "rad":
            cols[h] = C.Column(TY.Integral, v.astype(np.int64),
                               mask=np.ones(len(v), bool))
        else:
            mask = np.ones(len(v), bool)
            if rng is not None:
                v = v * (1 + 0.05 * rng.normal(size=len(v)))
                mask = rng.random(len(v)) > 0.05
            cols[h] = C.Column(TY.Real, v.astype(np.float32), mask=mask)
    return C.ColumnBatch(cols, len(raw))


def _regression(candidate):
    def train(pkg):
        F, S = _mod(pkg, "features"), _mod(pkg, "selector")
        lin, trees = _mod(pkg, "models.linear"), _mod(pkg, "models.trees")
        cand = {"lin": lambda: S.ModelCandidate(
                    lin.OpLinearRegression(), S.grid(reg_param=[0.01]),
                    "OpLinearRegression"),
                "rf": lambda: S.ModelCandidate(
                    trees.OpRandomForestRegressor(),
                    S.grid(num_trees=[5], max_depth=[4]),
                    "OpRandomForestRegressor"),
                "gbt": lambda: S.ModelCandidate(
                    trees.OpGBTRegressor(), S.grid(max_iter=[5]),
                    "OpGBTRegressor"),
                "glm": lambda: S.ModelCandidate(
                    lin.OpGeneralizedLinearRegression(family="poisson"),
                    S.grid(reg_param=[0.01]),
                    "OpGeneralizedLinearRegression")}[candidate]()
        batch = boston_batch(pkg)
        schema = {n: c.kind for n, c in batch.items()}
        medv, predictors = F.features_from_schema(schema, response="medv")
        fv = _mod(pkg, "ops.transmogrify").transmogrify(predictors)
        sel = S.RegressionModelSelector(models=[cand])
        sel.set_input(medv, fv)
        wf = _mod(pkg, "workflow").Workflow(**_kw(pkg)).set_input_batch(batch)
        return wf.set_result_features(sel.get_output()).train()

    def fresh(pkg, model):
        return boston_batch(pkg, seed=3)
    return train, fresh


def iris_batch(pkg, seed=None):
    X, y = mgr.iris()
    if seed is not None:
        X = X + np.float32(0.2) * np.random.default_rng(seed).normal(
            size=X.shape).astype(np.float32)
    C, TY = _mod(pkg, "columns"), _mod(pkg, "types")
    cols = {"label": C.Column(TY.RealNN, y)}
    for i in range(X.shape[1]):
        cols[f"f{i}"] = C.Column(TY.RealNN, X[:, i])
    return C.ColumnBatch(cols, len(y))


def _multiclass(candidate):
    def train(pkg):
        S, lin = _mod(pkg, "selector"), _mod(pkg, "models.linear")
        trees = _mod(pkg, "models.trees")
        cand = {"lr": lambda: S.ModelCandidate(
                    lin.OpLogisticRegression(), S.grid(reg_param=[0.01]),
                    "OpLogisticRegression"),
                "rf": lambda: S.ModelCandidate(
                    trees.OpRandomForestClassifier(),
                    S.grid(num_trees=[5], max_depth=[4]),
                    "OpRandomForestClassifier"),
                "nb": lambda: S.ModelCandidate(lin.OpNaiveBayes(), [{}],
                                               "OpNaiveBayes"),
                "mlp": lambda: S.ModelCandidate(
                    lin.OpMultilayerPerceptronClassifier(),
                    S.grid(hidden_layers=[(5,)], max_iter=[20]),
                    "OpMultilayerPerceptronClassifier")}[candidate]()
        X, y = mgr.iris()
        return mgr.train(pkg, X, y, [cand], **_kw(pkg))[0]

    def fresh(pkg, model):
        return iris_batch(pkg, seed=4)
    return train, fresh


CASES = {"dense_lr": _dense(("lr",)), "dense_rf": _dense(("rf",)),
         "dense_gbt": _dense(("gbt",)), "transmog": _transmog(),
         "sparse": _sparse(), "regression_lin": _regression("lin"),
         "regression_rf": _regression("rf"),
         "regression_gbt": _regression("gbt"),
         "multiclass_lr": _multiclass("lr"), "multiclass_rf": _multiclass("rf"),
         "multiclass_nb": _multiclass("nb"),
         "multiclass_mlp": _multiclass("mlp")}
WINNERS = {"dense_lr": "LinearPredictionModel",
           "dense_rf": "TreeEnsembleModel", "dense_gbt": "TreeEnsembleModel",
           "transmog": "LinearPredictionModel",
           "sparse": "LinearPredictionModel",
           "regression_lin": "LinearPredictionModel",
           "regression_rf": "TreeEnsembleModel",
           "regression_gbt": "TreeEnsembleModel",
           "multiclass_lr": "LinearPredictionModel",
           "multiclass_rf": "TreeEnsembleModel",
           "multiclass_nb": "NaiveBayesModel",
           "multiclass_mlp": "MLPClassificationModel"}


def prediction_values(model, scored):
    """The host arrays of the model's Prediction column in ``scored``."""
    (name,) = [f.name for f in model.result_features]
    return {k: _np(v) for k, v in scored[name].values.items()}


def score(model, pkg, case):
    return prediction_values(model, model.score(
        batch=CASES[case][1](pkg, model)))


# --------------------------------------------------------------------------
# bundles shared by the session's workers
# --------------------------------------------------------------------------

@pytest.fixture(scope="session")
def bundle_root(tmp_path_factory):
    """A directory all the session's xdist workers share (the parent of
    each worker's own base temp)."""
    base = tmp_path_factory.getbasetemp()
    return str(base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base)


def trained_bundle(root, case, pkg, aot=False):
    """(bundle path, the trainer's in-memory scores of the fresh batch) of
    ``case`` trained by ``pkg``: trained once a session, under a lock."""
    tag = f"bundle-{case}-{pkg}" + ("-aot" if aot else "")
    path = os.path.join(root, tag)
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(os.path.join(path, "scores.npz")):
            shutil.rmtree(path, ignore_errors=True)
            os.makedirs(path)
            model = CASES[case][0](pkg)
            save = {"aot": aot} if pkg == JAX else {}
            model.save(os.path.join(path, "bundle"), **save)
            np.savez(os.path.join(path, "scores.npz"),
                     **score(model, pkg, case))
    with np.load(os.path.join(path, "scores.npz")) as z:
        return os.path.join(path, "bundle"), dict(z)


def assert_scores_close(got, want, regression=False):
    """A classifier's ``prediction`` equal, ``probability`` within TOL
    absolute, margins and a regressor's ``prediction`` within TOL or ULPS
    f32 ulps of the value, whichever is larger."""
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "prediction" and not regression:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        elif k == "probability":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL,
                                       err_msg=k)
        else:
            w = np.asarray(want[k], np.float32)
            gap = np.abs(np.asarray(got[k], np.float64) - w)
            bound = np.maximum(TOL, ULPS * np.spacing(np.abs(w)))
            assert (gap <= bound).all(), (
                f"{k}: {int((gap > bound).sum())} values past "
                f"max({TOL}, {ULPS} ulps); largest gap {gap.max()}")


def assert_scores_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _regression_case(case):
    return case.startswith("regression")


# --------------------------------------------------------------------------
# both ways
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_jax_bundle_scores_the_same_in_the_port(bundle_root, case):
    path, want = trained_bundle(bundle_root, case, JAX)
    model = PortModel.load(path, device="cpu")
    assert type(model.selected_model.best_model).__name__ == WINNERS[case]
    assert_scores_close(score(model, PORT, case), want,
                        _regression_case(case))


@pytest.mark.parametrize("case", list(CASES))
def test_port_bundle_scores_the_same_in_jax(bundle_root, case):
    from transmogrifai_tpu.workflow import WorkflowModel as JaxModel
    path, want = trained_bundle(bundle_root, case, PORT)
    model = JaxModel.load(path)
    assert_scores_close(score(model, JAX, case), want,
                        _regression_case(case))


@pytest.mark.parametrize("case", list(CASES))
def test_port_bundle_reloads_bit_for_bit(bundle_root, case):
    path, want = trained_bundle(bundle_root, case, PORT)
    model = PortModel.load(path, device="cpu")
    assert type(model.selected_model.best_model).__name__ == WINNERS[case]
    assert_scores_equal(score(model, PORT, case), want)


def test_jax_bundle_with_aot_executables_loads_in_the_port(bundle_root):
    """The JAX package's default save ships AOT executables: the port checks
    their digests, does not read them, and records that."""
    path, want = trained_bundle(bundle_root, "dense_lr", JAX, aot=True)
    manifest = verify_bundle(path)
    assert "aot" in manifest and any(n.startswith("aot-")
                                     for n in manifest["files"])
    model = PortModel.load(path, device="cpu")
    assert_scores_close(score(model, PORT, "dense_lr"), want)
    (ev,) = model.failure_log.by_action("degraded")
    assert "aot-" in ev.cause and ev.point == "checkpoint.load"


def test_reloaded_fitted_state_has_the_trained_dtypes_and_device(
        bundle_root):
    path, _ = trained_bundle(bundle_root, "dense_gbt", PORT)
    model = PortModel.load(path, device="cpu")
    f = model.selected_model.best_model.fitted
    want = {"feature": torch.int32, "threshold": torch.float32,
            "is_leaf": torch.bool, "leaf": torch.float32,
            "feature_gain": torch.float32}
    for k, dtype in want.items():
        assert isinstance(f[k], torch.Tensor) and f[k].dtype == dtype, k
        assert f[k].device.type == "cpu"
    with np.load(os.path.join(path, "params.npz")) as z:
        prefix = next(k for k in z.files if k.endswith("/best/feature"))
        assert z[prefix].dtype == np.int32


def test_load_defaults_to_cuda_and_never_falls_back(bundle_root):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device loads")
    path, _ = trained_bundle(bundle_root, "dense_lr", PORT)
    with pytest.raises(RuntimeError, match="CUDA"):
        PortModel.load(path)


# --------------------------------------------------------------------------
# a GLM winner loads in neither package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("trainer", [JAX, PORT])
def test_glm_winner_bundle_raises_in_both_packages(trainer, tmp_path):
    from transmogrifai_tpu.workflow import WorkflowModel as JaxModel
    model = CASES_GLM[0](trainer)
    path = str(tmp_path / "glm")
    model.save(path, **({"aot": False} if trainer == JAX else {}))
    with open(os.path.join(path, "op-model.json")) as fh:
        sel = next(s for s in json.load(fh)["stages"]
                   if s["className"] == "SelectedModel")
    assert sel["extra"]["bestModelClass"] == "GLMPredictionModel"
    with pytest.raises(KeyError, match="GLMPredictionModel"):
        JaxModel.load(path)
    with pytest.raises(KeyError, match="GLMPredictionModel"):
        PortModel.load(path, device="cpu")


CASES_GLM = _regression("glm")


# --------------------------------------------------------------------------
# error paths (≙ tests/test_checkpoint.py::TestAtomicSave and
# ::TestLoadVerification) on a port-saved bundle
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_model(bundle_root):
    path, want = trained_bundle(bundle_root, "dense_lr", PORT)
    return PortModel.load(path, device="cpu"), want


def _corrupt_digest(p):
    with open(p / "params.npz", "r+b") as fh:
        fh.seek(0)
        fh.write(b"\x00corrupted\x00")
    return CorruptModelError, "params.npz"


def _skew_version(p):
    m = json.loads((p / MANIFEST_NAME).read_text())
    m["formatVersion"] = BUNDLE_FORMAT_VERSION + 99
    (p / MANIFEST_NAME).write_text(json.dumps(m))
    return ModelVersionError, "format version"


def _drop(name):
    def go(p):
        os.remove(p / name)
        return CorruptModelError, name
    return go


@pytest.mark.parametrize("damage", [_corrupt_digest, _skew_version,
                                    _drop("op-model.json"),
                                    _drop("params.npz")],
                         ids=["digest", "version", "model_json", "params"])
def test_load_names_what_is_wrong(port_model, tmp_path, damage):
    model, _ = port_model
    p = tmp_path / "m"
    model.save(str(p))
    err, what = damage(p)
    with pytest.raises(err, match=what.replace(".", r"\.")) as ei:
        PortModel.load(str(p), device="cpu")
    if err is CorruptModelError:
        assert ei.value.file == what
        if damage is _corrupt_digest:
            assert "mismatch" in ei.value.reason


def test_manifest_digests_every_file(port_model, tmp_path):
    model, _ = port_model
    model.save(str(tmp_path / "m"))
    m = json.loads((tmp_path / "m" / MANIFEST_NAME).read_text())
    assert m["formatVersion"] == BUNDLE_FORMAT_VERSION
    assert m["kind"] == "workflow-model"
    assert set(m["files"]) == {"op-model.json", "params.npz", "schema.json"}
    for info in m["files"].values():
        assert len(info["sha256"]) == 64 and info["bytes"] > 0


def test_overwrite_false_raises_on_a_nonempty_path(port_model, tmp_path):
    model, _ = port_model
    target = tmp_path / "m"
    model.save(str(target))
    with pytest.raises(FileExistsError, match="overwrite"):
        model.save(str(target), overwrite=False)
    model.save(str(target), overwrite=True)
    assert verify_bundle(str(target)) is not None
    model.save(str(tmp_path / "fresh"), overwrite=False)
    assert verify_bundle(str(tmp_path / "fresh")) is not None


def test_no_temp_directory_is_left_behind(port_model, tmp_path):
    model, _ = port_model
    model.save(str(tmp_path / "m"))
    model.save(str(tmp_path / "m"))
    assert os.listdir(tmp_path) == ["m"]
    with pytest.raises(RuntimeError, match="mid-write"):
        with atomic_bundle_write(str(tmp_path / "b")) as tmp:
            with open(os.path.join(tmp, "half"), "w") as fh:
                fh.write("partial")
            raise RuntimeError("mid-write")
    assert os.listdir(tmp_path) == ["m"]


def test_checkpoint_root_falls_back_to_its_newest_valid_bundle(port_model,
                                                               tmp_path):
    model, want = port_model
    root = tmp_path / "ckpts"
    v1 = next_version_dir(str(root))
    model.save(v1)
    time.sleep(0.05)
    v2 = next_version_dir(str(root))
    assert v2.endswith("ckpt-000002")
    model.save(v2)
    with open(os.path.join(v2, "params.npz"), "r+b") as fh:
        fh.write(b"\xff\xff\xff\xff")
    loaded = PortModel.load(str(root), device="cpu")
    (skip,) = loaded.failure_log.by_action("skipped")
    assert "ckpt-000002" in skip.detail["bundle"]
    assert skip.point == "checkpoint.load"
    assert_scores_equal(score(loaded, PORT, "dense_lr"), want)
    os.remove(os.path.join(v1, "op-model.json"))
    with pytest.raises(CorruptModelError, match="no valid checkpoint"):
        PortModel.load(str(root), device="cpu")


def test_prune_keeps_the_newest(port_model, tmp_path):
    model, _ = port_model
    root = str(tmp_path / "ckpts")
    paths = []
    for _ in range(3):
        paths.append(next_version_dir(root))
        model.save(paths[-1])
        time.sleep(0.05)
    assert prune_versions(root, keep=2) == [paths[0]]
    assert find_latest_valid(root) == paths[2]


def test_legacy_bundle_without_manifest_loads_with_a_warning(port_model,
                                                             tmp_path):
    model, want = port_model
    p = tmp_path / "m"
    model.save(str(p))
    os.remove(p / MANIFEST_NAME)
    with pytest.warns(UserWarning, match="MANIFEST"):
        loaded = PortModel.load(str(p), device="cpu")
    (ev,) = loaded.failure_log.by_action("degraded")
    assert ev.point == "checkpoint.load"
    assert_scores_equal(score(loaded, PORT, "dense_lr"), want)


def test_write_json_atomic_replaces_and_leaves_nothing_else(tmp_path):
    p = str(tmp_path / "state.json")
    write_json_atomic(p, {"nextBatch": 3})
    write_json_atomic(p, {"nextBatch": 7})
    assert json.loads((tmp_path / "state.json").read_text()) == \
        {"nextBatch": 7}
    assert os.listdir(tmp_path) == ["state.json"]


def test_bundle_version_is_the_directory_and_its_creation(port_model,
                                                          tmp_path):
    model, _ = port_model
    path = next_version_dir(str(tmp_path / "ckpts"))
    model.save(path)
    created = json.loads(open(os.path.join(path, MANIFEST_NAME)).read())[
        "createdAt"]
    assert bundle_version(path) == f"ckpt-000001@{int(created)}"
    os.remove(os.path.join(path, MANIFEST_NAME))
    assert bundle_version(path) == "ckpt-000001"


def test_missing_path_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError, match="nope"):
        PortModel.load(str(tmp_path / "nope"), device="cpu")


def test_extract_source_and_window_are_saved_and_rebuilt(bundle_root,
                                                         tmp_path):
    """A raw feature's extract expression comes back as a working extractor
    and its aggregation window as the same number, in the port and in the
    JAX package."""
    from transmogrifai_tpu.workflow import WorkflowModel as JaxModel
    from transmogrifai_tpu_torch import local
    from transmogrifai_tpu_torch.features import FeatureBuilder
    model = PortModel.load(trained_bundle(bundle_root, "dense_lr", PORT)[0],
                           device="cpu")
    gen = next(f for f in model.raw_features if f.name == "f0").origin_stage
    gen.extract_source = "r['x0'] * 2"
    gen.set("aggregate_window_ms", 3_600_000)
    model.save(str(tmp_path / "m"))
    for loaded in (PortModel.load(str(tmp_path / "m"), device="cpu"),
                   JaxModel.load(str(tmp_path / "m"))):
        g = next(f for f in loaded.raw_features
                 if f.name == "f0").origin_stage
        assert g.extract_source == "r['x0'] * 2"
        assert g.extract_fn({"x0": 1.5}) == 3.0
        assert g.get("aggregate_window_ms") == 3_600_000
    feat = FeatureBuilder.Real("y").extract(
        lambda r: r["z"] + 1, source="r['z'] + 1").window(10).as_predictor()
    assert local.extract_raw_value(feat, {"z": 2.0}).value == 3.0
    assert feat.origin_stage.get("aggregate_window_ms") == 10
