"""The PyTorch port stands alone: importing it (or ``chip_smoke.py``) loads
neither ``jax`` nor anything of the JAX package ``transmogrifai_tpu``."""

import ast
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "transmogrifai_tpu_torch")


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PORT):
        for fn in files:
            if fn.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, fn), ROOT)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")] if mod.endswith(".__init__")
                            else mod)
    return sorted(mods)


def test_import_leaves_jax_and_the_jax_package_out():
    code = ("import importlib, json, sys\n"
            f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'jaxlib' or m.startswith('jaxlib.') "
            "or m == 'transmogrifai_tpu' or m.startswith('transmogrifai_tpu.'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_native_helpers_and_the_transmog_path_leave_jax_out():
    """Building and loading the port's native helpers, profiling text and
    maps and hashing on the CPU load no JAX."""
    code = ("import json, sys\n"
            "import numpy as np, torch\n"
            "from transmogrifai_tpu_torch import native\n"
            "for n in native.NATIVE_SOURCES: native.load(n)\n"
            "from transmogrifai_tpu_torch.synthetic import "
            "make_transmog_columns\n"
            "from transmogrifai_tpu_torch.ops.text_profile import "
            "column_profile\n"
            "from transmogrifai_tpu_torch.ops.map_profile import "
            "map_expansion\n"
            "from transmogrifai_tpu_torch.ops.text_kernels import "
            "hash_counts\n"
            "cols, _ = make_transmog_columns(50)\n"
            "p = column_profile(cols['text1'])\n"
            "hash_counts(*p.device_ids(512, torch.device('cpu')), None, 512)\n"
            "map_expansion(cols['rmap'])\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'jaxlib' or m.startswith('jaxlib.') "
            "or m == 'transmogrifai_tpu' or m.startswith('transmogrifai_tpu.'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_sparse_path_leaves_jax_out():
    """Training and scoring the sparse hashed-text workflow on the CPU (its
    vectorizer, SparseMatrix, product twins and sparse FISTA) loads no JAX."""
    code = ("import json, sys\n"
            "sys.path.insert(0, 'scripts')\n"
            "import sparse_reference as sr\n"
            "wf, b, pred = sr.build('transmogrifai_tpu_torch', 200, "
            "num_hashes=4096, device='cpu')\n"
            "m = wf.train()\n"
            "assert type(sr.feature_matrix('transmogrifai_tpu_torch', m, b))"
            ".__name__ == 'SparseMatrix'\n"
            "m.score(b)\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'jaxlib' or m.startswith('jaxlib.') "
            "or m == 'transmogrifai_tpu' or m.startswith('transmogrifai_tpu.'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", [os.path.join(ROOT, "chip_smoke.py")] + sorted(
    os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
    if f.endswith(".py")))
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "transmogrifai_tpu"), (
                f"{os.path.relpath(path, ROOT)} imports {n}")


def test_the_insights_path_leaves_jax_out():
    """Explaining a model on the CPU (RecordInsightsLOCO through the twin
    and the native payload formatter, RecordInsightsCorr, the summary)
    loads no JAX."""
    code = ("import json, sys\n"
            "import numpy as np, torch\n"
            "from transmogrifai_tpu_torch.columns import Column, ColumnBatch\n"
            "from transmogrifai_tpu_torch.features import Feature\n"
            "from transmogrifai_tpu_torch.models.linear import "
            "LinearPredictionModel\n"
            "from transmogrifai_tpu_torch.record_insights import "
            "RecordInsightsLOCO, RecordInsightsCorr\n"
            "from transmogrifai_tpu_torch.types import OPVector\n"
            "import transmogrifai_tpu_torch.insights\n"
            "X = torch.randn(50, 4)\n"
            "m = LinearPredictionModel(fitted={'coef': torch.ones(4), "
            "'intercept': torch.zeros(1), 'kind': 'binary'})\n"
            "v = Feature('v', OPVector, False, None, parents=())\n"
            "p = Feature('p', OPVector, False, None, parents=())\n"
            "b = ColumnBatch({'v': Column(OPVector, X), 'p': Column(OPVector, "
            "torch.sigmoid(X[:, :1]))}, 50, device='cpu')\n"
            "loco = RecordInsightsLOCO(model=m, top_k=2); loco.set_input(v)\n"
            "assert len(loco.transform(b).values[0]) == 2\n"
            "c = RecordInsightsCorr(top_k=2); c.set_input(p, v)\n"
            "c.fit(b).transform(b)\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'jaxlib' or m.startswith('jaxlib.') "
            "or m == 'transmogrifai_tpu' or m.startswith('transmogrifai_tpu.'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_multiclass_path_leaves_jax_out():
    """Training, evaluating and scoring the multiclass workflow on the CPU
    (softmax FISTA, the confusion panels, DataCutter, naive Bayes and the
    MLP) loads no JAX."""
    code = ("import json, sys\n"
            "sys.path.insert(0, 'scripts')\n"
            "import multiclass_grid_reference as mgr\n"
            "from transmogrifai_tpu_torch.evaluators import Evaluators\n"
            "from transmogrifai_tpu_torch.models.linear import (OpNaiveBayes, "
            "OpMultilayerPerceptronClassifier)\n"
            "from transmogrifai_tpu_torch.selector import ModelCandidate\n"
            "from transmogrifai_tpu_torch.synthetic import "
            "make_multiclass_data\n"
            "X, y = make_multiclass_data(300)\n"
            "models = mgr.grid_models('transmogrifai_tpu_torch', 'compact') + "
            "[ModelCandidate(OpNaiveBayes(), [{}], 'OpNaiveBayes'), "
            "ModelCandidate(OpMultilayerPerceptronClassifier(max_iter=5), "
            "[{}], 'OpMultilayerPerceptronClassifier')]\n"
            "m, b, _ = mgr.train('transmogrifai_tpu_torch', X, y, models, "
            "device='cpu')\n"
            "m.evaluate(Evaluators.MultiClassification.f1(), batch=b)\n"
            "m.score(b)\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'jaxlib' or m.startswith('jaxlib.') "
            "or m == 'transmogrifai_tpu' or m.startswith('transmogrifai_tpu.'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_glm_and_softmax_loco_paths_leave_jax_out():
    """Training, scoring and explaining the GLM workflow on the CPU
    (backtracking FISTA on ``fista_glm``'s twin, the exp link of
    ``loco_linear``) and explaining multinomial, naive Bayes and MLP models
    through ``loco_softmax``'s twin, with ``scripts/glm_grid_reference.py``
    and ``chip_smoke``'s phase helpers imported, loads no JAX."""
    code = ("import json, sys\n"
            "sys.path.insert(0, 'scripts')\n"
            "import numpy as np, torch\n"
            "import glm_grid_reference as ggr\n"
            "import chip_smoke\n"
            "from transmogrifai_tpu_torch import insights_kernels as ik\n"
            "from transmogrifai_tpu_torch.models.linear import (OpNaiveBayes, "
            "OpMultilayerPerceptronClassifier, OpLogisticRegression)\n"
            "from transmogrifai_tpu_torch.synthetic import "
            "make_multiclass_data\n"
            "X, y = ggr.make_glm_data(300, 'poisson')\n"
            "m, b, pred, _ = ggr.train('transmogrifai_tpu_torch', X, y, "
            "'poisson', device='cpu')\n"
            "m.score(b)\n"
            "cg = torch.arange(16, dtype=torch.int32)\n"
            "ik.model_loco(m.selected_model, torch.as_tensor(X), cg, 16, 4, "
            "'abs')\n"
            "Xm, ym = make_multiclass_data(200)\n"
            "for est in (OpLogisticRegression(max_iter=5), OpNaiveBayes(), "
            "OpMultilayerPerceptronClassifier(max_iter=5)):\n"
            "    mm = est.model_cls(fitted=est.fit_arrays(Xm, ym, "
            "device='cpu'))\n"
            "    ik.model_loco(mm, torch.as_tensor(Xm), cg, 16, 4, 'abs')\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'jaxlib' or m.startswith('jaxlib.') "
            "or m == 'transmogrifai_tpu' or m.startswith('transmogrifai_tpu.'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


NEW_MODULES = ("checkpoint", "compiled", "local", "stages.serialization")


@pytest.mark.parametrize("name", NEW_MODULES)
def test_save_load_and_scoring_modules_are_scanned(name):
    path = os.path.join(PORT, *name.split(".")) + ".py"
    assert f"transmogrifai_tpu_torch.{name}" in _port_modules()
    test_no_source_imports_jax_or_the_jax_package(path)


def test_save_load_and_local_scoring_leave_jax_out(tmp_path):
    """Training on the CPU, saving, loading (a checkpoint root), scoring
    through ``ScoreProgram`` and one record through
    ``local.score_function`` load no JAX."""
    code = ("import json, sys\n"
            "sys.path.insert(0, 'tests')\n"
            "import numpy as np\n"
            "from transmogrifai_tpu_torch import checkpoint, compiled, "
            "local\n"
            "from transmogrifai_tpu_torch.stages import serialization\n"
            "from transmogrifai_tpu_torch.columns import Column, ColumnBatch\n"
            "from transmogrifai_tpu_torch.features import FeatureBuilder\n"
            "from transmogrifai_tpu_torch.models.trees import "
            "OpGBTClassifier\n"
            "from transmogrifai_tpu_torch.ops.transmogrify import "
            "transmogrify\n"
            "from transmogrifai_tpu_torch.selector import ("
            "BinaryClassificationModelSelector, ModelCandidate, grid)\n"
            "from transmogrifai_tpu_torch.types import RealNN\n"
            "from transmogrifai_tpu_torch.workflow import Workflow, "
            "WorkflowModel\n"
            "rng = np.random.default_rng(0)\n"
            "X = rng.normal(size=(200, 3)).astype(np.float32)\n"
            "y = (X[:, 0] > 0).astype(np.float32)\n"
            "label = FeatureBuilder.RealNN('y').as_response()\n"
            "fs = [FeatureBuilder.RealNN(f'x{i}').as_predictor() "
            "for i in range(3)]\n"
            "sel = BinaryClassificationModelSelector(models=[ModelCandidate("
            "OpGBTClassifier(), grid(max_iter=[2], max_depth=[2]), 'gbt')])\n"
            "sel.set_input(label, transmogrify(fs))\n"
            "cols = {'y': Column(RealNN, y), **{f'x{i}': Column(RealNN, "
            "X[:, i]) for i in range(3)}}\n"
            "b = ColumnBatch(cols, 200)\n"
            "m = Workflow(device='cpu').set_input_batch(b)"
            ".set_result_features(sel.get_output()).train()\n"
            f"root = {str(tmp_path / 'ckpts')!r}\n"
            "m.save(checkpoint.next_version_dir(root))\n"
            "r = WorkflowModel.load(root, device='cpu')\n"
            "r.score(b)\n"
            "local.score_function(r)({'x0': 1.0, 'x1': 0.0, 'x2': 0.5})\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'jaxlib' or m.startswith('jaxlib.') "
            "or m == 'transmogrifai_tpu' or m.startswith('transmogrifai_tpu.'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


SERVING_MODULES = ("serving", "serving.engine", "serving.server",
                   "serving.wire", "serving.overload", "quality",
                   "telemetry", "resilience")


@pytest.mark.parametrize("name", SERVING_MODULES)
def test_serving_quality_and_telemetry_modules_are_scanned(name):
    path = os.path.join(PORT, *name.split("."))
    path = (os.path.join(path, "__init__.py") if os.path.isdir(path)
            else path + ".py")
    assert f"transmogrifai_tpu_torch.{name}" in _port_modules()
    test_no_source_imports_jax_or_the_jax_package(path)


def test_serving_leaves_jax_out(tmp_path):
    """Training on the CPU, saving under a checkpoint root, serving it over
    HTTP (a JSON record, a columnar body, a record the contract rejects)
    and draining load no JAX."""
    code = ("import json, sys, urllib.request, urllib.error\n"
            "sys.path.insert(0, 'tests')\n"
            "from test_torch_serving import _train_port\n"
            "from transmogrifai_tpu_torch.checkpoint import "
            "next_version_dir\n"
            "from transmogrifai_tpu_torch.serving import start_server, wire\n"
            f"root = {str(tmp_path / 'ckpts')!r}\n"
            "_train_port(0, False).save(next_version_dir(root))\n"
            "srv, th = start_server(root, port=0, max_batch=4, "
            "device='cpu')\n"
            "url = f'http://127.0.0.1:{srv.port}/v1/score'\n"
            "def post(body, ctype):\n"
            "    req = urllib.request.Request(url, data=body, "
            "headers={'Content-Type': ctype})\n"
            "    try:\n"
            "        return urllib.request.urlopen(req).status\n"
            "    except urllib.error.HTTPError as e:\n"
            "        return e.code\n"
            "codes = [post(b'{\"x\": 1.0}', 'application/json'), "
            "post(wire.encode_records([{'x': 2.0}]), wire.CONTENT_TYPE), "
            "post(b'{\"x\": \"abc\"}', 'application/json')]\n"
            "assert codes == [200, 200, 422], codes\n"
            "srv.drain_and_close()\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'jaxlib' or m.startswith('jaxlib.') "
            "or m == 'transmogrifai_tpu' or m.startswith('transmogrifai_tpu.'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


TRAINING_MODULES = ("sanitizer", "dag", "tuning", "selector", "workflow",
                    "stages.base")


@pytest.mark.parametrize("name", TRAINING_MODULES)
def test_training_control_modules_are_scanned(name):
    path = os.path.join(PORT, *name.split(".")) + ".py"
    assert f"transmogrifai_tpu_torch.{name}" in _port_modules()
    test_no_source_imports_jax_or_the_jax_package(path)


def test_training_control_leaves_jax_out():
    """``chip_smoke``'s phase-16 resume check (an uninterrupted train, one
    preempted at the forest, a resume and a sealed resume from its sweep
    checkpoint), then a workflow-CV train under the NaN guard, on the CPU
    at 600 rows, load no JAX."""
    code = ("import json, sys\n"
            "import chip_smoke as cs\n"
            "X, y = cs.make_data(600)\n"
            "cs.run_resume(X, y, 'cpu')\n"
            "wf, b = cs.build_workflow(X, y, 'cpu')\n"
            "wf.with_workflow_cv().with_sanitizers(nan_check=True).train()\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'jaxlib' or m.startswith('jaxlib.') "
            "or m == 'transmogrifai_tpu' or m.startswith('transmogrifai_tpu.'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
