"""Model stages (port of ``transmogrifai_tpu/models/__init__.py``).

``MODEL_REGISTRY`` resolves a ``SelectedModel``'s winner by class name on
load: the JAX package's names (its :16-27) for the classes the port has.
Like the JAX package's, it has no ``GLMPredictionModel``, so a bundle whose
winner is a GLM loads in neither package.  It is built on first use: the
kernel modules of this package are imported by ``columns`` (through
``sparse``), which the model modules import in turn.
"""

_REGISTRY_NAMES = {
    "linear": ["LinearPredictionModel", "NaiveBayesModel",
               "MLPClassificationModel", "OpLogisticRegression",
               "OpLinearSVC", "OpLinearRegression", "OpNaiveBayes",
               "OpGeneralizedLinearRegression",
               "OpMultilayerPerceptronClassifier"],
    "trees": ["TreeEnsembleModel", "OpRandomForestClassifier",
              "OpRandomForestRegressor", "OpDecisionTreeClassifier",
              "OpDecisionTreeRegressor", "OpGBTClassifier",
              "OpGBTRegressor"],
}


def __getattr__(name):
    if name != "MODEL_REGISTRY":
        raise AttributeError(name)
    import importlib
    registry = {n: getattr(importlib.import_module(f"{__name__}.{mod}"), n)
                for mod, names in _REGISTRY_NAMES.items() for n in names}
    globals()["MODEL_REGISTRY"] = registry
    return registry
