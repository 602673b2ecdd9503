"""Launch bookkeeping shared by the port's kernel wrappers
(``tree_kernels.py``, ``linear_kernels.py``, ``ops/text_kernels.py``,
``sparse/sparse_kernels.py``, ``insights_kernels.py``,
``metrics_kernels.py``).

Each wrapper takes tensors and dispatches on their device: on a CPU tensor it
runs the plain-PyTorch twin beside it; on a CUDA tensor it launches the
hand-written kernel from ``csrc/`` (built on first use) or raises.  There is
no fallback from a CUDA tensor to the twin.  Each wrapper adds one to
``LAUNCHES[<name>]`` where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import cuda_build

LAUNCHES: Dict[str, int] = {name: 0 for name in cuda_build.KERNEL_SOURCES}

# kernel → the JAX program it replaces (file:line)
REPLACES = {
    "tree_hist": "transmogrifai_tpu/models/trees.py:313",
    "tree_hist_deep": "transmogrifai_tpu/models/trees.py:520",
    "tree_split": "transmogrifai_tpu/models/trees.py:339",
    "tree_split_gini": "transmogrifai_tpu/models/trees.py:331",
    "tree_split_variance": "transmogrifai_tpu/models/trees.py:331",
    "tree_route": "transmogrifai_tpu/models/trees.py:373",
    "tree_walk": "transmogrifai_tpu/models/trees.py:668",
    "fista_step": "transmogrifai_tpu/models/solvers.py:160",
    "fista_softmax": "transmogrifai_tpu/models/solvers.py:44",
    "fista_glm": "transmogrifai_tpu/models/solvers.py:66",
    "fista_wide": "transmogrifai_tpu/models/solvers.py:160",
    "multiclass_confusion": "transmogrifai_tpu/metrics_device.py:135",
    "hash_counts": "transmogrifai_tpu/ops/text.py:148",
    "sp_matmat": "transmogrifai_tpu/sparse/matrix.py:60",
    "sp_rmatmat": "transmogrifai_tpu/sparse/matrix.py:67",
    "loco_linear": "transmogrifai_tpu/record_insights.py:140",
    "loco_tree": "transmogrifai_tpu/record_insights.py:140",
    "loco_softmax": "transmogrifai_tpu/record_insights.py:140",
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def launch(name: str, argtypes, *args) -> None:
    """Launch ``csrc/<name>.cu``'s ``<name>_launch`` and count it."""
    fn = getattr(cuda_build.load(name, argtypes), f"{name}_launch")
    cuda_build.check(name, fn(*args))
    LAUNCHES[name] += 1


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(name: str, t: torch.Tensor, dtype, ndim: int, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: {t.ndim}-d tensor, expected {ndim}-d")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
