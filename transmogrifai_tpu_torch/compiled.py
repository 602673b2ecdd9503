"""Compiled scoring — the fitted DAG partitioned for repeated scoring (port of
``transmogrifai_tpu/compiled.py``; reference: the bulk row map of
FitStagesUtil.scala:96).

``ScoreProgram(dag, result_names)`` then ``program(batch)`` gives
``apply_dag``'s columns, bit for bit, with these parts of the JAX package's
program:

* within a layer, host stages run before device and staged stages (any
  order within a layer is topologically legal), so device segments
  coalesce (JAX :121-132);
* ``_partition`` splits the stages into host stages and device segments:
  a device segment is a maximal stretch of device stages over array
  columns, joined by staged stages (host strings lowered on the host, the
  block written on the device) whose inputs are made before the segment
  (JAX :184-217);
* each numeric column a segment reads from before it is uploaded once a
  call, as exact f32 (``columns.to_device_f32``); the original batch keeps
  its host columns;
* a segment keeps of its outputs only those a later stage or a result
  needs (``_wanted_outputs``, JAX :244-253), unless ``keep_intermediate``;
  within the segment a column is released as soon as no later stage of the
  segment and nothing after it needs it;
* results stay on the device.

Left out, each being an artifact of ``jax.jit`` or the TPU mesh: the jit
table and its canonical argument names (eager PyTorch runs a segment as its
stages' own calls, kernels included, and has no trace to cache), the trace
counter and ``suppress_trace_count`` (no traces), the AOT installs, variants
and registry seam (no executables to ship), mesh sharding (JAX :140-182,
:381-458; one card), and both demotions — ``_StageTraceError`` (JAX
:229-241) and the eager fallback (JAX :470-484).  A stage that raises inside
a device segment raises to the caller; nothing is re-run on another path.
``transform_staged`` is not ported: a staged stage's ``transform`` already
lowers its strings on the host and writes its block on the device
(``ops/text.py``, ``ops/categorical.py``, ``ops/maps.py``), so the segment
calls it as it calls any stage.

``build_count()`` stands where the JAX package's ``trace_count()`` (JAX
:59) stands for serving: what a first call can still cost in eager PyTorch
is not a trace but the first build or load of a library — a kernel's
``nvcc`` build and ``dlopen`` (``cuda_build.load``) or a native helper's
(``native.load``).  It counts every library this process has compiled or
first loaded, so a serving engine that reads it before and after a batch
sees whether the batch paid for one.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

import numpy as np
import torch

from .columns import Column, ColumnBatch, to_device_f32
from .stages.base import Transformer
from .types import OPVector, Prediction, is_numeric_kind


def build_count() -> int:
    """Kernel and native libraries this process has compiled or first
    loaded (see the module docstring)."""
    from . import cuda_build, native
    return cuda_build.build_count() + native.build_count()


def _kind_arrayish(kind) -> bool:
    """Does a column of ``kind`` hold arrays (rather than host objects)?"""
    return kind is not None and (issubclass(kind, (OPVector, Prediction))
                                 or is_numeric_kind(kind))


def _upload(col: Column, device) -> Column:
    """A host numeric column as device tensors; anything else as given."""
    if not isinstance(col.values, np.ndarray) or col.is_host_object():
        return col
    mask = (None if col.mask is None
            else torch.as_tensor(np.asarray(col.mask), device=device))
    return Column(col.kind, to_device_f32(col.values, device), mask,
                  col.meta)


class ScoreProgram:
    """A fitted DAG partitioned for repeated scoring: ``program(batch)`` runs
    host stages eagerly and each device segment as one pass over its stages
    on the batch's device."""

    def __init__(self, dag: Sequence, result_names: Sequence[str]):
        layers = ([list(l) for l in dag]
                  if dag and isinstance(dag[0], (list, tuple)) else [list(dag)])
        self.stages: List[Transformer] = []
        for layer in layers:
            self.stages.extend(sorted(
                layer, key=lambda s: bool(s.is_device_op
                                          or s.supports_staging)))
        self.result_names = list(result_names)

    def _partition(self, batch: ColumnBatch
                   ) -> List[Tuple[bool, List[Transformer]]]:
        """(is_device_segment, stages) groups in order."""
        arrayish: Dict[str, bool] = {
            name: not col.is_host_object() for name, col in batch.items()}
        segments: List[Tuple[bool, List[Transformer]]] = []
        seg_outputs: Set[str] = set()   # outputs of the open device segment
        for st in self.stages:
            dev_ok = st.is_device_op and all(
                arrayish.get(f.name, False) for f in st.input_features)
            # a staged stage lowers its inputs on the host before the
            # segment runs, so none of them may come from the segment
            staged_ok = (not dev_ok and st.supports_staging
                         and not any(f.name in seg_outputs
                                     for f in st.input_features))
            ok = dev_ok or staged_ok
            for f in st.output_features:
                arrayish[f.name] = True if ok else _kind_arrayish(f.kind)
            if segments and segments[-1][0] == ok:
                segments[-1][1].append(st)
            else:
                segments.append((ok, [st]))
                seg_outputs = set()
            if ok:
                seg_outputs.update(f.name for f in st.output_features)
        return segments

    def __call__(self, batch: ColumnBatch, keep_intermediate: bool = False
                 ) -> ColumnBatch:
        segments = self._partition(batch)
        b = batch
        for i, (is_dev, stages) in enumerate(segments):
            if not is_dev:
                for st in stages:
                    b = st.transform_batch(b)
                continue
            later = [st for _, seg in segments[i + 1:] for st in seg]
            b = self._apply_run(b, stages, later, keep_intermediate)
        return b

    def _wanted_outputs(self, run: List[Transformer],
                        later: List[Transformer],
                        keep_intermediate: bool) -> List[str]:
        produced = [f.name for st in run for f in st.output_features]
        if keep_intermediate:
            return produced
        needed = set(self.result_names)
        for st in later:
            needed.update(f.name for f in st.input_features)
        return [n for n in produced if n in needed]

    def _apply_run(self, batch: ColumnBatch, run: List[Transformer],
                   later: List[Transformer], keep_intermediate: bool
                   ) -> ColumnBatch:
        dev = batch.device
        frontier = sorted({f.name for st in run if st.is_device_op
                           for f in st.input_features if f.name in batch})
        seg = batch.with_columns({n: _upload(batch[n], dev)
                                  for n in frontier})
        wanted = self._wanted_outputs(run, later, keep_intermediate)
        # the names each position still needs: later stages' inputs and the
        # segment's outputs; the rest of the segment's columns are released
        keep = set(wanted)
        needed_after: List[Set[str]] = []
        for st in reversed(run):
            needed_after.append(set(keep))
            keep.update(f.name for f in st.input_features)
        needed_after.reverse()
        own = set(frontier)
        for st, needed in zip(run, needed_after):
            seg = st.transform_batch(seg)
            own.update(f.name for f in st.output_features)
            if not keep_intermediate:
                done = [n for n in own if n not in needed]
                seg = seg.drop(done)
                own.difference_update(done)
        return batch.with_columns({n: seg[n] for n in wanted})
