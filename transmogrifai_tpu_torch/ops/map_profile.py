"""One-pass columnar expansion of numeric-valued map columns, cached on the
Column instance (port of ``transmogrifai_tpu/ops/map_profile.py``;
``native/mapprof.cpp``; reference analogs: the per-key expansion in
OPMapVectorizer.scala and RawFeatureFilter's PreparedFeatures).

RawFeatureFilter (ranges and histograms) and MapVectorizer (fit fills and
transform) share the one walk over the column's dicts.  Columns holding
bools or non-numeric values give ``None``; their callers keep exact Python
paths.  ``native=False`` takes the pure-Python walk, with the same result.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


@dataclass
class MapExpansion:
    keys: List[str]           # first-occurrence order
    vals: np.ndarray          # float64[N, K], NaN where absent/None
    present: np.ndarray       # bool[N, K]  (value present and not None)
    in_dict: np.ndarray       # int64[K]    (key in dict, even if value None)
    nonempty: np.ndarray      # bool[N]     (row is a non-empty dict)

    def key_index(self) -> Dict[str, int]:
        return {k: j for j, k in enumerate(self.keys)}


def _py_expand(maps) -> Optional[MapExpansion]:
    n = len(maps)
    key_ids: Dict[str, int] = {}
    cols: List[np.ndarray] = []
    pres: List[np.ndarray] = []
    in_dict: List[int] = []
    nonempty = np.zeros(n, bool)
    for i, m in enumerate(maps):
        if m is None:
            continue
        if not isinstance(m, dict):
            return None
        if m:
            nonempty[i] = True
        for k, v in m.items():
            if not isinstance(k, str):
                return None
            j = key_ids.get(k)
            if j is None:
                j = len(cols)
                key_ids[k] = j
                cols.append(np.full(n, np.nan))
                pres.append(np.zeros(n, bool))
                in_dict.append(0)
            in_dict[j] += 1
            if v is None:
                continue
            if isinstance(v, bool) or not isinstance(
                    v, (int, float, np.integer, np.floating)):
                return None
            cols[j][i] = float(v)
            pres[j][i] = True
    K = len(cols)
    vals = np.stack(cols, axis=1) if K else np.zeros((n, 0))
    present = np.stack(pres, axis=1) if K else np.zeros((n, 0), bool)
    return MapExpansion(list(key_ids), vals, present,
                        np.asarray(in_dict, np.int64), nonempty)


def expand_maps(maps, native: bool = True) -> Optional[MapExpansion]:
    """The expansion of a sequence of dicts (None when a value is a bool or
    not numeric): the native walk, or the Python one with ``native=False``."""
    if not native:
        return _py_expand(maps)
    from .. import native as nat
    try:
        keys, vals, present, in_dict, nonempty = \
            nat.load("mapprof").expand(list(maps))
    except TypeError:
        return None     # bool / non-numeric values → exact Python paths
    return MapExpansion(list(keys), vals, present.astype(bool), in_dict,
                        nonempty.astype(bool))


_MISS = object()


def map_expansion(col) -> Optional[MapExpansion]:
    """Cached columnar expansion of a map Column (None when its values are
    not purely numeric)."""
    cached = getattr(col, "_map_expansion", _MISS)
    if cached is _MISS:
        cached = expand_maps(col.values)
        col._map_expansion = cached
    return cached
