"""Transmogrifier — automatic per-type feature vectorization (port of
``transmogrifai_tpu/ops/transmogrify.py``; reference: Transmogrifier.scala:92,
defaults at TransmogrifierDefaults:52-88).

Groups input features by kind, applies the default vectorizer per group and
combines the blocks with VectorsCombiner, the groups in sorted order as in
the JAX package.  The port vectorizes reals, integrals, binaries, pick-lists
and their categorical siblings, free text (SmartTextVectorizer),
numeric-valued maps, dates and date lists, multi-pick-lists and
geolocations; every other kind (text lists, the specialised text kinds,
maps of other values) raises ``NotImplementedError`` naming the queue item
of the port that brings it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Type

from ..features import Feature
from ..types import (ID, URL, Base64, Binary, City, ComboBox, Country,
                     Currency, Date, DateList, DateTime, DateTimeList, Email,
                     FeatureType, Geolocation, Integral, MultiPickList, OPMap,
                     OPVector, Percent, Phone, PickList, PostalCode, Real,
                     RealNN, State, Street, Text, TextArea, TextList,
                     map_value_kind)


class TransmogrifierDefaults:
    """≙ TransmogrifierDefaults (Transmogrifier.scala:52-88), the JAX
    package's values."""

    DEFAULT_NUM_OF_FEATURES = 512
    MAX_NUM_OF_FEATURES = 16384
    TOP_K = 20
    MIN_SUPPORT = 10
    MAX_CATEGORICAL_CARDINALITY = 30
    FILL_VALUE = 0.0
    BINARY_FILL_VALUE = False
    TRACK_NULLS = True
    TRACK_INVALID = False
    TRACK_TEXT_LEN = False
    MIN_DOC_FREQUENCY = 0
    CIRCULAR_DATE_REPRESENTATIONS = ("HourOfDay", "DayOfWeek", "DayOfMonth",
                                     "DayOfYear")
    REFERENCE_DATE_MS = 1500000000000


_CATEGORICAL = (PickList, ComboBox, ID, Country, State, City, PostalCode,
                Street)


def _later(kind: Type[FeatureType], what: str) -> NotImplementedError:
    return NotImplementedError(
        f"transmogrify: {kind.__name__} features ({what}) arrive with a later "
        "slice of the port (ROADMAP queue 1 item 7)")


def _group_key(kind: Type[FeatureType]) -> str:
    if issubclass(kind, RealNN):
        return "realnn"
    if issubclass(kind, Binary):
        return "binary"
    if issubclass(kind, (Date, DateTime)):
        return "date"
    if issubclass(kind, Integral):
        return "integral"
    if issubclass(kind, (Real, Percent, Currency)):
        return "real"
    if issubclass(kind, _CATEGORICAL):
        return "categorical"
    if issubclass(kind, (Email, URL, Phone, Base64)):
        raise _later(kind, "specialised text")
    if issubclass(kind, (TextArea, Text)):
        return "text"
    if issubclass(kind, TextList):
        raise _later(kind, "text lists")
    if issubclass(kind, (DateList, DateTimeList)):
        return "datelist"
    if issubclass(kind, MultiPickList):
        return "multipicklist"
    if issubclass(kind, Geolocation):
        return "geolocation"
    if issubclass(kind, OPVector):
        return "vector"
    if issubclass(kind, OPMap):
        vk = map_value_kind(kind)
        if issubclass(vk, (Real, Integral)) and not issubclass(
                vk, (Binary, Date)):
            return "map"
        raise _later(kind, "maps of non-numeric values")
    raise TypeError(f"transmogrify: unsupported feature kind {kind.__name__}")


def transmogrify(features: Sequence[Feature],
                 top_k: int = TransmogrifierDefaults.TOP_K,
                 min_support: int = TransmogrifierDefaults.MIN_SUPPORT,
                 num_hashes: int = TransmogrifierDefaults.DEFAULT_NUM_OF_FEATURES,
                 max_categorical_cardinality: int =
                 TransmogrifierDefaults.MAX_CATEGORICAL_CARDINALITY,
                 track_nulls: bool = TransmogrifierDefaults.TRACK_NULLS
                 ) -> Feature:
    """Auto-vectorize a feature list into one OPVector feature."""
    from .categorical import OneHotEstimator
    from .collections import MultiPickListVectorizer
    from .combiner import VectorsCombiner
    from .dates import DateListVectorizer, DateToUnitCircleVectorizer
    from .geo import GeolocationVectorizer
    from .maps import MapVectorizer
    from .numeric import (BinaryVectorizer, IntegralVectorizer,
                          RealNNVectorizer, RealVectorizer)
    from .text import SmartTextVectorizer

    groups: Dict[str, List[Feature]] = {}
    for f in features:
        groups.setdefault(_group_key(f.kind), []).append(f)

    blocks: List[Feature] = []
    for key in sorted(groups):
        feats = groups[key]
        if key == "vector":
            blocks.extend(feats)
            continue
        if key == "map":
            # one MapVectorizer per numeric map (Transmogrifier.scala:142-217)
            for f in feats:
                st = MapVectorizer(top_k=top_k, min_support=min_support,
                                   track_nulls=track_nulls)
                st.set_input(f)
                blocks.append(st.get_output())
            continue
        if key == "real":
            st = RealVectorizer(fill_mode="mean", track_nulls=track_nulls)
        elif key == "realnn":
            st = RealNNVectorizer()
        elif key == "integral":
            st = IntegralVectorizer(fill_mode="mode", track_nulls=track_nulls)
        elif key == "binary":
            st = BinaryVectorizer(track_nulls=track_nulls)
        elif key == "categorical":
            st = OneHotEstimator(top_k=top_k, min_support=min_support,
                                 track_nulls=track_nulls)
        elif key == "date":
            st = DateToUnitCircleVectorizer(track_nulls=track_nulls)
        elif key == "datelist":
            st = DateListVectorizer(track_nulls=track_nulls)
        elif key == "multipicklist":
            st = MultiPickListVectorizer(top_k=top_k, min_support=min_support,
                                         track_nulls=track_nulls)
        elif key == "geolocation":
            st = GeolocationVectorizer(track_nulls=track_nulls)
        else:  # text
            st = SmartTextVectorizer(
                max_cardinality=max_categorical_cardinality, top_k=top_k,
                min_support=min_support, num_hashes=num_hashes,
                track_nulls=track_nulls)
        st.set_input(*feats)
        blocks.append(st.get_output())

    combiner = VectorsCombiner()
    combiner.set_input(*blocks)
    return combiner.get_output()
