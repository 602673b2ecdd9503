"""Typed feature values — the PyTorch port's copy of the JAX package's
``types.py`` (reference:
features/src/main/scala/com/salesforce/op/features/types/FeatureType.scala:44,
Numerics.scala, Text.scala, Maps.scala, OPCollection.scala).

The port keeps its own copy so that importing it never imports the JAX package.

Design notes:
  * The reference wraps every *value* in a typed object (``Real(Option[Double])``).
    On the device the unit of work is the *column*: a dense tensor plus a presence
    mask.  The classes here therefore play two roles:
      1. a *kind* tag carried by columns/features — used for Transmogrifier-style
       type dispatch, schema inference, and serialization;
      2. a thin row-level value wrapper for the local-scoring path (reference
       ``local/`` module) and for tests, mirroring ``value`` / ``isEmpty``.
  * Nullability: ``Option[T]`` becomes a mask array at the column level; at the
    value level ``None`` means empty, matching ``FeatureType.isEmpty``.
  * The registry (``FEATURE_TYPES``, cf. FeatureType.featureTypeTags at
    FeatureType.scala:263-300) gives ``FeatureBuilder`` its typed constructors.
"""

from __future__ import annotations

from typing import Any, ClassVar, Dict, List, Optional, Type

__all__ = [
    "FeatureType", "OPNumeric", "Real", "RealNN", "Binary", "Integral",
    "Percent", "Currency", "Date", "DateTime",
    "Text", "Email", "Base64", "Phone", "ID", "URL", "TextArea", "PickList",
    "ComboBox", "Country", "State", "PostalCode", "City", "Street",
    "OPCollection", "OPList", "OPSet", "OPVector", "TextList", "DateList",
    "DateTimeList", "MultiPickList", "Geolocation",
    "OPMap", "TextMap", "EmailMap", "Base64Map", "PhoneMap", "IDMap", "URLMap",
    "TextAreaMap", "PickListMap", "ComboBoxMap", "BinaryMap", "IntegralMap",
    "RealMap", "PercentMap", "CurrencyMap", "DateMap", "DateTimeMap",
    "MultiPickListMap", "CountryMap", "StateMap", "CityMap", "PostalCodeMap",
    "StreetMap", "NameStats", "GeolocationMap", "Prediction",
    "FEATURE_TYPES", "feature_type_from_name", "is_numeric_kind",
    "is_text_kind", "is_map_kind", "map_value_kind",
]


class FeatureType:
    """Root of the feature type hierarchy (FeatureType.scala:44).

    Subclasses set class-level traits mirroring the reference's marker traits:
    ``non_nullable`` (NonNullable:122), ``is_categorical`` (Categorical:155),
    ``is_location`` (Location:140), ``single_response`` / ``multi_response``.
    """

    non_nullable: ClassVar[bool] = False
    is_categorical: ClassVar[bool] = False
    is_location: ClassVar[bool] = False
    single_response: ClassVar[bool] = False
    multi_response: ClassVar[bool] = False

    __slots__ = ("value",)

    def __init__(self, value: Any = None):
        if value is None and self.non_nullable:
            raise ValueError(f"{type(self).__name__} cannot be empty (NonNullable)")
        self.value = value

    @property
    def is_empty(self) -> bool:
        v = self.value
        if v is None:
            return True
        if isinstance(v, (list, tuple, set, dict, str)):
            return len(v) == 0
        return False

    @property
    def non_empty(self) -> bool:
        return not self.is_empty

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and self.value == other.value

    def __hash__(self):
        v = self.value
        if isinstance(v, (list, set, dict)):
            v = repr(v)
        return hash((type(self).__name__, v))

    def __repr__(self):
        return f"{type(self).__name__}({self.value!r})"

    @classmethod
    def type_name(cls) -> str:
        return cls.__name__

    @classmethod
    def empty(cls) -> "FeatureType":
        return cls(None)


# --------------------------------------------------------------------------
# Numerics (Numerics.scala:40-150)
# --------------------------------------------------------------------------

class OPNumeric(FeatureType):
    """Base for numeric kinds; value is float/int or None."""

    def to_double(self) -> Optional[float]:
        return None if self.value is None else float(self.value)


class Real(OPNumeric):
    pass


class RealNN(Real):
    non_nullable = True
    single_response = True


class Binary(OPNumeric):
    is_categorical = True
    single_response = True


class Integral(OPNumeric):
    pass


class Percent(Real):
    pass


class Currency(Real):
    pass


class Date(Integral):
    """Milliseconds since epoch, like the reference (joda millis)."""


class DateTime(Date):
    pass


# --------------------------------------------------------------------------
# Text and its subtypes (Text.scala:48-301)
# --------------------------------------------------------------------------

class Text(FeatureType):
    pass


class Email(Text):
    pass


class Base64(Text):
    pass


class Phone(Text):
    pass


class ID(Text):
    pass


class URL(Text):
    pass


class TextArea(Text):
    pass


class PickList(Text):
    is_categorical = True


class ComboBox(Text):
    pass


class Country(Text):
    is_location = True


class State(Text):
    is_location = True


class PostalCode(Text):
    is_location = True


class City(Text):
    is_location = True


class Street(Text):
    is_location = True


# --------------------------------------------------------------------------
# Collections and maps (OPCollection.scala:37, OPVector.scala, Maps.scala)
# --------------------------------------------------------------------------

class OPCollection(FeatureType):
    pass


class OPList(OPCollection):
    pass


class OPSet(OPCollection):
    is_categorical = True
    multi_response = True


class TextList(OPList):
    pass


class DateList(OPList):
    pass


class DateTimeList(DateList):
    pass


class MultiPickList(OPSet):
    pass


class Geolocation(OPList):
    """(lat, lon, accuracy) triple (Geolocation.scala:47)."""


class OPVector(OPCollection):
    """Dense numeric vector (reference wraps Spark ml Vector, OPVector.scala:41).

    Column-level storage is a [N, D] float array; the row-level wrapper keeps a
    list/np array of floats.
    """

    def __init__(self, value=None):
        if value is None:
            value = []
        super().__init__(value)

    @property
    def is_empty(self) -> bool:
        return len(self.value) == 0


class OPMap(OPCollection):
    """String-keyed map; ``value_kind`` gives the element feature type."""

    value_kind: ClassVar[Type[FeatureType]] = FeatureType

    def __init__(self, value: Optional[Dict[str, Any]] = None):
        super().__init__(dict(value) if value is not None else {})

    @property
    def is_empty(self) -> bool:
        return len(self.value) == 0


class TextMap(OPMap):
    value_kind = Text


class EmailMap(OPMap):
    value_kind = Email


class Base64Map(OPMap):
    value_kind = Base64


class PhoneMap(OPMap):
    value_kind = Phone


class IDMap(OPMap):
    value_kind = ID


class URLMap(OPMap):
    value_kind = URL


class TextAreaMap(OPMap):
    value_kind = TextArea


class PickListMap(OPMap):
    value_kind = PickList
    is_categorical = True


class ComboBoxMap(OPMap):
    value_kind = ComboBox


class BinaryMap(OPMap):
    value_kind = Binary
    is_categorical = True


class IntegralMap(OPMap):
    value_kind = Integral


class RealMap(OPMap):
    value_kind = Real


class PercentMap(RealMap):
    value_kind = Percent


class CurrencyMap(RealMap):
    value_kind = Currency


class DateMap(OPMap):
    value_kind = Date


class DateTimeMap(DateMap):
    value_kind = DateTime


class MultiPickListMap(OPMap):
    value_kind = MultiPickList
    is_categorical = True


class CountryMap(TextMap):
    is_location = True


class StateMap(TextMap):
    is_location = True


class CityMap(TextMap):
    is_location = True


class PostalCodeMap(TextMap):
    is_location = True


class StreetMap(TextMap):
    is_location = True


class NameStats(TextMap):
    """Name-detection stats map (Maps.scala NameStats)."""


class GeolocationMap(OPMap):
    value_kind = Geolocation


class Prediction(RealMap):
    """The universal model output (Maps.scala:339-394): a RealMap with keys
    ``prediction``, ``probability_i``, ``rawPrediction_i``."""

    non_nullable = True

    PREDICTION = "prediction"
    RAW_PREDICTION = "rawPrediction"
    PROBABILITY = "probability"

    def __init__(self, value: Optional[Dict[str, float]] = None,
                 prediction: Optional[float] = None,
                 raw_prediction=None, probability=None):
        if value is None:
            if prediction is None:
                raise ValueError("Prediction requires a 'prediction' key")
            value = {self.PREDICTION: float(prediction)}
            for base, arr in ((self.RAW_PREDICTION, raw_prediction),
                              (self.PROBABILITY, probability)):
                if arr is not None:
                    for i, v in enumerate(arr):
                        value[f"{base}_{i}"] = float(v)
        if self.PREDICTION not in value:
            raise ValueError("Prediction map must contain key 'prediction'")
        super().__init__(value)

    @property
    def prediction(self) -> float:
        return self.value[self.PREDICTION]

    def _keyed(self, base: str) -> List[float]:
        items = [(int(k.rsplit("_", 1)[1]), v) for k, v in self.value.items()
                 if k.startswith(base + "_")]
        return [v for _, v in sorted(items)]

    @property
    def raw_prediction(self) -> List[float]:
        return self._keyed(self.RAW_PREDICTION)

    @property
    def probability(self) -> List[float]:
        return self._keyed(self.PROBABILITY)


# --------------------------------------------------------------------------
# Registry & helpers (cf. FeatureType.featureTypeTags,
# FeatureType.scala:263-300).  Every kind is registered, so a schema of any
# kinds builds; ``ops/transmogrify.py`` names the kinds the port vectorizes.
# --------------------------------------------------------------------------

FEATURE_TYPES: Dict[str, Type[FeatureType]] = {
    c.__name__: c for c in [
        Real, RealNN, Binary, Integral, Percent, Currency, Date, DateTime,
        Text, Email, Base64, Phone, ID, URL, TextArea, PickList, ComboBox,
        Country, State, PostalCode, City, Street,
        OPVector, TextList, DateList, DateTimeList, MultiPickList, Geolocation,
        TextMap, EmailMap, Base64Map, PhoneMap, IDMap, URLMap, TextAreaMap,
        PickListMap, ComboBoxMap, BinaryMap, IntegralMap, RealMap, PercentMap,
        CurrencyMap, DateMap, DateTimeMap, MultiPickListMap, CountryMap,
        StateMap, CityMap, PostalCodeMap, StreetMap, NameStats, GeolocationMap,
        Prediction,
    ]
}


def feature_type_from_name(name: str) -> Type[FeatureType]:
    try:
        return FEATURE_TYPES[name]
    except KeyError:
        raise ValueError(f"unknown feature type: {name!r}") from None


def is_numeric_kind(kind: Type[FeatureType]) -> bool:
    return issubclass(kind, OPNumeric)


def is_text_kind(kind: Type[FeatureType]) -> bool:
    return issubclass(kind, Text)


def is_map_kind(kind: Type[FeatureType]) -> bool:
    return issubclass(kind, OPMap)


def map_value_kind(kind: Type[FeatureType]) -> Type[FeatureType]:
    if not is_map_kind(kind):
        raise TypeError(f"{kind.__name__} is not a map kind")
    return kind.value_kind
