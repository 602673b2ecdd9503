"""Per-column lineage metadata for assembled feature vectors — the port's
copy of the parts of the JAX package's ``vector_meta.py`` this slice uses
(≙ OpVectorMetadata / OpVectorColumnMetadata, reference:
features/src/main/scala/com/salesforce/op/utils/spark/OpVectorColumnMetadata.scala:67).

Every vectorizer emits, alongside its [N, D] tensor, one ``VectorColumnMeta``
per output column recording which raw feature it came from and indicator
info; the SanityChecker names its report rows and keeps its column slice
with it, and record explanations group the columns by raw parent
(:func:`group_key`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

NULL_INDICATOR = "NullIndicatorValue"   # cf. OpVectorColumnMetadata.NullString
OTHER_INDICATOR = "OTHER"
# date-circle and date-period descriptors that split a raw parent's columns
# into one explanation group per period (≙ record_insights.py:32-33)
_PERIODS = ("HourOfDay", "DayOfWeek", "DayOfMonth", "DayOfYear",
            "WeekOfMonth", "WeekOfYear", "MonthOfYear", "QuarterOfYear")


@dataclass(frozen=True)
class VectorColumnMeta:
    """One column of an assembled feature vector."""

    parent_feature_name: str
    parent_feature_type: str
    grouping: Optional[str] = None          # e.g. map key or categorical group
    indicator_value: Optional[str] = None   # pivoted categorical value / null flag
    descriptor_value: Optional[str] = None  # e.g. "sin(dayOfWeek)" for date circles
    index: int = 0

    def make_col_name(self) -> str:
        parts = [self.parent_feature_name]
        if self.grouping:
            parts.append(self.grouping)
        if self.indicator_value:
            parts.append(self.indicator_value)
        elif self.descriptor_value:
            parts.append(self.descriptor_value)
        return "_".join(parts) + f"_{self.index}"

    def to_json(self) -> Dict:
        return {
            "parentFeatureName": self.parent_feature_name,
            "parentFeatureType": self.parent_feature_type,
            "grouping": self.grouping,
            "indicatorValue": self.indicator_value,
            "descriptorValue": self.descriptor_value,
            "index": self.index,
        }

    @staticmethod
    def from_json(d: Dict) -> "VectorColumnMeta":
        return VectorColumnMeta(
            parent_feature_name=d["parentFeatureName"],
            parent_feature_type=d["parentFeatureType"],
            grouping=d.get("grouping"),
            indicator_value=d.get("indicatorValue"),
            descriptor_value=d.get("descriptorValue"),
            index=d.get("index", 0))


def group_key(col_meta: VectorColumnMeta) -> str:
    """The raw-feature group of a column for record explanations (≙
    ``_group_key``, record_insights.py:36-45): its raw parent, with
    date-circle columns (``sin(p)`` / ``cos(p)``) and period descriptors
    split per (parent, period)."""
    parent = col_meta.parent_feature_name
    desc = col_meta.descriptor_value or ""
    if desc.startswith(("sin(", "cos(")) and desc.endswith(")"):
        return f"{parent}_{desc[4:-1]}"
    for p in _PERIODS:
        if desc == p or desc.startswith(p + "_"):
            return f"{parent}_{p}"
    return parent


@dataclass
class VectorMeta:
    """Metadata for a whole feature vector (≙ OpVectorMetadata)."""

    name: str
    columns: List[VectorColumnMeta] = field(default_factory=list)

    def __post_init__(self):
        # the constructor, not dataclasses.replace: 100,000 hash columns
        # re-index in a fifth of the time
        self.columns = [
            c if c.index == i else VectorColumnMeta(
                c.parent_feature_name, c.parent_feature_type, c.grouping,
                c.indicator_value, c.descriptor_value, i)
            for i, c in enumerate(self.columns)]

    @property
    def size(self) -> int:
        return len(self.columns)

    def column_names(self) -> List[str]:
        return [c.make_col_name() for c in self.columns]

    def select(self, indices: Sequence[int], name: Optional[str] = None) -> "VectorMeta":
        return VectorMeta(name or self.name, [self.columns[i] for i in indices])

    def to_json(self) -> Dict:
        return {"name": self.name,
                "columns": [c.to_json() for c in self.columns]}

    @staticmethod
    def from_json(d: Dict) -> "VectorMeta":
        return VectorMeta(d["name"], [VectorColumnMeta.from_json(c)
                                      for c in d["columns"]])

    @staticmethod
    def flatten(name: str, metas: Sequence["VectorMeta"]) -> "VectorMeta":
        cols: List[VectorColumnMeta] = []
        for m in metas:
            cols.extend(m.columns)
        return VectorMeta(name, cols)
