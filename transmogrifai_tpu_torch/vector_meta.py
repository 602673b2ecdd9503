"""Per-column lineage metadata for assembled feature vectors — the port's
copy of the parts of the JAX package's ``vector_meta.py`` this slice uses
(≙ OpVectorMetadata / OpVectorColumnMetadata, reference:
features/src/main/scala/com/salesforce/op/utils/spark/OpVectorColumnMetadata.scala:67).

Every vectorizer emits, alongside its [N, D] tensor, one ``VectorColumnMeta``
per output column recording which raw feature it came from and indicator
info; the SanityChecker names its report rows and keeps its column slice
with it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

NULL_INDICATOR = "NullIndicatorValue"   # cf. OpVectorColumnMetadata.NullString
OTHER_INDICATOR = "OTHER"


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

    @staticmethod
    def flatten(name: str, metas: Sequence["VectorMeta"]) -> "VectorMeta":
        cols: List[VectorColumnMeta] = []
        for m in metas:
            cols.extend(m.columns)
        return VectorMeta(name, cols)
