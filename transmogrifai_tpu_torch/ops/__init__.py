"""The port's feature stages (``transmogrifai_tpu/ops``'s counterparts, as
far as the port has them)."""

from .bucketizers import (DecisionTreeNumericBucketizer,
                          DecisionTreeNumericMapBucketizer,
                          DescalerTransformer, IsotonicRegressionCalibrator,
                          NumericBucketizer, PercentileCalibrator,
                          ScalerTransformer)
from .categorical import OneHotEstimator
from .collections import MultiPickListVectorizer
from .combiner import VectorsCombiner
from .dates import (DateListVectorizer, DateToUnitCircleVectorizer,
                    TimePeriodTransformer)
from .geo import GeolocationVectorizer
from .maps import MapVectorizer
from .numeric import (BinaryVectorizer, IntegralVectorizer, RealNNVectorizer,
                      RealVectorizer)
from .text import SmartTextVectorizer
from .transmogrify import TransmogrifierDefaults, transmogrify

__all__ = ["RealVectorizer", "RealNNVectorizer", "IntegralVectorizer",
           "BinaryVectorizer", "OneHotEstimator", "SmartTextVectorizer",
           "MapVectorizer", "VectorsCombiner", "transmogrify",
           "TransmogrifierDefaults", "DateToUnitCircleVectorizer",
           "DateListVectorizer", "TimePeriodTransformer",
           "GeolocationVectorizer", "MultiPickListVectorizer",
           "NumericBucketizer", "DecisionTreeNumericBucketizer",
           "DecisionTreeNumericMapBucketizer", "PercentileCalibrator",
           "ScalerTransformer", "DescalerTransformer",
           "IsotonicRegressionCalibrator"]
