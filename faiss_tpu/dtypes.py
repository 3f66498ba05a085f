"""Shared enums + sentinel/ABI constants.

Parity notes (reference faiss-metal):
  * StorageType mirrors include/faiss-metal/MetalIndexFlat.h:39-43
    (Float32 / Float16 / BFloat16 — queries always fp32).
  * MetricType mirrors the two metrics the reference supports
    (faiss::METRIC_L2 / METRIC_INNER_PRODUCT — MetalIndexFlat.mm:171).
  * Sentinels mirror the reference's empty/k>ntotal fill values:
    +INF distance for L2, −INF for IP, label −1
    (src/MetalIndexFlat.mm:328-337, :384-400).
  * Per-shard ids are int32 (shaders emit int32 — MetalIndexFlat.mm:323-326);
    we widen to int64 *global* ids after the cross-shard merge, which lifts
    the reference's 2^31−1 total-size limit to per-shard only.
"""

import enum

import numpy as np


class StorageType(enum.Enum):
    """On-device vector storage precision. Queries/accumulation remain fp32.

    INT8 goes beyond the reference's Float32/Float16/BFloat16 set
    (MetalIndexFlat.h:39-43): 1 B/element HBM with per-dimension symmetric
    scales (faiss ScalarQuantizer QT_8bit analog — the int8
    nomination dot is EXACT in int32, so the runtime exactness certificate
    still applies; the win is footprint, ~14M×128/chip). Requires
    train() (or auto-trains on the first add batch)."""

    FLOAT32 = "float32"
    FLOAT16 = "float16"
    BFLOAT16 = "bfloat16"
    INT8 = "int8"

    @classmethod
    def coerce(cls, v) -> "StorageType":
        if isinstance(v, cls):
            return v
        s = str(v).lower().replace("-", "").replace("_", "")
        aliases = {
            "float32": cls.FLOAT32, "f32": cls.FLOAT32, "fp32": cls.FLOAT32,
            "float16": cls.FLOAT16, "f16": cls.FLOAT16, "fp16": cls.FLOAT16,
            "half": cls.FLOAT16,
            "bfloat16": cls.BFLOAT16, "bf16": cls.BFLOAT16,
            "int8": cls.INT8, "i8": cls.INT8, "qint8": cls.INT8,
        }
        try:
            return aliases[s]
        except KeyError:
            raise ValueError(f"unknown storage type: {v!r}") from None


class MetricType(enum.Enum):
    L2 = "l2"                 # squared L2, like faiss METRIC_L2
    INNER_PRODUCT = "ip"

    @classmethod
    def coerce(cls, v) -> "MetricType":
        if isinstance(v, cls):
            return v
        s = str(v).lower()
        aliases = {
            "l2": cls.L2, "metric_l2": cls.L2, "euclidean": cls.L2,
            "ip": cls.INNER_PRODUCT, "inner_product": cls.INNER_PRODUCT,
            "metric_inner_product": cls.INNER_PRODUCT, "dot": cls.INNER_PRODUCT,
        }
        try:
            return aliases[s]
        except KeyError:
            raise ValueError(f"unknown metric: {v!r}") from None


# Sentinel values for invalid / past-the-end results (reference parity, see
# module docstring). For L2 the "worst" distance is +inf; for IP it is −inf.
SENTINEL_LABEL = np.int64(-1)
SENTINEL_LABEL_I32 = np.int32(-1)


def worst_distance(metric: MetricType) -> float:
    return np.inf if metric is MetricType.L2 else -np.inf
