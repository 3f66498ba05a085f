"""Distance stage — XLA reference path ("the MPS-path analog").

≈ MetalDistance (src/MetalDistance.{h,mm}): the reference dispatches among an
MPS GEMM path, custom simdgroup GEMM tiles (32×32 / 64×64, f32/f16/bf16
storage), and a direct per-pair kernel for tiny nv (MetalDistance.mm:107-323).
Here the "library GEMM" analog is plain ``lax.dot_general`` — XLA maps it to
cuBLAS or its own GEMM and fuses the ±2α scaling and the norm-broadcast
epilogue, so the
reference's separate ``broadcast_sum_l2`` pass (shaders/broadcast_sum.metal)
never exists as its own kernel here.

This module is the forever differential oracle for the fused path
(the same role the forced-MPS path plays in the reference's cross-path tests,
tests/test_metal_distance.mm:233-337).

Conventions
-----------
Everything downstream works on *scores* where larger is better:
  L2 : score = −(‖q‖² − 2·q·v + ‖v‖²)   (negated squared distance)
  IP : score =  q·v
Invalid (padding) columns get −inf so top-k naturally ranks them last, which
implements the reference's k>ntotal sentinel-fill semantics
(src/MetalIndexFlat.mm:384-400) with static shapes inside jit.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..dtypes import MetricType
from . import l2norm

# Problem-size heuristic, named like the reference's dispatch constant
# (MetalDistance.mm:238 — direct path when nv≤256). The fused-path gate lives
# in ops/pallas_fused.fused_path_eligible (a measured cost model).
DIRECT_PATH_MAX_NV = 256          # tiny-db: skip the GEMM, do exact per-pair L2


def matmul_scores(
    queries: jax.Array,           # (nq, d) fp32
    db: jax.Array,                # (nv, d) storage dtype (f32/bf16/f16)
    db_norms: Optional[jax.Array],  # (nv,) fp32, required for L2
    metric: MetricType,
) -> jax.Array:
    """(nq, nv) fp32 scores via one GEMM + fused epilogue.

    Low-precision storage: queries are cast to the storage dtype for the GEMM
    (halving HBM traffic on the big operand is the win — reference
    simdgroup_gemm.metal:303 reads B as half directly), with fp32 accumulation
    via ``preferred_element_type`` (the tensor cores accumulate fp32, like the
    reference's fp32 simdgroup accumulators, simdgroup_gemm.metal:45-55).
    """
    dn = (((1,), (1,)), ((), ()))
    if db.dtype == jnp.float32:
        # True fp32 quality: an fp32 dot may run as TF32 (~1e-3 rel err)
        # unless a precision is asked for; HIGHEST keeps full fp32. The reference's "fp32" GEMM is actually f16-multiply /
        # f32-accumulate (simdgroup_gemm.metal:26-138) — our *reduced* storage
        # path below is its true analog; fp32 storage here is strictly better.
        dots = jax.lax.dot_general(
            queries, db, dn,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
    elif db.dtype == jnp.bfloat16 and queries.dtype == jnp.float32:
        # bf16 storage: bf16×bf16 products are exact in fp32, so an EXACT
        # 3-way query split makes scores fp32-true w.r.t. the stored
        # (quantized) vectors — the plain path then agrees exactly with the
        # fused path's rescore. ~free when bandwidth-bound (db read is the
        # cost); 3× GEMM work only matters for very large nq.
        from ..storage import split3_f32_bf16

        dots = None
        for q_part in split3_f32_bf16(queries):
            d_part = jax.lax.dot_general(q_part, db, dn,
                                         preferred_element_type=jnp.float32)
            dots = d_part if dots is None else dots + d_part
    else:
        # f16 (and pre-cast bf16) inputs: one pass, fp32 accumulate.
        dots = jax.lax.dot_general(
            queries.astype(db.dtype), db, dn,
            preferred_element_type=jnp.float32,
        )
    if metric is MetricType.INNER_PRODUCT:
        return dots
    # L2: score = −‖q−v‖² = 2·q·v − ‖q‖² − ‖v‖²  (norm epilogue fused by XLA;
    # ≈ simdgroup_gemm_l2_fused's store-loop epilogue, simdgroup_gemm.metal:241-252)
    if db_norms is None:
        db_norms = l2norm.l2_norm_squared(db)
    q_norms = l2norm.l2_norm_squared(queries)
    return 2.0 * dots - q_norms[:, None] - db_norms[None, :]


def pair_scores(
    queries: jax.Array,           # (nq, d) fp32
    db_hi: jax.Array,             # (nv, d) bf16 hi part
    db_lo: jax.Array,             # (nv, d) bf16 lo part
    db_norms: Optional[jax.Array],
    metric: MetricType,
) -> jax.Array:
    """(nq, nv) scores for pair-only HBM storage (storage.DeviceStore
    pair_only: f16 always, f32 with keep_master=False).

    Four bf16 passes (q_hi+q_lo)·(v_hi+v_lo): every product is exact in
    fp32, the query pair split is exact to ~2^-16, so scores are fp32-true
    w.r.t. the hi+lo-represented database — the same arithmetic class as the
    fused path's rescore, without ever materializing fp32 rows."""
    from ..storage import split_f32_bf16

    qh, ql = split_f32_bf16(queries)
    dn = (((1,), (1,)), ((), ()))
    dots = None
    for q_part in (qh, ql):
        for d_part in (db_hi, db_lo):
            d_ = jax.lax.dot_general(q_part, d_part, dn,
                                     preferred_element_type=jnp.float32)
            dots = d_ if dots is None else dots + d_
    if metric is MetricType.INNER_PRODUCT:
        return dots
    q_norms = l2norm.l2_norm_squared(queries)
    return 2.0 * dots - q_norms[:, None] - db_norms[None, :]


def f16_scores(
    queries: jax.Array,           # (nq, d) fp32
    dbits: jax.Array,             # (nv, d) int16 f16 bit patterns
    db_norms: Optional[jax.Array],
    metric: MetricType,
) -> jax.Array:
    """(nq, nv) scores against 2 B/elem f16-bits storage: XLA decode to the
    exact bf16 (hi, lo) pair (storage.split_f16_bits — bit-exact for every
    f16 value) + the 4-pass pair GEMM. Same fp32-true arithmetic class as
    the fused path's rescore, so plain and fused agree."""
    from ..storage import split_f16_bits

    hi, lo = split_f16_bits(dbits)
    return pair_scores(queries, hi, lo, db_norms, metric)


def int8_scores(
    queries: jax.Array,           # (nq, d) fp32
    scales: jax.Array,            # (d,) fp32 per-dim quantization scales
    vq: jax.Array,                # (nv, d) int8 quantized rows
    db_norms: jax.Array,          # (nv,) fp32 ‖v̂‖² of the DECODED rows
    metric: MetricType,
) -> jax.Array:
    """(nq, nv) fp32-true scores against the decoded int8 database.

    q·v̂ = q·(s∘v_q) = (q∘s)·v_q: the query side absorbs the scales, the
    int8 rows cast to bf16 EXACTLY (|v_q| ≤ 127), and the exact 3-way
    split of q∘s makes the dot fp32-true — the same arithmetic class as
    the fused path's rescore, so plain and fused agree."""
    from ..storage import split3_f32_bf16

    qs = queries * scales[None, :]
    vb = vq.astype(jnp.bfloat16)
    dn = (((1,), (1,)), ((), ()))
    dots = None
    for q_part in split3_f32_bf16(qs):
        d_part = jax.lax.dot_general(q_part, vb, dn,
                                     preferred_element_type=jnp.float32)
        dots = d_part if dots is None else dots + d_part
    if metric is MetricType.INNER_PRODUCT:
        return dots
    q_norms = l2norm.l2_norm_squared(queries)
    return 2.0 * dots - q_norms[:, None] - db_norms[None, :]


def direct_l2_scores(queries: jax.Array, db: jax.Array) -> jax.Array:
    """Exact per-pair −‖q−v‖², materializing (nq, nv, d) differences.

    ≈ l2_distance_direct_f16 (shaders/l2_norm_f16.metal:74-123), which the
    reference prefers for nv ≤ 256 for accuracy (no catastrophic cancellation
    from the expanded form). Only for tiny nv.
    """
    diff = queries[:, None, :].astype(jnp.float32) - db[None, :, :].astype(jnp.float32)
    return -jnp.sum(diff * diff, axis=-1)


def mask_scores(scores: jax.Array, ntotal, nv_padded: int) -> jax.Array:
    """−inf out padding columns (ids ≥ ntotal). ntotal may be traced."""
    col = jax.lax.broadcasted_iota(jnp.int32, (1, nv_padded), 1)
    return jnp.where(col < ntotal, scores, -jnp.inf)


def scores_to_distances(scores: jax.Array, metric: MetricType) -> jax.Array:
    """Convert internal max-is-best scores back to user-facing distances."""
    if metric is MetricType.L2:
        return -scores
    return scores
