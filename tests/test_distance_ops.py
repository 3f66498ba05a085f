"""Op/kernel-level unit tests (≈ tests/test_metal_distance.mm).

Coverage map:
  l2_norm vs CPU d=128 / d=1536 large path  (mm:17-96)  test_l2_norm
  full L2 matrix vs O(nq·nv·d) reference    (mm:98-156) test_l2_matrix
  IP matrix + top-1 argmax parity           (mm:158-230) test_ip_matrix
  cross-path consistency direct vs GEMM     (mm:233-337) test_direct_vs_matmul
"""

import jax.numpy as jnp
import numpy as np
import pytest

from faiss_tpu.dtypes import MetricType
from faiss_tpu.ops import distance, l2norm, topk

from common import make_data


@pytest.mark.parametrize("d", [128, 1536])
def test_l2_norm(d):
    xb, _ = make_data(300, 1, d)
    got = np.asarray(l2norm.l2_norm_squared(jnp.asarray(xb)))
    ref = (xb.astype(np.float64) ** 2).sum(1)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_l2_norm_bf16_accumulates_fp32():
    xb, _ = make_data(64, 1, 2048)
    got = np.asarray(l2norm.l2_norm_squared(jnp.asarray(xb, jnp.bfloat16)))
    assert got.dtype == np.float32
    ref = (xb.astype(np.float64) ** 2).sum(1)
    np.testing.assert_allclose(got, ref, rtol=3e-2)  # bf16 products


def test_l2_matrix():
    xb, xq = make_data(400, 24, 64)
    norms = l2norm.l2_norm_squared(jnp.asarray(xb))
    s = distance.matmul_scores(
        jnp.asarray(xq), jnp.asarray(xb), norms, MetricType.L2
    )
    ref = -(
        ((xq.astype(np.float64)[:, None] - xb.astype(np.float64)[None]) ** 2)
        .sum(-1)
    )
    # expanded-form L2 in fp32 has ~1e-3 rel error vs the f64 direct oracle
    # (the reference uses 5e-2 for this same test, test_metal_distance.mm:151)
    np.testing.assert_allclose(np.asarray(s), ref, rtol=5e-3, atol=5e-3)


def test_ip_matrix():
    xb, xq = make_data(400, 24, 64)
    s = distance.matmul_scores(
        jnp.asarray(xq), jnp.asarray(xb), None, MetricType.INNER_PRODUCT
    )
    ref = xq.astype(np.float64) @ xb.astype(np.float64).T
    np.testing.assert_allclose(np.asarray(s), ref, rtol=1e-4, atol=1e-4)
    # top-1 argmax parity (reference mm:210-230)
    np.testing.assert_array_equal(
        np.asarray(s).argmax(1), np.asarray(ref).argmax(1)
    )


def test_direct_vs_matmul():
    xb, xq = make_data(200, 16, 48)
    nb, nq_ = jnp.asarray(xb), jnp.asarray(xq)
    s_direct = np.asarray(distance.direct_l2_scores(nq_, nb))
    s_gemm = np.asarray(
        distance.matmul_scores(nq_, nb, l2norm.l2_norm_squared(nb), MetricType.L2)
    )
    np.testing.assert_allclose(s_direct, s_gemm, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(s_direct.argmax(1), s_gemm.argmax(1))


def test_merge_topk():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 8)).astype(np.float32)
    b = rng.standard_normal((5, 12)).astype(np.float32)
    va, ia = topk.topk_scores(jnp.asarray(a), 8)
    vb, ib = topk.topk_scores(jnp.asarray(b), 12)
    mv, mi = topk.merge_topk(va, ia, vb, ib + 100, 10)
    allv = np.concatenate([a, b], axis=1)
    ref = -np.sort(-allv, axis=1)[:, :10]
    np.testing.assert_allclose(np.asarray(mv), ref, rtol=1e-6)
    # ids map back into the right half-space
    mi = np.asarray(mi)
    assert ((mi < 8) | (mi >= 100)).all()


def test_chunked_topk_exact():
    rng = np.random.default_rng(1)
    nq, nv, k, chunk = 6, 4096, 37, 512
    scores = rng.standard_normal((nq, nv)).astype(np.float32)
    sj = jnp.asarray(scores)

    def score_fn(start):
        return jnp.asarray(jnp.take(sj, jnp.arange(chunk) + start, axis=1))

    import jax

    def score_fn(start):  # dynamic slice version usable under fori_loop
        return jax.lax.dynamic_slice_in_dim(sj, start, chunk, axis=1)

    v, i = topk.chunked_topk_scores(score_fn, nv, chunk, k)
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    ref_v = np.take_along_axis(scores, order, axis=1)
    np.testing.assert_allclose(np.asarray(v), ref_v, rtol=1e-6)
    # values at returned ids must equal returned values (ids are valid)
    np.testing.assert_allclose(
        np.take_along_axis(scores, np.asarray(i), axis=1), np.asarray(v),
        rtol=1e-6,
    )


def test_bf16_matmul_scores_fp32_true():
    """bf16-db scores from matmul_scores must be fp32-exact w.r.t. the
    quantized vectors (exact 3-way query split)."""
    xb, xq = make_data(2048, 8, 96)
    db16 = jnp.asarray(xb).astype(jnp.bfloat16)
    norms = jnp.sum(db16.astype(jnp.float32) ** 2, -1)
    s = distance.matmul_scores(jnp.asarray(xq), db16, norms, MetricType.L2)
    dbq = np.asarray(db16.astype(jnp.float32), np.float64)
    ref = 2 * (xq.astype(np.float64) @ dbq.T) - (dbq ** 2).sum(1)[None, :]
    ref -= (xq.astype(np.float64) ** 2).sum(1)[:, None]
    np.testing.assert_allclose(np.asarray(s), ref, rtol=1e-6, atol=1e-5)


def test_profiler_trace_smoke(tmp_path):
    """utils.trace context manager works (jax.profiler hook)."""
    from faiss_tpu.utils import trace

    with trace(str(tmp_path)):
        _ = jnp.sum(jnp.ones((8, 8))).block_until_ready()


def test_fused_large_k_blocked_final_select_parity():
    """k=1024 fused search (the final selection runs over 131k candidate
    columns) == plain path result SETS on a fused-forced index."""
    import faiss_tpu
    from faiss_tpu.ops import pallas_fused as pf

    orig = pf.fused_path_eligible
    pf.fused_path_eligible = lambda **kw: kw["nv_eff"] >= 8192
    try:
        xb, xq = make_data(140000, 8, 32, seed=77)
        idx = faiss_tpu.TpuIndexFlat(32, storage="bf16")
        idx.add(xb)
        D, I = idx.search(xq, 1024)   # kg=1028 -> s width 131k
        assert idx.fused_fallbacks == 0
        # cross-path (plain XLA): SET parity per row — near-tie ranks may
        # legitimately swap across accumulation orders (smoke-suite contract)
        idx.set_force_xla(True)
        Dp, Ip = idx.search(xq, 1024)
        for i in range(len(I)):
            assert set(I[i].tolist()) == set(Ip[i].tolist()), i
        np.testing.assert_allclose(np.sort(D, 1), np.sort(Dp, 1),
                                   rtol=1e-5, atol=1e-4)
    finally:
        pf.fused_path_eligible = orig
