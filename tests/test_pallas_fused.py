"""Fused-path tests (the sweep kernel runs in interpret mode on CPU; the
compiled kernel is covered by tests/test_gpu_smoke.py on the card —
cross-path consistency is the reference's forced-MPS pattern,
tests/test_metal_distance.mm:233-337).

The fused path = group-max sweep kernel + top-group selection + fp32
gather/rescore (ops/pallas_fused.py). It must match the plain XLA path
(lax.top_k over the full score matrix) exactly for fp32 storage, including
tie-breaking; reduced precision compares against the quantized-db oracle.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from faiss_tpu.dtypes import MetricType
from faiss_tpu.ops import pallas_fused

from common import make_data


def _norms(db):
    return jnp.sum(jnp.asarray(db, jnp.float32) ** 2, axis=-1)


@pytest.mark.parametrize("metric", [MetricType.L2, MetricType.INNER_PRODUCT])
def test_fused_matches_plain(metric):
    xb, xq = make_data(16384, 16, 128)
    db, q = jnp.asarray(xb), jnp.asarray(xq)
    norms = _norms(db)
    vals, ids, cert = pallas_fused.fused_search(
        q, db, norms, jnp.int32(16384), k=10, metric=metric,
        nv_eff=16384, interpret=True,
    )
    s = np.asarray(q, np.float64) @ np.asarray(db, np.float64).T
    if metric is MetricType.L2:
        s = 2 * s - np.asarray(norms, np.float64)[None, :]
    order = np.argsort(-s, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(np.asarray(ids), order)
    np.testing.assert_allclose(
        np.asarray(vals), np.take_along_axis(s, order, 1), rtol=1e-4, atol=1e-4
    )


def test_fused_tie_breaking():
    """Duplicated vectors produce exact score ties; fused selection must
    resolve them to the lowest id like lax.top_k / the oracle."""
    rng = np.random.default_rng(5)
    base = rng.standard_normal((4096, 64)).astype(np.float32)
    xb = np.tile(base, (4, 1))  # every vector appears 4×
    db = jnp.asarray(xb)
    norms = _norms(db)
    q = jnp.asarray(rng.standard_normal((8, 64)).astype(np.float32))
    vals, ids, cert = pallas_fused.fused_search(
        q, db, norms, jnp.int32(xb.shape[0]), k=12, metric=MetricType.L2,
        nv_eff=xb.shape[0], interpret=True,
    )
    s = 2 * (np.asarray(q) @ xb.T) - np.asarray(norms)[None, :]
    sj = jnp.asarray(s)
    vp, ip_ = jax.lax.top_k(sj, 12)
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(ip_))


def test_fused_ntotal_mask():
    xb, xq = make_data(16384, 8, 64)
    db, q = jnp.asarray(xb), jnp.asarray(xq)
    norms = _norms(db)
    nt = 9000
    vals, ids, cert = pallas_fused.fused_search(
        q, db, norms, jnp.int32(nt), k=10, metric=MetricType.L2,
        nv_eff=16384, interpret=True,
    )
    ids = np.asarray(ids)
    assert (ids < nt).all() and (ids >= 0).all()
    s = 2 * (np.asarray(xq) @ xb[:nt].T) - np.asarray(norms)[None, :nt]
    order = np.argsort(-s, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(ids, order)


def test_fused_bf16_storage():
    xb, xq = make_data(16384, 8, 128)
    db16 = jnp.asarray(xb).astype(jnp.bfloat16)
    norms = _norms(db16)  # norms of the QUANTIZED vectors for the oracle
    q = jnp.asarray(xq)
    vals, ids, cert = pallas_fused.fused_search(
        q, db16, norms, jnp.int32(16384), k=10, metric=MetricType.L2,
        nv_eff=16384, interpret=True,
    )
    dbq = np.asarray(db16.astype(jnp.float32), np.float64)
    s = 2 * (np.asarray(xq, np.float64) @ dbq.T) - (dbq ** 2).sum(1)[None, :]
    order = np.argsort(-s, axis=1, kind="stable")[:, :10]
    # fp32 rescore makes the result exact w.r.t. the QUANTIZED database
    np.testing.assert_array_equal(np.asarray(ids)[:, 0], order[:, 0])
    got = set(map(tuple, np.sort(np.asarray(ids), 1)))
    want = set(map(tuple, np.sort(order, 1)))
    assert got == want  # same top-10 sets


def test_fused_index_integration(monkeypatch):
    """TpuIndexFlat dispatches to the fused path and matches force_xla."""
    monkeypatch.setattr(pallas_fused, "FUSED_MIN_NV", 8192)  # fused at this nv
    from faiss_tpu import TpuIndexFlat

    xb, xq = make_data(16384, 8, 64)
    idx = TpuIndexFlat(64)
    idx.add(xb)
    D1, I1 = idx.search(xq, 10)   # fused
    idx.set_force_xla(True)
    D2, I2 = idx.search(xq, 10)   # plain XLA
    np.testing.assert_array_equal(I1, I2)
    np.testing.assert_allclose(D1, D2, rtol=1e-5, atol=1e-4)


def test_eligibility_gate():
    ok = pallas_fused.fused_path_eligible
    # SIFT1M shape: fused wins (score materialization dominates)
    assert ok(metric=MetricType.L2, k=10, nv_eff=1 << 20, d_pad=128)
    # large-k allowed when the gather stays below plain's k-scaled topk cost
    assert ok(metric=MetricType.L2, k=1024, nv_eff=1 << 20, d_pad=128,
              nq_pad=8)
    # large-d small-nv: gather rivals the sweep → plain path
    assert not ok(metric=MetricType.L2, k=10, nv_eff=1 << 16, d_pad=1536,
                  nq_pad=16)
    # k=100 over a modest db with many queries: gather outweighs
    assert not ok(metric=MetricType.L2, k=100, nv_eff=1 << 17, d_pad=768,
                  nq_pad=104)
    # tiny db: plain is already trivial
    assert not ok(metric=MetricType.L2, k=10, nv_eff=1024, d_pad=128)
    # fp32 at d=1536: the 4 B/elem candidate gather exceeds its budget
    assert not ok(metric=MetricType.L2, k=10, nv_eff=1 << 20, d_pad=1536,
                  itemsize=4)


def test_fused_large_k():
    """k = 512 through the fused path (interpret) equals the oracle —
    the regime the reference's block_select silently truncates."""
    xb, xq = make_data(1 << 15, 8, 32)
    db, q = jnp.asarray(xb), jnp.asarray(xq)
    norms = _norms(db)
    k = 512  # kg=516 of 256 groups → degenerates to gather-everything;
    # the production gate routes this shape to the chunked path, but the
    # algorithm itself must stay exact even in the degenerate regime
    vals, ids, cert = pallas_fused.fused_search(
        q, db, norms, jnp.int32(db.shape[0]), k=k, metric=MetricType.L2,
        nv_eff=db.shape[0], interpret=True,
    )
    s = 2 * (np.asarray(xq, np.float64) @ np.asarray(xb, np.float64).T)
    s -= np.asarray(norms, np.float64)[None, :]
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(np.asarray(ids), order)


def test_fused_nq_multiblock():
    """nq > 128 exercises the query grid dimension (multiple q blocks)."""
    xb, xq = make_data(16384, 200, 64)  # nq_pad 200 → 2 q-blocks of 128/72
    db = jnp.asarray(xb)
    norms = _norms(db)
    q = jnp.asarray(np.pad(xq, ((0, 8 - 200 % 8), (0, 0))))  # 208 rows
    vals, ids, cert = pallas_fused.fused_search(
        q, db, norms, jnp.int32(16384), k=10, metric=MetricType.L2,
        nv_eff=16384, interpret=True,
    )
    s = 2 * (np.asarray(q, np.float64) @ xb.astype(np.float64).T)
    s -= np.asarray(norms, np.float64)[None, :]
    order = np.argsort(-s, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(np.asarray(ids), order)


def test_top_groups_hierarchical_equivalence():
    """_top_groups at 64K groups must equal plain lax.top_k including tie
    order (ties injected via rounding), with t = the (kg+1)-th value."""
    from faiss_tpu.ops.pallas_fused import _top_groups

    rng = np.random.default_rng(11)
    ngroups = 1 << 16
    gmax = np.round(rng.standard_normal((4, ngroups)).astype(np.float32), 2)
    gj = jnp.asarray(gmax)
    for kg in (1, 14, 100):
        gidx, t = _top_groups(gj, kg, ngroups)
        got = np.sort(np.asarray(gidx), axis=1)
        wv, want = jax.lax.top_k(gj, kg + 1)
        np.testing.assert_array_equal(
            got, np.sort(np.asarray(want)[:, :kg], axis=1))
        # certificate threshold = max NON-nominated group-max = (kg+1)-th
        np.testing.assert_array_equal(np.asarray(t), np.asarray(wv)[:, kg])


def test_bf16_cross_path_exact(monkeypatch):
    """With the 3-way split everywhere, plain-XLA and fused bf16 paths are
    BOTH fp32-true vs the stored vectors — their ids must agree exactly."""
    monkeypatch.setattr(pallas_fused, "FUSED_MIN_NV", 8192)  # fused at this nv
    from faiss_tpu import TpuIndexFlat

    xb, xq = make_data(16384, 8, 64)
    idx = TpuIndexFlat(64, storage="bf16")
    idx.add(xb)
    D1, I1 = idx.search(xq, 10)   # fused
    idx.set_force_xla(True)
    D2, I2 = idx.search(xq, 10)   # plain
    np.testing.assert_array_equal(I1, I2)
    np.testing.assert_allclose(D1, D2, rtol=1e-6, atol=1e-5)


def test_fused_f16_storage(monkeypatch):
    """f16 storage through the fused path: the bf16 (hi, lo) pair reproduces
    f16 values exactly, so results are the exact top-k of the quantized db."""
    monkeypatch.setattr(pallas_fused, "FUSED_MIN_NV", 8192)  # fused at this nv
    from faiss_tpu import TpuIndexFlat
    from faiss_tpu.storage import split_f32_bf16

    xb, xq = make_data(16384, 8, 64)
    # pair exactness: hi+lo == f16 value, bit for bit
    h, lo = split_f32_bf16(jnp.asarray(xb.astype(np.float16)).astype(jnp.float32))
    rec = np.asarray(h, np.float64) + np.asarray(lo, np.float64)
    np.testing.assert_array_equal(rec.astype(np.float32),
                                  xb.astype(np.float16).astype(np.float32))

    idx = TpuIndexFlat(64, storage="f16")
    idx.add(xb)
    D, I = idx.search(xq, 10)
    dbq = xb.astype(np.float16).astype(np.float64)
    s = 2 * (xq.astype(np.float64) @ dbq.T) - (dbq ** 2).sum(1)[None, :]
    order = np.argsort(-s, axis=1, kind="stable")[:, :10]
    got = set(map(tuple, np.sort(np.asarray(I), 1)))
    want = set(map(tuple, np.sort(order, 1)))
    assert got == want
    np.testing.assert_array_equal(np.asarray(I)[:, 0], order[:, 0])


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("storage", ["f32", "bf16", "f16"])
def test_cross_path_all_configs(metric, storage, monkeypatch):
    """force_xla vs fused for every metric × storage (≈ the reference's
    default-vs-forced-MPS parity tests for L2 AND IP,
    test_metal_distance.mm:233-337). fp32/bf16 agree exactly; f16's plain
    path is single-pass (score precision differs) so compare sets."""
    monkeypatch.setattr(pallas_fused, "FUSED_MIN_NV", 8192)  # fused at this nv
    from faiss_tpu import TpuIndexFlat

    xb, xq = make_data(16384, 8, 64)
    idx = TpuIndexFlat(64, metric=metric, storage=storage)
    idx.add(xb)
    D1, I1 = idx.search(xq, 10)
    idx.set_force_xla(True)
    D2, I2 = idx.search(xq, 10)
    if storage in ("f32", "bf16"):
        np.testing.assert_array_equal(I1, I2)
        np.testing.assert_allclose(D1, D2, rtol=1e-6, atol=1e-5)
    else:
        got = set(map(tuple, np.sort(I1, 1)))
        want = set(map(tuple, np.sort(I2, 1)))
        assert len(got & want) == len(got)  # same sets
        np.testing.assert_array_equal(I1[:, 0], I2[:, 0])


def test_certificate_true_on_random_data():
    """On generic data the margin between the k-th score and the first
    un-nominated group-max dwarfs ε — the certificate must hold (no
    fallback), or the fused path would silently lose its speed."""
    for storage_dtype in (jnp.float32, jnp.bfloat16):
        xb, xq = make_data(16384, 16, 128)
        db = jnp.asarray(xb).astype(storage_dtype)
        norms = jnp.sum(db.astype(jnp.float32) ** 2, axis=-1)
        _, _, cert = pallas_fused.fused_search(
            jnp.asarray(xq), db, norms, jnp.int32(16384), k=10,
            metric=MetricType.L2, nv_eff=16384, interpret=True,
        )
        assert np.asarray(cert).all(), storage_dtype


def test_certificate_fails_on_ties():
    """All-identical rows: every score ties, so exactness cannot be certified
    (k-th rescored == first un-nominated group-max < +ε margin)."""
    rng = np.random.default_rng(7)
    row = rng.standard_normal(128).astype(np.float32)
    xb = np.tile(row, (8192, 1))
    xq = rng.standard_normal((8, 128)).astype(np.float32)
    db = jnp.asarray(xb)
    norms = jnp.sum(db * db, axis=-1)
    _, _, cert = pallas_fused.fused_search(
        jnp.asarray(xq), db, norms, jnp.int32(8192), k=10,
        metric=MetricType.L2, nv_eff=8192, interpret=True,
    )
    assert not np.asarray(cert).any()


def test_fallback_on_uncertified(monkeypatch):
    """Index-level contract: an uncertified fused search transparently
    re-runs on the exact plain path — the user always gets the exact top-k
    (lowest-id tie order), and the fallback counter records it."""
    from faiss_tpu import TpuIndexFlat
    from faiss_tpu.ops import pallas_fused as pf

    monkeypatch.setattr(pf, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)
    rng = np.random.default_rng(9)
    row = rng.standard_normal(64).astype(np.float32)
    xb = np.tile(row, (9000, 1))  # every vector identical
    xq = rng.standard_normal((4, 64)).astype(np.float32)
    idx = TpuIndexFlat(64)
    idx.add(xb)
    D, I = idx.search(xq, 10)
    assert idx.fused_fallbacks == 1
    np.testing.assert_array_equal(I, np.tile(np.arange(10), (4, 1)))
    # async path falls back inside wait() too
    tok = idx.search_async(xq, 10)
    D2, I2 = tok.wait()
    assert idx.fused_fallbacks == 2
    np.testing.assert_array_equal(I2, I)


def test_padding_row_cert_failure_is_not_a_fallback(monkeypatch):
    """Zero-vector PADDING rows (nq..nq_pad) may fail certification without
    consequence — results for real rows are exact and nothing re-runs, so
    fused_fallbacks must not count it (observability fix, 484da5d)."""
    from faiss_tpu import TpuIndexFlat
    from faiss_tpu.ops import pallas_fused as pf

    monkeypatch.setattr(pf, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)
    real_eps = pf._sweep_eps

    def poisoned_eps(queries_f32, *a, **kw):
        eps = real_eps(queries_f32, *a, **kw)
        rows = jnp.arange(queries_f32.shape[0])
        return jnp.where(rows >= 4, jnp.inf, eps)  # only padding rows fail

    monkeypatch.setattr(pf, "_sweep_eps", poisoned_eps)
    xb, xq = make_data(16384, 4, 64)  # nq=4 pads to 8: rows 4..7 poisoned
    # private resources: the poisoned eps is BAKED into the compiled
    # program, and the default resources' fn cache is keyed by shape only —
    # sharing it would poison later same-shape tests
    from faiss_tpu.resources import TpuResources
    idx = TpuIndexFlat(64, resources=TpuResources())
    idx.add(xb)
    D, I = idx.search(xq, 10)
    assert idx.fused_fallbacks == 0
    s = 2 * (xq.astype(np.float64) @ xb.astype(np.float64).T)
    s -= (xb.astype(np.float64) ** 2).sum(1)[None, :]
    order = np.argsort(-s, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(np.asarray(I), order)


def test_no_fallback_on_random(monkeypatch):
    from faiss_tpu import TpuIndexFlat
    from faiss_tpu.ops import pallas_fused as pf

    monkeypatch.setattr(pf, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)
    xb, xq = make_data(16384, 8, 64)
    idx = TpuIndexFlat(64)
    idx.add(xb)
    D, I = idx.search(xq, 10)
    assert idx.fused_fallbacks == 0
    s = 2 * (xq.astype(np.float64) @ xb.astype(np.float64).T)
    s -= (xb.astype(np.float64) ** 2).sum(1)[None, :]
    order = np.argsort(-s, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(np.asarray(I), order)


@pytest.mark.parametrize("metric", [MetricType.L2, MetricType.INNER_PRODUCT])
@pytest.mark.parametrize("kw", [
    {"sweep_passes": 1},
    {"xla_sweep": True},
    {"sweep_passes": 1, "xla_sweep": True},
])
def test_fused_variants_match_default(metric, kw):
    """The single-pass sweep and the plain XLA group-max return the same
    ids as the default fused path (bf16 storage) and still certify on
    random data — the certificate is what licenses the cheaper sweep."""
    rng = np.random.default_rng(11)
    nv, d, nq, k = 4096, 128, 8, 10
    xb = rng.standard_normal((nv, d)).astype(np.float32)
    db = jnp.asarray(xb).astype(jnp.bfloat16)
    norms = _norms(jnp.asarray(xb))
    q = jnp.asarray(rng.standard_normal((nq, d)).astype(np.float32))
    nt = jnp.int32(nv - 37)
    base = pallas_fused.fused_search(
        q, db, norms, nt, k=k, metric=metric, nv_eff=nv, interpret=True)
    v, i, c = pallas_fused.fused_search(
        q, db, norms, nt, k=k, metric=metric, nv_eff=nv, interpret=True, **kw)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(base[1]))
    np.testing.assert_allclose(np.asarray(v), np.asarray(base[0]),
                               rtol=1e-5, atol=1e-5)
    assert bool(np.asarray(c).all())


def test_two_tier_fallback_on_ties(monkeypatch):
    """nq ≥ REDUCED_SWEEP_MIN_NQ routes searches through the reduced
    single-pass sweep; on tie-heavy data BOTH tiers' certificates fail
    (ties are arithmetic-independent) and the result must still be the
    exact plain top-k with lowest-id tie order."""
    from faiss_tpu import TpuIndexFlat
    from faiss_tpu.ops import pallas_fused as pf

    monkeypatch.setattr(pf, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)
    rng = np.random.default_rng(13)
    row = rng.standard_normal(64).astype(np.float32)
    xb = np.tile(row, (9000, 1))
    nq = pf.REDUCED_SWEEP_MIN_NQ  # engages pick_sweep_passes == 1
    xq = rng.standard_normal((nq, 64)).astype(np.float32)
    idx = TpuIndexFlat(64, storage="bf16")  # bf16: the only reduced storage
    idx.add(xb)
    D, I = idx.search(xq, 10)
    assert idx.fused_fallbacks == 1
    np.testing.assert_array_equal(I, np.tile(np.arange(10), (nq, 1)))


def test_adaptive_reduced_sweep_disable(monkeypatch):
    """When the reduced single-pass sweep fails to certify at a shape (its
    RNE error bound exceeds the nomination margin — happens on some
    data/shape combinations), the index must (a) still return the float64-
    oracle exact result via the tiered fallback, and (b) remember the shape
    and route subsequent searches straight to the exact-pair sweep so the
    tier-1 rerun is paid at most once per shape."""
    from faiss_tpu import TpuIndexFlat
    from faiss_tpu.ops import pallas_fused as pf

    monkeypatch.setattr(pf, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)
    nq = pf.REDUCED_SWEEP_MIN_NQ
    xb, xq = make_data(16384, nq, 64)  # margins here fail the 1-pass bound
    idx = TpuIndexFlat(64, storage="bf16")  # bf16: the only reduced storage
    idx.add(xb)
    # oracle = the plain XLA path on an identical index (bf16 ranks by
    # 2·q·v_q − ‖v‖²_prequant; a numpy f64 oracle can't reproduce its exact
    # fp32 scoring at tie granularity, but plain-vs-fused must agree bit-for-bit)
    ref = TpuIndexFlat(64, storage="bf16")
    ref.add(xb)
    ref.set_force_xla(True)
    _, order = ref.search(xq, 10)

    D, I = idx.search(xq, 10)
    np.testing.assert_array_equal(np.asarray(I), order)  # exact regardless
    first = idx.fused_fallbacks
    D2, I2 = idx.search(xq, 10)
    np.testing.assert_array_equal(np.asarray(I2), order)
    if first:  # reduced sweep didn't certify → shape must now be pinned
        assert idx._no_reduced_sweep
        assert idx.fused_fallbacks == first  # no second rerun
    idx.reset()
    assert not idx._no_reduced_sweep


def test_certificate_integer_data_large_k(monkeypatch):
    """SIFT regression: fp32 storage, integer-valued vectors (bf16 splits
    are EXACT: v_lo = 0, residual = 0), k near its gather budget. The
    certificate must pass via the stored exact split statistics
    (storage.split_stats) — the generic 2^-7/2^-15·max‖v‖ envelopes are so
    loose here that every search fell back to the plain path (observed on
    the synthesized SIFT1M file: 78 fallbacks, 10× QPS loss)."""
    from faiss_tpu import TpuIndexFlat
    from faiss_tpu.ops import pallas_fused as pf

    monkeypatch.setattr(pf, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)
    rng = np.random.default_rng(3)
    xb = np.minimum(np.floor(rng.gamma(0.55, 48.0, (16384, 64))),
                    218.0).astype(np.float32)
    xq = np.minimum(np.floor(rng.gamma(0.55, 48.0, (8, 64))),
                    218.0).astype(np.float32)
    idx = TpuIndexFlat(64)
    idx.add(xb)
    assert np.asarray(idx.store.split_stats).max() == 0.0  # ints split exact
    D, I = idx.search(xq, 100)
    assert idx.fused_fallbacks == 0, "certificate must hold on integer data"
    s = 2 * (xq.astype(np.float64) @ xb.astype(np.float64).T)
    s -= (xb.astype(np.float64) ** 2).sum(1)[None, :]
    order = np.argsort(-s, axis=1, kind="stable")[:, :100]
    np.testing.assert_array_equal(np.asarray(I), order)


@pytest.mark.parametrize("metric", [MetricType.L2, MetricType.INNER_PRODUCT])
def test_tie_heavy_kernel_matches_xla_sweep(metric):
    """On tie-heavy data (every row duplicated, ragged ntotal) the sweep
    kernel and the plain XLA group-max must nominate alike: same ids, same
    values and the same per-query certificate."""
    rng = np.random.default_rng(21)
    base = rng.standard_normal((8192, 64)).astype(np.float32)
    xb = np.concatenate([base, base[:8192]])  # every vector twice → ties
    db = jnp.asarray(xb).astype(jnp.bfloat16)
    norms = _norms(db)
    q = jnp.asarray(rng.standard_normal((8, 64)).astype(np.float32))
    nt = jnp.int32(xb.shape[0] - 7)
    kw = dict(k=12, metric=metric, nv_eff=xb.shape[0], interpret=True)
    v1, i1, c1 = pallas_fused.fused_search(q, db, norms, nt, **kw)
    v2, i2, c2 = pallas_fused.fused_search(q, db, norms, nt, xla_sweep=True,
                                           **kw)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))


@pytest.mark.parametrize("seed", range(4))
def test_select_kernel_matches_top_groups(seed):
    """Phase 2 (_top_groups, then the ascending sort fused_search applies)
    must nominate exactly the top-kg groups with ties to the LOWEST group
    id, and return the certificate threshold t = max NON-nominated
    group-max (−inf when every group is nominated)."""
    rng = np.random.default_rng(400 + seed)
    nq = [8, 104, 128, 16][seed]
    ngroups = [128, 7816, 61, 16384][seed]
    kg = [14, 14, 61, 36][seed]  # incl. kg == ngroups (all nominated)
    gm = rng.standard_normal((nq, ngroups)).astype(np.float32)
    if seed % 2:
        gm = np.round(gm, 1)  # many exact ties at the nomination boundary
    gidx, t = pallas_fused._top_groups(jnp.asarray(gm), kg, ngroups)
    order = np.argsort(-gm, axis=1, kind="stable")
    np.testing.assert_array_equal(np.sort(np.asarray(gidx), axis=-1),
                                  np.sort(order[:, :kg], axis=-1))
    rest = np.take_along_axis(gm, order[:, kg:], axis=1)
    want_t = (rest.max(axis=1) if kg < ngroups
              else np.full(nq, -np.inf, np.float32))
    np.testing.assert_array_equal(np.asarray(t), want_t)


def test_selective_per_query_fallback(monkeypatch):
    """VERDICT r3 ask #6: when SOME queries fail certification, only those
    rows are re-run (gathered into a small NQ_PAD-aligned batch) — the
    certified rows keep their fused results without recompute."""
    from faiss_tpu import TpuIndexFlat
    from faiss_tpu.ops import pallas_fused as pf

    monkeypatch.setattr(pf, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)
    # force certificate failure for EXACTLY queries 3 and 17 by inflating
    # their ε to +inf (deterministic, path-independent)
    real_eps = pf._sweep_eps

    def poisoned_eps(queries_f32, *a, **kw):
        eps = real_eps(queries_f32, *a, **kw)
        bad = jnp.zeros((queries_f32.shape[0],), bool
                        ).at[jnp.array([3, 17])].set(True)
        return jnp.where(bad, jnp.inf, eps)

    monkeypatch.setattr(pf, "_sweep_eps", poisoned_eps)
    xb, xq = make_data(16384, 32, 64)
    # private resources: the poisoned eps bakes into the cached program
    # (shape-keyed cache — a same-shape later test would inherit it)
    from faiss_tpu.resources import TpuResources
    idx = TpuIndexFlat(64, resources=TpuResources())
    idx.add(xb)
    reruns = []
    real_run = idx._run_search_fn

    def spy_run(q, k, nq_pad, **kw):
        reruns.append((nq_pad, kw))
        return real_run(q, k, nq_pad, **kw)

    idx._run_search_fn = spy_run
    D, I = idx.search(xq, 10)
    assert idx.fused_fallbacks == 1
    # rerun batches must be the SMALL gathered batch (8 rows for 2 bad
    # queries), never the full 32-row batch
    rerun_shapes = [nqp for nqp, kw in reruns[1:]]
    assert rerun_shapes and all(s == 8 for s in rerun_shapes), reruns
    # results are exact for every row regardless
    s = 2 * (xq.astype(np.float64) @ xb.astype(np.float64).T)
    s -= (xb.astype(np.float64) ** 2).sum(1)[None, :]
    order = np.argsort(-s, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(np.asarray(I), order)


def _sweep_case(storage, nv, d, nq, seed):
    """(positional args, kwargs) of fused_search for one storage mode over
    Gaussian rows (the TRUE stored split stats — fabricated zeros would
    understate eps and certify unsoundly)."""
    from faiss_tpu.storage import (_quantize_int8_fn, encode_f16_bits,
                                   decode_f16_bits, split_f32_bf16,
                                   _split_stats_fn)

    rng = np.random.default_rng(seed)
    xb = rng.standard_normal((nv, d)).astype(np.float32)
    q = jnp.asarray(rng.standard_normal((nq, d)).astype(np.float32))
    xbj = jnp.asarray(xb)
    norms = jnp.sum(xbj * xbj, axis=-1)
    kwargs = {}
    if storage == "bf16":
        args = (q, xbj.astype(jnp.bfloat16), norms, jnp.int32(nv))
    elif storage == "f32":
        hi, lo = split_f32_bf16(xbj)
        stats = _split_stats_fn(jnp.zeros((2,), jnp.float32), xbj, hi, lo)
        args = (q, xbj, norms, jnp.int32(nv))
        kwargs.update(db_split=(hi, lo), split_stats=stats)
    elif storage == "f16":
        bits = encode_f16_bits(xbj)
        v32 = decode_f16_bits(bits)
        hi, lo = split_f32_bf16(v32)
        stats = _split_stats_fn(jnp.zeros((2,), jnp.float32), v32, hi, lo)
        args = (q, bits, norms, jnp.int32(nv))
        kwargs.update(split_stats=stats)
    else:
        scales = jnp.asarray(
            np.maximum(np.abs(xb).max(axis=0) / 127.0, 1e-12), jnp.float32)
        db8, n8, vqmax, _ = _quantize_int8_fn(xbj, scales)
        args = (q, db8, n8, jnp.int32(nv))
        kwargs.update(scales=scales, int_norm_max=vqmax)
    return args, kwargs


@pytest.mark.parametrize("storage", ["bf16", "f32", "f16", "int8"])
def test_xla_tail_matches_full_pallas_sweep(storage):
    """A ragged nv (not a whole number of sweep programs) runs the last
    program over fewer groups. The fused search through the sweep kernel
    (interpret mode) must equal the one through the plain XLA group-max
    (values come from the shared rescore; nomination differences are
    certificate-covered), and both must certify."""
    nv = 16384 + 2048 + 128
    args, kwargs = _sweep_case(storage, nv, 128, 16, 55)
    kwargs.update(k=10, metric=MetricType.L2, nv_eff=nv, interpret=True)
    v1, i1, c1 = pallas_fused.fused_search(*args, **kwargs)
    assert np.asarray(c1).all()
    v2, i2, c2 = pallas_fused.fused_search(*args, xla_sweep=True, **kwargs)
    assert np.asarray(c2).all()
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))


@pytest.mark.parametrize("metric", [MetricType.L2, MetricType.INNER_PRODUCT])
@pytest.mark.parametrize("storage", ["bf16", "f32", "f16", "int8"])
def test_sweep_kernel_matches_xla_groupmax(storage, metric):
    """The sweep kernel (interpret mode) against the plain XLA group-max,
    per storage × metric, on a ragged nv with rows past ntotal masked to
    −inf. Both accumulate the same exact products in f32/int32; only the
    summation order may differ."""
    nv, nq = 4096 + 384, 24
    args, kwargs = _sweep_case(storage, nv, 128, nq, 77)
    q, db, norms, _ = args
    nt = jnp.int32(nv - 200)
    kw = dict(metric=metric, nv_eff=nv, interpret=True,
              scales=kwargs.get("scales"))
    split = kwargs.get("db_split")
    for passes in (1, 2):
        a = np.asarray(pallas_fused.groupmax_scores(
            q, db, norms, nt, split, sweep_passes=passes, **kw))
        b = np.asarray(pallas_fused.groupmax_scores(
            q, db, norms, nt, split, sweep_passes=passes, xla_sweep=True,
            **kw))
        assert a.shape == (nq, nv // 128)
        np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b))
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-6, atol=1e-4)


def test_f32_rescore_matches_oracle():
    """fp32 storage: the rescore gathers the f32 master rows and re-dots
    them at HIGHEST precision, so ids equal the float64 oracle's and every
    query certifies on Gaussian data."""
    from faiss_tpu.storage import split_f32_bf16, _split_stats_fn

    nv, d, nq, k = 32768, 128, 16, 10
    rng = np.random.default_rng(7)
    xb = rng.standard_normal((nv, d)).astype(np.float32)
    q = jnp.asarray(rng.standard_normal((nq, d)).astype(np.float32))
    xbj = jnp.asarray(xb)
    hi, lo = split_f32_bf16(xbj)
    stats = _split_stats_fn(jnp.zeros((2,), jnp.float32), xbj, hi, lo)
    norms = jnp.sum(xbj * xbj, axis=-1)
    v1, i1, c1 = pallas_fused.fused_search(
        q, xbj, norms, jnp.int32(nv), k=k, metric=MetricType.L2, nv_eff=nv,
        interpret=True, db_split=(hi, lo), split_stats=stats)
    assert np.asarray(c1).all()
    s = 2.0 * (np.asarray(q, np.float64) @ xb.astype(np.float64).T)
    s -= (xb.astype(np.float64) ** 2).sum(1)[None, :]
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(np.asarray(i1), order)


def test_final_select_kernel_matches_lax_topk():
    """The final selection (topk.topk_scores: indices-only lax.top_k + a
    value gather) == lax.top_k (values AND tie order) on random data with
    planted duplicates and -inf padding columns."""
    from faiss_tpu.ops import topk as topk_ops

    rng = np.random.default_rng(11)
    s = rng.standard_normal((16, 1792)).astype(np.float32)
    s[:, 100] = s[:, 700] = s[:, 1500]          # planted cross-column ties
    s[:, -64:] = -np.inf                        # masked padding
    s[3, :] = -np.inf                           # fully-masked row
    sj = jnp.asarray(s)
    for k in (1, 10, 32):
        v1, p1 = topk_ops.topk_scores(sj, k)
        v2, p2 = jax.lax.top_k(sj, k)
        np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))
        np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))


@pytest.mark.parametrize("metric", [MetricType.L2, MetricType.INNER_PRODUCT])
def test_hi_exact_bit_identical_on_integer_data(metric):
    """Integer-valued fp32 data (SIFT-like): the exact split statistics are
    zero, and the hi-plane-only program (hi_exact=True) must return results
    BIT-identical to the full pair program — the dropped lo/residual passes
    are exact f32 +0.0s."""
    from faiss_tpu.storage import split_f32_bf16, _split_stats_fn

    rng = np.random.default_rng(7)
    xb = rng.integers(0, 218, (16384, 64)).astype(np.float32)
    xq = rng.standard_normal((16, 64)).astype(np.float32)
    db, q = jnp.asarray(xb), jnp.asarray(xq)
    hi, lo = split_f32_bf16(db)
    stats = _split_stats_fn(jnp.zeros((2,), jnp.float32), db, hi, lo)
    assert tuple(np.asarray(stats)) == (0.0, 0.0)
    norms = _norms(db)
    nt = jnp.int32(16384)
    kw = dict(k=10, metric=metric, nv_eff=16384, interpret=True,
              db_split=(hi, lo), split_stats=stats)
    v0, i0, c0 = pallas_fused.fused_search(q, db, norms, nt, **kw)
    v1, i1, c1 = pallas_fused.fused_search(q, db, norms, nt,
                                           hi_exact=True, **kw)
    np.testing.assert_array_equal(np.asarray(v0), np.asarray(v1))
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
    np.testing.assert_array_equal(np.asarray(c0), np.asarray(c1))
    assert np.asarray(c1).all()  # zero stats → certifies everywhere


def test_hi_exact_index_dispatch_integer_data(monkeypatch):
    """TpuIndexFlat on integer data: split_stats_host reads (0, 0), the
    fused search stays exact vs the plain path, and fallbacks stay 0."""
    monkeypatch.setattr(pallas_fused, "FUSED_MIN_NV", 8192)  # fused at this nv
    from faiss_tpu import TpuIndexFlat

    rng = np.random.default_rng(11)
    xb = rng.integers(0, 218, (20000, 96)).astype(np.float32)
    xq = rng.standard_normal((24, 96)).astype(np.float32)
    idx = TpuIndexFlat(96, metric="l2", storage="f32")
    idx.add(xb)
    assert idx.store.split_stats_host() == (0.0, 0.0)
    D1, I1 = idx.search(xq, 12)
    idx.set_force_xla(True)
    try:
        D2, I2 = idx.search(xq, 12)
    finally:
        idx.set_force_xla(False)
    np.testing.assert_array_equal(I1, I2)
    np.testing.assert_allclose(D1, D2, rtol=1e-6, atol=1e-5)
    assert idx.fused_fallbacks == 0
    # Gaussian rows added later break the zero-stats property: the dispatch
    # must drop hi_exact and stay exact
    idx.add(rng.standard_normal((4096, 96)).astype(np.float32))
    assert idx.store.split_stats_host() != (0.0, 0.0)
    D3, I3 = idx.search(xq, 12)
    idx.set_force_xla(True)
    try:
        D4, I4 = idx.search(xq, 12)
    finally:
        idx.set_force_xla(False)
    np.testing.assert_array_equal(I3, I4)
