"""Filtered search: ID selectors + SearchParams (selector.py).

The reference ACCEPTS a faiss SearchParameters argument and silently
ignores it (src/MetalIndexFlat.mm:313-319); faiss itself honors it
(faiss/impl/IDSelector.h). These tests pin the faiss semantics on every
index class: admitted rows compete exactly as in an index built from them
alone, excluded rows can never appear, fewer-than-k admissible rows
sentinel-fill, and the filtered hit criterion cannot drift from the
unfiltered one (shared `_masked_scores_block`).
"""

import numpy as np
import pytest

import faiss_tpu
from faiss_tpu import (
    IDSelectorAnd,
    IDSelectorBatch,
    IDSelectorMask,
    IDSelectorNot,
    IDSelectorOr,
    IDSelectorRange,
    MetricType,
    SearchParams,
    StorageType,
)

from common import make_data


def oracle_topk(xq, xb, k, metric, admitted):
    """float64 oracle restricted to the admitted positional ids."""
    ids = np.nonzero(admitted)[0]
    if ids.size == 0:
        sent = np.inf if metric is MetricType.L2 else -np.inf
        return (np.full((xq.shape[0], k), sent, np.float32),
                np.full((xq.shape[0], k), -1, np.int64))
    xb64, xq64 = xb[ids].astype(np.float64), xq.astype(np.float64)
    if metric is MetricType.L2:
        d = ((xq64[:, None] - xb64[None]) ** 2).sum(-1)
        order = np.lexsort((np.broadcast_to(ids, d.shape), d), axis=-1)
    else:
        d = xq64 @ xb64.T
        order = np.lexsort((np.broadcast_to(ids, d.shape), -d), axis=-1)
    kk = min(k, ids.size)
    top = order[:, :kk]
    D = np.take_along_axis(d, top, axis=-1).astype(np.float32)
    I = ids[top]
    if kk < k:
        sent = np.inf if metric is MetricType.L2 else -np.inf
        D = np.pad(D, ((0, 0), (0, k - kk)), constant_values=sent)
        I = np.pad(I, ((0, 0), (0, k - kk)), constant_values=-1)
    return D, I


@pytest.mark.parametrize("metric", [MetricType.L2, MetricType.INNER_PRODUCT])
def test_flat_selector_range_matches_restricted_oracle(metric):
    xb, xq = make_data(3000, nq=9, d=24, seed=11)
    ix = faiss_tpu.TpuIndexFlat(24, metric=metric)
    ix.add(xb)
    sel = IDSelectorRange(500, 1500)
    D, I = ix.search(xq, 7, params=SearchParams(sel))
    refD, refI = oracle_topk(xq, xb, 7, metric, (np.arange(3000) >= 500)
                             & (np.arange(3000) < 1500))
    np.testing.assert_array_equal(I, refI)
    np.testing.assert_allclose(D, refD, rtol=1e-5, atol=1e-4)


def test_flat_selector_equals_subindex():
    """Filtered search == searching an index holding only admitted rows."""
    xb, xq = make_data(2000, nq=6, d=16, seed=3)
    admitted = np.zeros(2000, bool)
    admitted[np.random.default_rng(5).choice(2000, 800, replace=False)] = True
    ix = faiss_tpu.TpuIndexFlat(16)
    ix.add(xb)
    D, I = ix.search(xq, 10, params=SearchParams(IDSelectorMask(admitted)))
    sub = faiss_tpu.TpuIndexFlat(16)
    sub.add(xb[admitted])
    Ds, Is = sub.search(xq, 10)
    ids = np.nonzero(admitted)[0]
    np.testing.assert_array_equal(np.where(Is >= 0, ids[Is], -1), I)
    np.testing.assert_allclose(Ds, D, rtol=1e-6, atol=1e-6)


def test_selector_composition_not_and_or():
    xb, xq = make_data(1000, nq=4, d=8, seed=7)
    ix = faiss_tpu.TpuIndexFlat(8)
    ix.add(xb)
    a = IDSelectorRange(0, 600)
    b = IDSelectorBatch(np.arange(400, 1000))
    for sel, mask in [
        (IDSelectorAnd(a, b), (np.arange(1000) < 600) & (np.arange(1000) >= 400)),
        (IDSelectorOr(a, b), np.ones(1000, bool)),
        (IDSelectorNot(a), np.arange(1000) >= 600),
        (a & b, (np.arange(1000) < 600) & (np.arange(1000) >= 400)),
        (a | b, np.ones(1000, bool)),
        (~a, np.arange(1000) >= 600),
    ]:
        D, I = ix.search(xq, 5, params=SearchParams(sel))
        refD, refI = oracle_topk(xq, xb, 5, MetricType.L2, mask)
        np.testing.assert_array_equal(I, refI)


def test_fewer_than_k_admissible_sentinel_fill():
    xb, xq = make_data(500, nq=3, d=8, seed=1)
    ix = faiss_tpu.TpuIndexFlat(8)
    ix.add(xb)
    D, I = ix.search(xq, 8, params=SearchParams(IDSelectorBatch([5, 99, 300])))
    assert set(np.unique(I[:, :3])) <= {5, 99, 300}
    assert (I[:, 3:] == -1).all()
    assert (D[:, 3:] == np.inf).all()
    # empty selector: all sentinels (like searching an empty index)
    D0, I0 = ix.search(xq, 4, params=SearchParams(IDSelectorBatch([])))
    assert (I0 == -1).all() and (D0 == np.inf).all()


def test_all_admitted_is_identical_to_unfiltered():
    xb, xq = make_data(1500, nq=5, d=12, seed=9)
    ix = faiss_tpu.TpuIndexFlat(12)
    ix.add(xb)
    D0, I0 = ix.search(xq, 6)
    D1, I1 = ix.search(xq, 6, params=SearchParams(IDSelectorRange(0, 1500)))
    np.testing.assert_array_equal(I0, I1)
    np.testing.assert_array_equal(D0, D1)
    # SearchParams() with no selector is a no-op too
    D2, I2 = ix.search(xq, 6, params=SearchParams())
    np.testing.assert_array_equal(I0, I2)


def test_bad_params_rejected_loudly():
    """The reference silently ignores params — we must not."""
    xb, xq = make_data(100, nq=2, d=8, seed=0)
    ix = faiss_tpu.TpuIndexFlat(8)
    ix.add(xb)
    with pytest.raises(TypeError):
        ix.search(xq, 3, params={"sel": None})
    with pytest.raises(TypeError):
        SearchParams(sel=[1, 2, 3])
    empty = faiss_tpu.TpuIndexFlat(8)
    with pytest.raises(TypeError):  # validated even on the empty index
        empty.search(xq, 3, params="nope")


def test_flat_range_search_selector():
    xb, xq = make_data(2000, nq=5, d=16, seed=21)
    ix = faiss_tpu.TpuIndexFlat(16)
    ix.add(xb)
    sel = SearchParams(IDSelectorRange(100, 900))
    r = float(np.quantile(((xq[:, None] - xb[None]) ** 2).sum(-1), 0.02))
    lims, D, I = ix.range_search(xq, r, params=sel)
    lims0, D0, I0 = ix.range_search(xq, r)
    assert ((I >= 100) & (I < 900)).all()
    for q in range(5):
        got = set(I[lims[q]:lims[q + 1]])
        want = {i for i in I0[lims0[q]:lims0[q + 1]] if 100 <= i < 900}
        assert got == want


@pytest.mark.parametrize("storage", [StorageType.FLOAT32, StorageType.BFLOAT16,
                                     StorageType.FLOAT16, StorageType.INT8])
def test_selector_every_storage_mode(storage):
    """Filtered == sub-index built from admitted rows, same storage. Sizes
    keep BOTH indexes in the same dispatch class (> the direct-path gate),
    so the plain-path arithmetic — and therefore the results — match
    bit-for-bit even for reduced-precision storage."""
    xb, xq = make_data(4000, nq=4, d=16, seed=13)
    ix = faiss_tpu.TpuIndexFlat(16, storage=storage)
    ix.add(xb)
    admitted = np.arange(4000) % 3 != 0  # 2667 admitted, still > direct gate
    D, I = ix.search(xq, 5, params=SearchParams(IDSelectorMask(admitted)))
    sub = faiss_tpu.TpuIndexFlat(16, storage=storage)
    if storage is StorageType.INT8:
        # the filtered index auto-trained on the FULL set; the sub-index
        # must share that scale grid for identical quantization
        sub.train(xb)
    sub.add(xb[admitted])
    Ds, Is = sub.search(xq, 5)
    ids = np.nonzero(admitted)[0]
    np.testing.assert_array_equal(np.where(Is >= 0, ids[Is], -1), I)
    np.testing.assert_allclose(Ds, D, rtol=1e-6, atol=1e-6)


def test_sharded_selector_matches_flat():
    xb, xq = make_data(4000, nq=6, d=16, seed=31)
    sh = faiss_tpu.ShardedIndexFlat(16, num_shards=4)
    sh.add(xb)
    flat = faiss_tpu.TpuIndexFlat(16)
    flat.add(xb)
    sel = SearchParams(IDSelectorRange(1000, 3000))
    D, I = sh.search(xq, 9, params=sel)
    Df, If = flat.search(xq, 9, params=sel)
    np.testing.assert_array_equal(I, If)
    np.testing.assert_allclose(D, Df, rtol=1e-6, atol=1e-6)
    # range search too
    r = float(np.quantile(((xq[:, None] - xb[None]) ** 2).sum(-1), 0.01))
    lims, RD, RI = sh.range_search(xq, r, params=sel)
    limsf, RDf, RIf = flat.range_search(xq, r, params=sel)
    np.testing.assert_array_equal(lims, limsf)
    np.testing.assert_array_equal(RI, RIf)


def test_sharded_selector_after_remove_ids():
    """Selector ids are CURRENT global ids (post-renumbering)."""
    xb, xq = make_data(3000, nq=4, d=8, seed=17)
    sh = faiss_tpu.ShardedIndexFlat(8, num_shards=4)
    sh.add(xb)
    sh.remove_ids(np.arange(0, 3000, 7))
    flat = faiss_tpu.TpuIndexFlat(8)
    survivors = np.delete(xb, np.arange(0, 3000, 7), axis=0)
    flat.add(survivors)
    sel = SearchParams(IDSelectorRange(200, 1800))
    D, I = sh.search(xq, 6, params=sel)
    Df, If = flat.search(xq, 6, params=sel)
    np.testing.assert_array_equal(I, If)
    np.testing.assert_allclose(D, Df, rtol=1e-6, atol=1e-6)


def test_shards_host_selector_matches_flat():
    xb, xq = make_data(2400, nq=5, d=12, seed=41)
    host = faiss_tpu.IndexShardsHost(
        [faiss_tpu.TpuIndexFlat(12) for _ in range(3)])
    for i in range(0, 2400, 600):
        host.add(xb[i:i + 600])
    flat = faiss_tpu.TpuIndexFlat(12)
    flat.add(xb)
    sel = SearchParams(IDSelectorBatch(np.arange(0, 2400, 2)))
    D, I = host.search(xq, 7, params=sel)
    Df, If = flat.search(xq, 7, params=sel)
    np.testing.assert_array_equal(I, If)
    np.testing.assert_allclose(D, Df, rtol=1e-6, atol=1e-6)


def test_idmap_selector_speaks_custom_ids():
    """faiss IDSelectorTranslated discipline: the selector sees CUSTOM ids."""
    xb, xq = make_data(1000, nq=4, d=8, seed=23)
    im = faiss_tpu.TpuIndexIDMap(faiss_tpu.TpuIndexFlat(8))
    custom = np.arange(1000, dtype=np.int64) * 10 + 1_000_000
    im.add_with_ids(xb, custom)
    # admit custom ids in [1_002_000, 1_005_000) -> positions 200..499
    sel = SearchParams(IDSelectorRange(1_002_000, 1_005_000))
    D, I = im.search(xq, 5, params=sel)
    refD, refI = oracle_topk(xq, xb, 5, MetricType.L2,
                             (np.arange(1000) >= 200) & (np.arange(1000) < 500))
    np.testing.assert_array_equal(I, np.where(refI >= 0, refI * 10 + 1_000_000, -1))
    np.testing.assert_allclose(D, refD, rtol=1e-5, atol=1e-4)
    # async + range_search run the same translation
    D2, I2 = im.search_async(xq, 5, params=sel).wait()
    np.testing.assert_array_equal(I, I2)


def test_selector_search_async_and_large_index_plain_dispatch():
    """A selector on a fused-eligible index must still be exact (it forces
    the plain path) — cover nv > FUSED_MIN_NV and async."""
    xb, xq = make_data(20000, nq=4, d=16, seed=47)
    ix = faiss_tpu.TpuIndexFlat(16, storage=StorageType.BFLOAT16)
    ix.add(xb)
    admitted = np.random.default_rng(2).random(20000) < 0.4
    tok = ix.search_async(xq, 10, params=SearchParams(IDSelectorMask(admitted)))
    D, I = tok.wait()
    sub = faiss_tpu.TpuIndexFlat(16, storage=StorageType.BFLOAT16)
    sub.add(xb[admitted])
    Ds, Is = sub.search(xq, 10)
    ids = np.nonzero(admitted)[0]
    np.testing.assert_array_equal(np.where(Is >= 0, ids[Is], -1), I)


# -- fused filtered search (VERDICT r3 #3: the selector folds into the
#    pre-masked norm stream, so filtered search stays on the fused path) ----

def _force_fused(monkeypatch):
    from faiss_tpu.ops import pallas_fused as pf
    monkeypatch.setattr(pf, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)


@pytest.mark.parametrize("storage", [StorageType.FLOAT32, StorageType.BFLOAT16,
                                     StorageType.FLOAT16, StorageType.INT8])
def test_fused_filtered_matches_plain_cross_path(storage, monkeypatch):
    """Filtered results must be IDENTICAL between the fused kernels and the
    forced-plain path (the forceMPS-style differential) and must equal the
    sub-index of admitted rows, for every storage mode."""
    _force_fused(monkeypatch)
    xb, xq = make_data(16384, nq=6, d=32, seed=61)
    admitted = np.random.default_rng(8).random(16384) < 0.6
    params = SearchParams(IDSelectorMask(admitted))
    ix = faiss_tpu.TpuIndexFlat(32, storage=storage)
    ix.add(xb)
    D, I = ix.search(xq, 10, params=params)
    ix.set_force_xla(True)
    Dp, Ip = ix.search(xq, 10, params=params)
    np.testing.assert_array_equal(I, Ip)
    # ids exact; values last-ulp-close across paths (the rescore's batched
    # dot may round differently from the plain matmul on the CPU backend).
    # f16: the plain path's 4-pass pair GEMM drops the ~2^-16 query-split
    # residual that the fused rescore's exact 3-way split keeps, so values
    # agree to ~2^-16 relative, not to the ulp.
    tol = 1e-4 if storage is StorageType.FLOAT16 else 1e-6
    np.testing.assert_allclose(D, Dp, rtol=tol, atol=tol)
    # excluded rows can never appear
    assert not np.isin(I[I >= 0], np.nonzero(~admitted)[0]).any()
    # sub-index equivalence (same storage → same quantization class)
    sub = faiss_tpu.TpuIndexFlat(32, storage=storage)
    if storage is StorageType.INT8:
        sub.train(xb)  # share the frozen scale grid
    sub.add(xb[admitted])
    sub.set_force_xla(True)
    Ds, Is = sub.search(xq, 10)
    ids = np.nonzero(admitted)[0]
    np.testing.assert_array_equal(np.where(Is >= 0, ids[Is], -1), I)
    np.testing.assert_allclose(Ds, D, rtol=tol, atol=tol)


@pytest.mark.parametrize("metric", [MetricType.L2, MetricType.INNER_PRODUCT])
def test_fused_filtered_both_metrics_oracle(metric, monkeypatch):
    _force_fused(monkeypatch)
    xb, xq = make_data(12288, nq=5, d=24, seed=67)
    admitted = np.arange(12288) % 4 != 1
    ix = faiss_tpu.TpuIndexFlat(24, metric=metric)
    ix.add(xb)
    D, I = ix.search(xq, 8, params=SearchParams(IDSelectorMask(admitted)))
    refD, refI = oracle_topk(xq, xb, 8, metric, admitted)
    np.testing.assert_array_equal(I, refI)
    np.testing.assert_allclose(D, refD, rtol=1e-5, atol=1e-4)


def test_fused_filtered_fewer_than_k_sentinel_fill(monkeypatch):
    """< k admitted rows on the fused path: all finite groups are nominated,
    the certificate threshold is -inf (trivially certified), sentinels fill
    the tail — no fallback burned."""
    _force_fused(monkeypatch)
    xb, xq = make_data(16384, nq=4, d=16, seed=71)
    keep = [3, 4444, 12001]
    ix = faiss_tpu.TpuIndexFlat(16)
    ix.add(xb)
    D, I = ix.search(xq, 8, params=SearchParams(IDSelectorBatch(keep)))
    assert ix.fused_fallbacks == 0
    assert set(np.unique(I[:, :3])) <= set(keep)
    assert (I[:, 3:] == -1).all() and (D[:, 3:] == np.inf).all()
    # all rows excluded: sentinels everywhere, still certified
    D0, I0 = ix.search(xq, 5, params=SearchParams(IDSelectorBatch([])))
    assert (I0 == -1).all() and (D0 == np.inf).all()
    assert ix.fused_fallbacks == 0


def test_fused_filtered_fallback_keeps_filtering(monkeypatch):
    """A certificate failure under a selector must re-run WITH the selector:
    duplicated admitted rows force near-ties (uncertifiable nomination), and
    the exact rerun must still exclude the filtered rows."""
    _force_fused(monkeypatch)
    rng = np.random.default_rng(19)
    row = rng.standard_normal(64).astype(np.float32)
    xb = np.tile(row, (9000, 1))  # every vector identical -> cert fails
    xq = rng.standard_normal((4, 64)).astype(np.float32)
    from faiss_tpu.resources import TpuResources
    ix = faiss_tpu.TpuIndexFlat(64, resources=TpuResources())
    ix.add(xb)
    admitted = np.arange(9000) % 2 == 0  # even ids only
    D, I = ix.search(xq, 10, params=SearchParams(IDSelectorMask(admitted)))
    assert ix.fused_fallbacks >= 1
    # exact filtered top-k of identical rows = lowest ADMITTED ids
    np.testing.assert_array_equal(I, np.tile(np.arange(0, 20, 2), (4, 1)))


def test_sharded_fused_filtered_matches_flat(monkeypatch):
    _force_fused(monkeypatch)
    xb, xq = make_data(32768, nq=8, d=16, seed=73)
    sh = faiss_tpu.ShardedIndexFlat(16, num_shards=4)
    sh.add(xb)
    flat = faiss_tpu.TpuIndexFlat(16)
    flat.add(xb)
    sel = SearchParams(IDSelectorRange(5000, 28000))
    D, I = sh.search(xq, 9, params=sel)
    Df, If = flat.search(xq, 9, params=sel)
    np.testing.assert_array_equal(I, If)
    np.testing.assert_allclose(D, Df, rtol=1e-6, atol=1e-6)
    refD, refI = oracle_topk(xq, xb, 9, MetricType.L2,
                             (np.arange(32768) >= 5000)
                             & (np.arange(32768) < 28000))
    np.testing.assert_array_equal(If, refI)
