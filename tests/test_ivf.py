"""IVF-Flat index (ivf.py — faiss::IndexIVFFlat parity, beyond the
reference's flat-only surface).

Oracle: a numpy IVF simulation that probes the SAME lists (assignments
come from the index's own quantizer, so coarse routing is identical by
construction) and computes float64 distances within them. Integer-valued
data makes fp32 distances exact, so result equality is exact, not
recall-bounded. Exhaustive equivalence: nprobe == nlist must reproduce
TpuIndexFlat's result sets.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import faiss_tpu
from faiss_tpu import MetricType, TpuIndexIVFFlat

from common import make_data


def int_data(nv, nq, d, seed=0, lo=0, hi=32):
    rng = np.random.default_rng(seed)
    xb = rng.integers(lo, hi, (nv, d)).astype(np.float32)
    xq = rng.integers(lo, hi, (nq, d)).astype(np.float32)
    return xb, xq


def ivf_oracle(index, xb, xq, k, nprobe):
    """Probe the same lists as the index, score in float64."""
    assign = index.quantizer.assign(xb).ravel()
    cents = np.zeros((index.nlist, index.d), np.float32)
    for j in range(index.nlist):
        cents[j] = index.quantizer.reconstruct(j)
    cq = ((xq.astype(np.float64)[:, None] - cents[None]) ** 2).sum(-1)
    probe = np.argsort(cq, axis=1, kind="stable")[:, :nprobe]
    D = np.full((len(xq), k), np.inf)
    I = np.full((len(xq), k), -1, np.int64)
    for qi in range(len(xq)):
        cand = np.nonzero(np.isin(assign, probe[qi]))[0]
        if cand.size == 0:
            continue
        d2 = ((xq[qi].astype(np.float64) - xb[cand].astype(np.float64)) ** 2
              ).sum(-1)
        order = np.lexsort((cand, d2))[:k]
        D[qi, : len(order)] = d2[order]
        I[qi, : len(order)] = cand[order]
    return D, I


def test_untrained_add_raises():
    ix = TpuIndexIVFFlat(16, 4)
    with pytest.raises(RuntimeError):
        ix.add(np.zeros((10, 16), np.float32))
    with pytest.raises(RuntimeError):
        ix.search(np.zeros((2, 16), np.float32), 3)
    with pytest.raises(ValueError):
        TpuIndexIVFFlat(16, 4, storage="f16")  # f16 is flat-index-only


def test_ivf_matches_numpy_oracle_exactly_on_integer_data():
    xb, xq = int_data(4000, 8, 16, seed=1)
    ix = TpuIndexIVFFlat(16, 16, nprobe=4, seed=3)
    ix.train(xb)
    ix.add(xb)
    D, I = ix.search(xq, 5)
    refD, refI = ivf_oracle(ix, xb, xq, 5, 4)
    # integer data -> fp32 distances are exact -> per-row sets must match
    for qi in range(8):
        assert set(I[qi]) == set(refI[qi]), qi
    got = np.sort(np.where(np.isinf(D), np.inf, D), axis=1)
    want = np.sort(refD, axis=1)
    np.testing.assert_allclose(got[~np.isinf(want)], want[~np.isinf(want)])


def test_nprobe_full_equals_flat():
    xb, xq = make_data(3000, nq=6, d=24)
    ix = TpuIndexIVFFlat(24, 8, nprobe=8, seed=2)
    ix.train(xb)
    ix.add(xb)
    D, I = ix.search(xq, 10)
    flat = faiss_tpu.TpuIndexFlat(24)
    flat.add(xb)
    Df, If = flat.search(xq, 10)
    for qi in range(6):  # near-tie order may differ across paths: sets
        assert set(I[qi]) == set(If[qi]), qi
    np.testing.assert_allclose(np.sort(D, 1), np.sort(Df, 1),
                               rtol=1e-5, atol=1e-4)


def test_recall_increases_with_nprobe():
    xb, xq = make_data(8000, nq=16, d=32, seed=5)
    ix = TpuIndexIVFFlat(32, 32, seed=7)
    ix.train(xb)
    ix.add(xb)
    flat = faiss_tpu.TpuIndexFlat(32)
    flat.add(xb)
    _, If = flat.search(xq, 10)
    recalls = []
    for npb in (1, 4, 32):
        ix.nprobe = npb
        _, I = ix.search(xq, 10)
        recalls.append(np.mean([
            len(set(I[q]) & set(If[q])) / 10 for q in range(16)]))
    assert recalls[0] <= recalls[1] <= recalls[2] + 1e-9, recalls
    assert recalls[2] >= 0.999, recalls  # nprobe=nlist is exhaustive
    assert recalls[1] >= 0.5, recalls    # sane mid-probe recall


def test_batched_add_equals_single_add():
    xb, xq = int_data(2000, 5, 8, seed=9)
    a = TpuIndexIVFFlat(8, 8, nprobe=3, seed=1)
    a.train(xb)
    a.add(xb)
    b = TpuIndexIVFFlat(8, 8, nprobe=3, seed=1)
    b.train(xb)
    for i in range(0, 2000, 300):  # uneven batches force cap growth
        b.add(xb[i: i + 300])
    assert a.ntotal == b.ntotal == 2000
    Da, Ia = a.search(xq, 7)
    Db, Ib = b.search(xq, 7)
    for qi in range(5):
        assert set(Ia[qi]) == set(Ib[qi]), qi
    np.testing.assert_allclose(np.sort(Da, 1), np.sort(Db, 1))


def test_reconstruct_reset_and_observability():
    xb, _ = make_data(500, nq=1, d=16, seed=11)
    ix = TpuIndexIVFFlat(16, 4, seed=5)
    ix.train(xb)
    ix.add(xb)
    np.testing.assert_allclose(ix.reconstruct(123), xb[123], rtol=1e-6)
    with pytest.raises(IndexError):
        ix.reconstruct(500)
    assert ix.list_sizes().sum() == 500
    assert "nlist=4" in ix.describe()
    ix.reset()
    assert ix.ntotal == 0 and ix.is_trained  # quantizer survives reset
    D, I = ix.search(xb[:2], 3)
    assert (I == -1).all()
    ix.add(xb[:100])  # add-after-reset works
    assert ix.ntotal == 100


def test_bf16_storage_mode():
    xb, xq = int_data(3000, 6, 16, seed=13, hi=16)  # small ints: bf16-exact
    ix = TpuIndexIVFFlat(16, 8, nprobe=8, storage="bf16", seed=3)
    ix.train(xb)
    ix.add(xb)
    flat = faiss_tpu.TpuIndexFlat(16, storage="bf16")
    flat.add(xb)
    D, I = ix.search(xq, 5)
    Df, If = flat.search(xq, 5)
    for qi in range(6):
        assert set(I[qi]) == set(If[qi]), qi
    np.testing.assert_allclose(np.sort(D, 1), np.sort(Df, 1), rtol=1e-6)


@pytest.mark.filterwarnings("ignore::UserWarning")  # tiny train set on purpose
def test_sentinels_when_probed_lists_have_too_few():
    xb, xq = make_data(64, nq=3, d=8, seed=15)
    ix = TpuIndexIVFFlat(8, 16, nprobe=1, seed=9, train_niter=4)
    ix.train(xb)
    ix.add(xb)
    D, I = ix.search(xq, 20)  # k > any single list
    assert (I[:, -1] == -1).all()
    assert (D[I == -1] == np.inf).all()
    valid = I >= 0
    assert valid.any()


def test_ivf_selector_matches_subindex_routing():
    """Filtered IVF == oracle restricted to admitted rows WITHIN the same
    probed lists (exact on integer data)."""
    from faiss_tpu import IDSelectorRange, SearchParams

    xb, xq = int_data(4000, 6, 16, seed=21)
    ix = TpuIndexIVFFlat(16, 16, nprobe=16, seed=3)  # exhaustive probe
    ix.train(xb)
    ix.add(xb)
    sel = SearchParams(IDSelectorRange(1000, 3000))
    D, I = ix.search(xq, 5, params=sel)
    assert ((I >= 1000) & (I < 3000)).all()
    flat = faiss_tpu.TpuIndexFlat(16)
    flat.add(xb)
    Df, If = flat.search(xq, 5, params=sel)
    for qi in range(6):  # exhaustive probe + integer data: same sets
        assert set(I[qi]) == set(If[qi]), qi
    # all-admitted == unfiltered
    D0, I0 = ix.search(xq, 5)
    D1, I1 = ix.search(xq, 5, params=SearchParams(IDSelectorRange(0, 4000)))
    np.testing.assert_array_equal(I0, I1)


def test_ivf_range_search_exhaustive_equals_flat():
    xb, xq = int_data(3000, 5, 16, seed=23)
    ix = TpuIndexIVFFlat(16, 8, nprobe=8, seed=5)  # nprobe == nlist
    ix.train(xb)
    ix.add(xb)
    flat = faiss_tpu.TpuIndexFlat(16)
    flat.add(xb)
    d2 = ((xq.astype(np.float64)[:, None]
           - xb.astype(np.float64)[None]) ** 2).sum(-1)
    rad = float(np.quantile(d2, 5e-3))
    lims, D, I = ix.range_search(xq, rad)
    limsf, Df, If = flat.range_search(xq, rad)
    np.testing.assert_array_equal(lims, limsf)
    np.testing.assert_array_equal(I, If)  # integer data: exact order too
    np.testing.assert_array_equal(D, Df)


def test_ivf_range_search_partial_probe_subset():
    """nprobe < nlist: hits are exactly the flat hits whose rows live in
    the probed lists (faiss IVF completeness semantics)."""
    xb, xq = int_data(3000, 4, 16, seed=25)
    ix = TpuIndexIVFFlat(16, 16, nprobe=3, seed=7)
    ix.train(xb)
    ix.add(xb)
    d2 = ((xq.astype(np.float64)[:, None]
           - xb.astype(np.float64)[None]) ** 2).sum(-1)
    rad = float(np.quantile(d2, 2e-2))
    lims, D, I = ix.range_search(xq, rad)
    refD, refI = ivf_oracle(ix, xb, xq, 3000, 3)  # big k = all hits ranked
    for qi in range(4):
        want = {int(i) for i, dd in zip(refI[qi], refD[qi])
                if i >= 0 and dd < rad}
        assert set(I[lims[qi]:lims[qi + 1]].tolist()) == want, qi


def test_ivf_remove_ids_stable_renumber():
    xb, xq = int_data(2500, 5, 16, seed=27)
    ix = TpuIndexIVFFlat(16, 8, nprobe=8, seed=9)
    ix.train(xb)
    ix.add(xb)
    rm = np.arange(0, 2500, 4)
    assert ix.remove_ids(rm) == rm.size
    assert ix.ntotal == 2500 - rm.size
    keep = np.setdiff1d(np.arange(2500), rm)
    # fresh index on survivors, SAME quantizer -> same routing
    fresh = TpuIndexIVFFlat(16, 8, nprobe=8, seed=9)
    fresh._set_centroids(np.stack([
        ix.quantizer.reconstruct(j) for j in range(8)]))
    fresh.add(xb[keep])
    D1, I1 = ix.search(xq, 7)
    D2, I2 = fresh.search(xq, 7)
    np.testing.assert_array_equal(I1, I2)
    np.testing.assert_array_equal(D1, D2)
    np.testing.assert_array_equal(ix.list_sizes(), fresh.list_sizes())
    # reconstruct follows the renumbering
    np.testing.assert_allclose(ix.reconstruct(0), xb[keep[0]])
    # remove everything -> empty but trained
    ix.remove_ids(np.arange(ix.ntotal))
    assert ix.ntotal == 0 and ix.is_trained


def test_ivf_nprobe_param_override():
    """params.nprobe (faiss SearchParametersIVF) overrides the ctor width
    per call; nprobe=nlist override on a narrow index == exhaustive."""
    from faiss_tpu import SearchParametersIVF, SearchParams

    xb, xq = int_data(3000, 5, 16, seed=31)
    ix = TpuIndexIVFFlat(16, 16, nprobe=1, seed=11)
    ix.train(xb)
    ix.add(xb)
    flat = faiss_tpu.TpuIndexFlat(16)
    flat.add(xb)
    D1, I1 = ix.search(xq, 6, params=SearchParametersIVF(nprobe=16))
    Df, If = flat.search(xq, 6)
    for qi in range(5):
        assert set(I1[qi]) == set(If[qi]), qi
    # the ctor width is untouched and still used without params
    assert ix.nprobe == 1
    D0, I0 = ix.search(xq, 6)
    assert (I0 != I1).any()  # nprobe=1 on 16 lists differs somewhere
    # range_search honors it too
    d2 = ((xq.astype(np.float64)[:, None]
           - xb.astype(np.float64)[None]) ** 2).sum(-1)
    rad = float(np.quantile(d2, 5e-3))
    lims, D, I = ix.range_search(xq, rad, params=SearchParams(nprobe=16))
    limsf, Df_, If_ = flat.range_search(xq, rad)
    np.testing.assert_array_equal(lims, limsf)
    np.testing.assert_array_equal(I, If_)
    with pytest.raises(ValueError):
        SearchParams(nprobe=0)


def test_flat_rejects_nprobe_param():
    from faiss_tpu import SearchParams

    xb, xq = int_data(300, 2, 8, seed=33)
    flat = faiss_tpu.TpuIndexFlat(8)
    flat.add(xb)
    with pytest.raises(ValueError, match="nprobe"):
        flat.search(xq, 3, params=SearchParams(nprobe=4))
    with pytest.raises(ValueError, match="nprobe"):
        flat.range_search(xq, 10.0, params=SearchParams(nprobe=4))


def test_idmap_forwards_nprobe_to_ivf():
    from faiss_tpu import SearchParametersIVF, TpuIndexIDMap

    xb, xq = int_data(2000, 4, 16, seed=35)
    ix = TpuIndexIVFFlat(16, 8, nprobe=1, seed=13)
    ix.train(xb)
    m = TpuIndexIDMap(ix)
    ids = np.arange(2000, dtype=np.int64) * 7 + 3
    m.add_with_ids(xb, ids)
    D, I = m.search(xq, 5, params=SearchParametersIVF(nprobe=8))
    flat = faiss_tpu.TpuIndexFlat(16)
    flat.add(xb)
    Df, If = flat.search(xq, 5)
    for qi in range(4):
        assert set(I[qi]) == set(ids[If[qi]]), qi


def test_ivf_io_roundtrip_after_remove(tmp_path):
    """save/load after remove_ids: the dense renumbering and per-list
    compaction survive bit-exactly (vectors saved in insertion-id order)."""
    xb, xq = int_data(1500, 4, 16, seed=37)
    ix = TpuIndexIVFFlat(16, 8, nprobe=8, seed=15)
    ix.train(xb)
    ix.add(xb)
    ix.remove_ids(np.arange(0, 1500, 3))
    p = str(tmp_path / "ivf_rm.npz")
    faiss_tpu.save_index(ix, p)
    ix2 = faiss_tpu.load_index(p)
    assert ix2.ntotal == ix.ntotal
    D1, I1 = ix.search(xq, 6)
    D2, I2 = ix2.search(xq, 6)
    np.testing.assert_array_equal(I1, I2)
    np.testing.assert_array_equal(D1, D2)
    np.testing.assert_array_equal(ix.list_sizes(), ix2.list_sizes())
    for j in (0, ix.ntotal - 1):
        np.testing.assert_array_equal(ix.reconstruct(j), ix2.reconstruct(j))


# -- int8 inverted lists (VERDICT r3 #6: 1 B/elem — the flat index's int8
#    contract reused: frozen per-dim scales, decoded norms, exact distances
#    vs the decoded database) -------------------------------------------------

def test_int8_storage_exhaustive_matches_flat_int8():
    """nprobe == nlist int8 IVF == flat int8 index sharing the same frozen
    scale grid (both train on the full set): same decoded database, same
    ranking contract — result sets must match with close distances."""
    xb, xq = int_data(3000, 6, 16, seed=29, hi=64)
    ix = TpuIndexIVFFlat(16, 8, nprobe=8, storage="int8", seed=3)
    ix.train(xb)
    ix.add(xb)
    flat = faiss_tpu.TpuIndexFlat(16, storage="int8")
    flat.train(xb)
    flat.add(xb)
    D, I = ix.search(xq, 5)
    Df, If = flat.search(xq, 5)
    for qi in range(6):
        assert set(I[qi]) == set(If[qi]), qi
    np.testing.assert_allclose(np.sort(D, 1), np.sort(Df, 1),
                               rtol=1e-5, atol=1e-4)
    assert "int8_clipped_fraction" in ix.describe()


def test_int8_ivf_oracle_on_decoded_database():
    """Partial probe: results equal the float64 IVF oracle evaluated on the
    DECODED rows (the int8 ranking contract) with the same probed lists."""
    xb, xq = int_data(4000, 5, 24, seed=31, hi=100)
    ix = TpuIndexIVFFlat(24, 16, nprobe=4, storage="int8", seed=7)
    ix.train(xb)
    ix.add(xb)
    dec = np.stack([ix.reconstruct(i) for i in range(0, 4000, 997)])
    # reconstruct decodes through the scales: codes * s
    sc = np.maximum(np.abs(xb).max(axis=0) / 127.0, 1e-12)
    want = np.clip(np.round(xb[::997] / sc), -127, 127) * sc
    np.testing.assert_allclose(dec, want.astype(np.float32), rtol=1e-6)
    xb_dec = (np.clip(np.round(xb / sc), -127, 127) * sc).astype(np.float32)
    D, I = ix.search(xq, 6)
    refD, refI = ivf_oracle_on(ix, xb_dec, xq, 6, 4)
    np.testing.assert_array_equal(I, refI)
    ok = refI >= 0
    np.testing.assert_allclose(D[ok], refD[ok], rtol=1e-4, atol=1e-3)


def ivf_oracle_on(index, xb_scored, xq, k, nprobe):
    """ivf_oracle but scoring a caller-supplied (decoded) database while
    routing by the index's own assignment of the ORIGINAL rows."""
    return ivf_oracle(index, xb_scored, xq, k, nprobe)


def test_int8_ivf_io_roundtrip(tmp_path):
    from faiss_tpu import io as ft_io

    xb, xq = int_data(2000, 4, 16, seed=37, hi=200)
    ix = TpuIndexIVFFlat(16, 8, nprobe=3, storage="int8", seed=5)
    ix.train(xb)
    ix.add(xb)
    p = str(tmp_path / "ivf_int8.npz")
    ft_io.save_index(ix, p)
    back = ft_io.load_index(p)
    D0, I0 = ix.search(xq, 5)
    D1, I1 = back.search(xq, 5)
    np.testing.assert_array_equal(I0, I1)   # bit-exact reload (same codes)
    np.testing.assert_array_equal(D0, D1)
    assert back.storage_type.value == "int8"


def test_int8_ivf_untrained_add_raises():
    ix = TpuIndexIVFFlat(16, 4, storage="int8")
    assert not ix.is_trained
    with pytest.raises(RuntimeError):
        ix.add(np.zeros((10, 16), np.float32))


# -- async tokens (VERDICT r3 #5: the fine scan is one jitted program —
#    stop blocking on device_get) --------------------------------------------

def test_ivf_search_async_matches_sync():
    xb, xq = int_data(3000, 6, 16, seed=41)
    ix = TpuIndexIVFFlat(16, 8, nprobe=4, seed=3)
    ix.train(xb)
    ix.add(xb)
    toks = [ix.search_async(xq, 5), ix.search_async(xq, 7)]
    D0, I0 = ix.search(xq, 5)
    D1, I1 = toks[0].wait()          # waited out of order is fine
    np.testing.assert_array_equal(I0, I1)
    np.testing.assert_array_equal(D0, D1)
    D2, I2 = toks[1].wait()
    assert I2.shape == (6, 7) and I2.dtype == np.int64
    assert toks[0].is_ready() and toks[1].is_ready()
    # empty index resolves immediately
    empty = TpuIndexIVFFlat(16, 8, seed=3)
    empty.train(xb)
    tok = empty.search_async(xq, 4)
    assert tok.is_ready()
    De, Ie = tok.wait()
    assert (Ie == -1).all() and (De == np.inf).all()


def test_chunked_gather_on_skewed_lists():
    """r4 two-level gather: one huge list + many tiny ones — results stay
    exact (vs the same-routing oracle) and the static chunk budget follows
    the actual occupancy, not nlist x cap."""
    from faiss_tpu.ivf import _chunk_budget, _CHUNK

    rng = np.random.default_rng(43)
    # build clusterable data where one cluster holds ~70% of rows
    n = 6000
    comp = np.where(rng.random(n) < 0.7, 0, rng.integers(1, 16, n))
    cents = 30.0 * rng.standard_normal((16, 12)).astype(np.float32)
    xb = (cents[comp] + rng.standard_normal((n, 12))).astype(np.float32)
    xq = (cents[rng.integers(0, 16, 5)]
          + rng.standard_normal((5, 12))).astype(np.float32)
    ix = TpuIndexIVFFlat(12, 16, nprobe=3, seed=9)
    # install the TRUE component centers as centroids: component 0 holds
    # ~70% of rows, so list 0 is guaranteed huge (k-means would have split
    # it — the point here is the gather's behavior under skew)
    ix._set_centroids(cents)
    ix.add(xb)
    sizes = ix.list_sizes()
    assert sizes.max() > 4 * np.median(sizes[sizes > 0])  # genuinely skewed
    D, I = ix.search(xq, 6)
    refD, refI = ivf_oracle(ix, xb, xq, 6, 3)
    for qi in range(5):
        got = set(I[qi][I[qi] >= 0].tolist())
        want = set(refI[qi][refI[qi] >= 0].tolist())
        assert got == want, qi
    # budget arithmetic: worst probe set, quantized <= 25% slack
    chunk = _CHUNK
    ccnt = -(-sizes // chunk)
    exact = int(np.sort(ccnt)[-3:].sum())
    b = _chunk_budget(sizes, 3, chunk)
    assert exact <= b <= max(4, int(exact * 1.25) + 1), (exact, b)
    # exhaustive probe on the skewed index == flat
    ix.nprobe = 16
    Df, If = ix.search(xq, 6)
    flat = faiss_tpu.TpuIndexFlat(12)
    flat.add(xb)
    D2, I2 = flat.search(xq, 6)
    for qi in range(5):
        assert set(If[qi].tolist()) == set(I2[qi].tolist()), qi


def test_idmap_ivf_async():
    """TpuIndexIDMap over an IVF index forwards search_async (IVF tokens
    are r4; the wrapper's custom-id translation rides token.wait)."""
    xb, xq = int_data(1500, 4, 16, seed=47)
    ivf = TpuIndexIVFFlat(16, 8, nprobe=8, seed=3)
    ivf.train(xb)
    im = faiss_tpu.TpuIndexIDMap(ivf)
    custom = np.arange(1500, dtype=np.int64) * 3 + 500
    im.add_with_ids(xb, custom)
    D0, I0 = im.search(xq, 5)
    D1, I1 = im.search_async(xq, 5).wait()
    np.testing.assert_array_equal(I0, I1)
    assert ((I0 - 500) % 3 == 0).all()


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_merge_from(storage):
    """IVF merge_from: the merged index equals one built by the same add
    sequence (faiss::IndexIVF::merge_from; routing transfers bit-exactly —
    no fp32 re-assignment), and the source is emptied."""
    xb, xq = int_data(3000, 6, 16, seed=61)
    a = TpuIndexIVFFlat(16, 8, nprobe=8, storage=storage, seed=3)
    a.train(xb)
    a.add(xb[:1800])
    b = TpuIndexIVFFlat(16, 8, nprobe=8, storage=storage, seed=3)
    b.quantizer = None
    if storage == "int8":
        b._scales = a._scales
    b._set_centroids(
        np.stack([a.quantizer.reconstruct(j) for j in range(8)]),
        quantizer=a.quantizer)
    b.add(xb[1800:])
    a.merge_from(b)
    assert a.ntotal == 3000 and b.ntotal == 0
    one = TpuIndexIVFFlat(16, 8, nprobe=8, storage=storage, seed=3)
    one.quantizer = None
    if storage == "int8":
        one._scales = a._scales
    one._set_centroids(
        np.stack([a.quantizer.reconstruct(j) for j in range(8)]),
        quantizer=a.quantizer)
    one.add(xb)
    Dm, Im = a.search(xq, 7)
    Do, Io = one.search(xq, 7)
    np.testing.assert_array_equal(Im, Io)
    np.testing.assert_array_equal(Dm, Do)
    # reconstruct survives the merge (id order = insertion order)
    np.testing.assert_allclose(a.reconstruct(2999), one.reconstruct(2999))


def test_merge_from_mismatch_raises():
    xb, _ = int_data(200, 2, 16, seed=62)
    a = TpuIndexIVFFlat(16, 4, seed=3)
    a.train(xb)
    b = TpuIndexIVFFlat(16, 8, seed=3)  # different nlist
    b.train(xb)
    with pytest.raises(ValueError):
        a.merge_from(b)
    with pytest.raises(ValueError):
        a.merge_from(a)


def test_coarse_assign_matches_quantizer():
    """add()'s on-device coarse router (one padded transfer + argmax) must
    route every row exactly like the quantizer's own flat search — integer
    data makes fp32 scores exact, so equality is exact, ties low-id."""
    xb, _ = int_data(3000, 1, 16, seed=71)
    ix = TpuIndexIVFFlat(16, 16, seed=3)
    ix.train(xb)
    xd, assign = ix._coarse_assign(xb)
    ref = ix.quantizer.assign(xb).ravel()
    np.testing.assert_array_equal(assign, ref)
    assert xd.shape == (xd.shape[0], ix.d_pad) and xd.shape[0] >= 3000


def test_ivf_batch_split_matches_unsplit(monkeypatch):
    """Oversized query batches split on the gather-budget query cap
    (ADVICE r4: the full-batch gate hard-errored batches that used to run)
    and the ConcatSearchToken reassembles results bit-identically."""
    from faiss_tpu import ivf as ivf_mod
    from faiss_tpu.index import ConcatSearchToken

    xb, xq = int_data(4000, 24, 16, seed=77)
    ix = TpuIndexIVFFlat(16, 16, nprobe=4, seed=3)
    ix.train(xb)
    ix.add(xb)
    D0, I0 = ix.search(xq, 5)
    nbudget = ivf_mod._chunk_budget(ix._counts, 4, ivf_mod._CHUNK)
    # budget sized for exactly one 8-query block per dispatch -> 3 chunks
    monkeypatch.setattr(ivf_mod, "_GATHER_BUDGET",
                        nbudget * ivf_mod._CHUNK * 4 * 8)
    assert ix._nq_cap(4) == 8
    tok = ix.search_async(xq, 5)
    assert isinstance(tok, ConcatSearchToken)
    D1, I1 = tok.wait()
    assert tok.is_ready()
    np.testing.assert_array_equal(I0, I1)
    np.testing.assert_array_equal(D0, D1)
    # blocking search splits the same way (it rides search_async)
    D2, I2 = ix.search(xq, 5)
    np.testing.assert_array_equal(I0, I2)


@pytest.mark.parametrize("storage", ["bf16", "int8"])
def test_dense_fused_route_matches_xla_dense(storage, monkeypatch):
    """nprobe == nlist rides the flat fused program over the pool prefix.
    Forcing the route on a small pool (the size gate is about speed, not
    correctness): results
    must be exhaustive-exact — bit-equal to the XLA dense program on
    integer data — through the full token/cert/fallback plumbing."""
    from faiss_tpu import ivf as ivf_mod

    xb, xq = int_data(4000, 16, 16, seed=91)
    ix = TpuIndexIVFFlat(16, 8, nprobe=8, storage=storage, seed=3)
    ix.train(xb)
    ix.add(xb)
    out_xla, _ = ix._search_device(xq, 7, force_xla_dense=True)
    Dx, Ix = np.asarray(out_xla[0]), np.asarray(out_xla[1])
    monkeypatch.setattr(TpuIndexIVFFlat, "_dense_fused_ok",
                        lambda self, nsweep: True)
    tok = ix.search_async(xq, 7)
    D, I = tok.wait()
    np.testing.assert_array_equal(I, Ix[: len(xq)])
    np.testing.assert_allclose(D, Dx[: len(xq)], rtol=1e-6, atol=1e-6)
    # flat exhaustive parity (the nprobe == nlist contract)
    flat = faiss_tpu.TpuIndexFlat(16, storage=storage)
    if storage == "int8":
        flat.train(xb)
    flat.add(xb)
    _, If = flat.search(xq, 7)
    for qi in range(len(xq)):
        assert set(I[qi]) == set(If[qi]), qi


def test_dense_fused_selector_and_removals(monkeypatch):
    """Dense-fused masking: holes from remove_ids and selector-filtered
    rows mask out of the fused pool sweep exactly like padding."""
    from faiss_tpu import SearchParams, IDSelectorRange

    xb, xq = int_data(3000, 8, 16, seed=93)
    ix = TpuIndexIVFFlat(16, 4, nprobe=4, storage="bf16", seed=3)
    ix.train(xb)
    ix.add(xb)
    ix.remove_ids(np.arange(100, 400))
    monkeypatch.setattr(TpuIndexIVFFlat, "_dense_fused_ok",
                        lambda self, nsweep: True)
    params = SearchParams(IDSelectorRange(0, 1500))
    D, I = ix.search(xq, 5, params=params)
    out_xla, _ = ix._search_device(xq, 5, params=params,
                                   force_xla_dense=True)
    np.testing.assert_array_equal(I, np.asarray(out_xla[1])[: len(xq)])
    assert ((I >= 0) & (I < 1500)).all()


def test_balanced_training_caps_skew():
    """balance=2.0 (the default) splits oversized clusters at train time so
    the fine scan's static chunk budget (_chunk_budget: sum of the nprobe
    FATTEST lists) stops paying the k-means skew tax (1M mixture
    max list 9.5x mean). Skewed mixture: the balanced quantizer's max
    occupancy must come out well under the raw one, search must stay exact
    vs the probed-list oracle, and balance=0 must restore raw behavior."""
    rng = np.random.default_rng(5)
    ncomp, d, k, n = 64, 16, 16, 8000
    cents = rng.integers(-8, 8, (ncomp, d)).astype(np.float32) * 4
    w = rng.dirichlet(np.full(ncomp, 0.25))
    comp = rng.choice(ncomp, n, p=w)
    xb = cents[comp] + rng.integers(-1, 2, (n, d))
    xb = xb.astype(np.float32)
    xq = xb[rng.choice(n, 24, replace=False)] + 1.0

    raw = TpuIndexIVFFlat(d, k, nprobe=4, seed=3, balance=0)
    bal = TpuIndexIVFFlat(d, k, nprobe=4, seed=3)  # default balance=2.0
    for ix in (raw, bal):
        ix.train(xb)
        ix.add(xb)
    craw = raw.list_sizes()
    cbal = bal.list_sizes()
    assert craw.sum() == cbal.sum() == n
    # the balanced max should drop decisively toward the cap (the train
    # sample and the added rows are the same distribution here)
    assert cbal.max() < craw.max()
    assert cbal.max() <= 3.0 * n / k  # cap 2x + add-time drift headroom
    # exactness within probed lists is routing-independent
    D, I = bal.search(xq, 5)
    Do, Io = ivf_oracle(bal, xb, xq, 5, 4)
    np.testing.assert_array_equal(I, Io)
    np.testing.assert_array_equal(D, Do)


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_chunk_scan_kernel_matches_xla_scan(storage):
    """The gather route's chunk-scan kernel (interpret mode here) and the
    plain XLA take + batched-dot scan return the same ids and (to f32
    summation order) the same distances, with a selector and removals
    masking slots."""
    from faiss_tpu import ivf as ivf_mod

    rng = np.random.default_rng(5)
    xb = rng.standard_normal((3000, 40)).astype(np.float32)
    xq = rng.standard_normal((13, 40)).astype(np.float32)
    ix = TpuIndexIVFFlat(40, 16, nprobe=5, storage=storage, seed=2)
    ix.train(xb)
    ix.add(xb)
    ix.remove_ids(np.arange(0, 3000, 7))
    sel = np.zeros(ix.npool * ivf_mod._CHUNK, bool)
    sel[ix._slot_of[: ix.ntotal // 2]] = True
    qp, nq, nq_pad, nprobe, nbudget, _ = ix._prep_search(xq, None)
    outs = []
    for xla_scan in (False, True):
        fn = ivf_mod._build_ivf_search_fn(
            nlist=16, nprobe=nprobe, nq_pad=nq_pad, k=6, d_pad=ix.d_pad,
            metric=ix.metric, kind=ix._kind, nbudget=nbudget,
            with_sel=True, interpret=True, xla_scan=xla_scan)
        outs.append(fn(ix._data, ix._norms, ix._counts_dev, ix._ids,
                       ix._ctable, ix._cents, ix._cnorms, jnp.asarray(qp),
                       jnp.asarray(sel), ix._scales, ix._int8_qn))
    (d0, i0), (d1, i1) = outs
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
    np.testing.assert_allclose(np.asarray(d0), np.asarray(d1),
                               rtol=1e-5, atol=1e-4)
    assert (np.asarray(i0)[:nq] < ix.ntotal // 2).all()
