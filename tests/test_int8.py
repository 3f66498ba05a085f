"""int8 storage mode (beyond the reference's f32/f16/bf16 set).

Contract: search returns the exact top-k of the DECODED database
(v̂ = v_q ∘ scales), certified at runtime like every fused path; plain and
fused agree; results are shard-count invariant (shards share one scale
grid); persistence round-trips the exact codes + scales.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from faiss_tpu import TpuIndexFlat
from faiss_tpu.dtypes import MetricType
from faiss_tpu.ops import pallas_fused

from common import make_data


def _decoded_oracle(idx, xq, k, metric="l2"):
    dec = idx.reconstruct_n(0, idx.ntotal).astype(np.float64)
    s = xq.astype(np.float64) @ dec.T
    if metric == "l2":
        s = 2 * s - (dec ** 2).sum(1)[None, :]
    return np.argsort(-s, axis=1, kind="stable")[:, :k]


def test_train_contract():
    idx = TpuIndexFlat(32, storage="int8")
    assert not idx.is_trained
    x = np.random.default_rng(0).standard_normal((256, 32)).astype(np.float32)
    idx.train(x)
    assert idx.is_trained
    with pytest.raises(RuntimeError):
        idx.train(x)  # scales are frozen
    idx.add(x)
    assert idx.ntotal == 256
    idx.reset()
    assert idx.is_trained  # faiss parity: training survives reset


def test_auto_train_on_first_add():
    x = np.random.default_rng(1).standard_normal((512, 32)).astype(np.float32)
    idx = TpuIndexFlat(32, storage="int8")
    idx.add(x)
    assert idx.is_trained and idx.ntotal == 512


def test_exact_vs_decoded_oracle_and_parity(monkeypatch):
    """Fused == plain == exact top-k of the decoded database, certified."""
    monkeypatch.setattr(pallas_fused, "FUSED_MIN_NV", 8192)  # fused at this nv
    xb, xq = make_data(16384, 8, 64)
    idx = TpuIndexFlat(64, storage="int8")
    idx.add(xb)
    D, I = idx.search(xq, 10)
    assert idx.fused_fallbacks == 0  # int8 certificate is tight
    order = _decoded_oracle(idx, xq, 10)
    np.testing.assert_array_equal(np.asarray(I), order)
    idx.set_force_xla(True)
    D2, I2 = idx.search(xq, 10)
    np.testing.assert_array_equal(np.asarray(I2), np.asarray(I))
    np.testing.assert_allclose(D2, D, rtol=1e-5, atol=1e-4)


def test_inner_product():
    xb, xq = make_data(16384, 8, 64)
    idx = TpuIndexFlat(64, metric="ip", storage="int8")
    idx.add(xb)
    D, I = idx.search(xq, 10)
    dec = idx.reconstruct_n(0, idx.ntotal).astype(np.float64)
    order = np.argsort(-(xq.astype(np.float64) @ dec.T), axis=1,
                       kind="stable")[:, :10]
    np.testing.assert_array_equal(np.asarray(I), order)


def test_recall_on_sift_like_ints():
    """Integer descriptors ≤ 218 with max-based scales quantize with ≤ 1
    unit of rounding — recall vs the unquantized oracle stays high."""
    rng = np.random.default_rng(5)
    xb = np.minimum(np.floor(rng.gamma(0.55, 48.0, (16384, 64))),
                    218.0).astype(np.float32)
    xq = np.minimum(np.floor(rng.gamma(0.55, 48.0, (16, 64))),
                    218.0).astype(np.float32)
    idx = TpuIndexFlat(64, storage="int8")
    idx.add(xb)
    D, I = idx.search(xq, 10)
    s = 2 * (xq.astype(np.float64) @ xb.astype(np.float64).T)
    s -= (xb.astype(np.float64) ** 2).sum(1)[None, :]
    o = np.argsort(-s, axis=1)[:, :10]
    rec = np.mean([len(set(I[i].tolist()) & set(o[i].tolist())) / 10
                   for i in range(16)])
    assert rec >= 0.9, rec


def test_hbm_one_byte_per_element():
    xb, _ = make_data(4096, 1, 128)
    idx = TpuIndexFlat(128, storage="int8")
    idx.add(xb)
    per = idx.store.hbm_bytes() / (idx.store.capacity * idx.store.d_pad)
    assert per <= 1.1, per  # int8 rows + f32 norms/128


def test_io_roundtrip(tmp_path):
    from faiss_tpu import io

    xb, xq = make_data(4096, 8, 48)
    idx = TpuIndexFlat(48, storage="int8")
    idx.add(xb)
    D, I = idx.search(xq, 10)
    p = str(tmp_path / "int8.npz")
    io.save_index(idx, p)
    idx2 = io.load_index(p)
    assert idx2.is_trained and idx2.ntotal == 4096
    D2, I2 = idx2.search(xq, 10)
    np.testing.assert_array_equal(np.asarray(I2), np.asarray(I))
    np.testing.assert_allclose(D2, D, rtol=0, atol=0)  # bit-exact reload
    # codes round-trip exactly
    np.testing.assert_array_equal(
        np.asarray(jax.device_get(idx2.store.db))[:4096],
        np.asarray(jax.device_get(idx.store.db))[:4096])


def test_sharded_matches_single():
    from faiss_tpu.parallel.sharded import ShardedIndexFlat

    xb, xq = make_data(4096, 8, 64)
    sh = ShardedIndexFlat(64, storage="int8", num_shards=4)
    sh.add(xb)
    single = TpuIndexFlat(64, storage="int8")
    single.train(xb)
    single.add(xb)
    D1, I1 = sh.search(xq, 10)
    D2, I2 = single.search(xq, 10)
    np.testing.assert_array_equal(np.asarray(I1), np.asarray(I2))
    np.testing.assert_allclose(D1, D2, rtol=1e-5, atol=1e-4)


def test_sharded_io_roundtrip(tmp_path):
    from faiss_tpu import io
    from faiss_tpu.parallel.sharded import ShardedIndexFlat

    xb, xq = make_data(4096, 8, 64)
    sh = ShardedIndexFlat(64, storage="int8", num_shards=4)
    sh.add(xb)
    D, I = sh.search(xq, 10)
    p = str(tmp_path / "int8s.npz")
    io.save_index(sh, p)
    sh2 = io.load_index(p, sharded=True)
    D2, I2 = sh2.search(xq, 10)
    np.testing.assert_array_equal(np.asarray(I2), np.asarray(I))


def test_fused_search_direct_int8():
    """Direct fused_search call with explicit scales/int_norm_max."""
    xb, xq = make_data(8192, 8, 64)
    s = np.maximum(np.abs(xb).max(axis=0), 1e-12) / 127.0
    sp = np.ones(128, np.float32)
    sp[:64] = s
    q = np.round(np.pad(xb, ((0, 0), (0, 64))) / sp[None, :])
    vq = jnp.asarray(np.clip(q, -127, 127), jnp.int8)
    dec = np.asarray(q * sp[None, :], np.float32)
    norms = jnp.asarray((dec ** 2).sum(1))
    inm = jnp.float32(np.sqrt((q ** 2).sum(1).max()))
    qp = jnp.asarray(np.pad(xq, ((0, 0), (0, 64))))
    vals, ids, cert = pallas_fused.fused_search(
        qp, vq, norms, jnp.int32(8192), k=10, metric=MetricType.L2,
        nv_eff=8192, interpret=True, scales=jnp.asarray(sp),
        int_norm_max=inm,
    )
    so = 2 * (np.asarray(qp, np.float64) @ dec.astype(np.float64).T)
    so -= (dec.astype(np.float64) ** 2).sum(1)[None, :]
    order = np.argsort(-so, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(np.asarray(ids), order)
    # the certificate may be conservative on Gaussian data (int8 query
    # quantization is ~2^-7.8 relative — coarser than the bf16 sweeps);
    # uncertified queries would re-run on the plain path at the index level.
    # It must never be wrong, which the id equality above establishes.
    assert np.asarray(cert).dtype == np.bool_


def test_add_after_search_and_sentinels():
    """Growth after a search recompiles cleanly with frozen scales; k >
    ntotal and empty-index sentinels behave like every other storage."""
    xb, xq = make_data(4096, 4, 32)
    idx = TpuIndexFlat(32, storage="int8")
    D0, I0 = idx.search(xq, 5)          # empty index
    assert (I0 == -1).all() and np.isinf(D0).all()
    idx.add(xb)
    idx.search(xq, 10)
    idx.add(xb[:1000])                  # grow after search (recompile)
    assert idx.ntotal == 5096
    Dk, Ik = idx.search(xq[:2], 6000)   # k > ntotal
    assert (Ik[:, -1] == -1).all()
    got = idx.reconstruct(4096 + 7)
    want = idx.reconstruct(7)           # same source row, same scales
    np.testing.assert_allclose(got, want, rtol=0, atol=0)


def test_concurrent_searches():
    import concurrent.futures as cf

    xb, xq = make_data(16384, 8, 64)
    idx = TpuIndexFlat(64, storage="int8")
    idx.add(xb)
    ref = idx.search(xq, 10)
    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        futs = [pool.submit(idx.search, xq, 10) for _ in range(16)]
        for f in futs:
            D, I = f.result()
            np.testing.assert_array_equal(I, ref[1])
