"""Index-level integration tests (≈ tests/test_metal_flat.mm).

Coverage map vs the reference suite:
  L2 across d ∈ {32,128,768,1536}      (mm:477-480)   test_l2_dims
  IP metric                            (mm:483)        test_inner_product
  f16/bf16 storage, relaxed tol        (mm:223-268)    test_reduced_precision_storage
  reconstruct precision after f16      (mm:262-265)    test_reconstruct_reduced
  edge nq=1,k=1                        (mm:490)        test_edge_single
  roundtrip cpu↔device                 (mm:132-176)    test_numpy_roundtrip
  reset / re-add                       (mm:178-196)    test_reset_readd
  reconstruct exactness fp32           (mm:198-221)    test_reconstruct_fp32
  async == sync bit-exact              (mm:309-347)    test_async_matches_sync
  3 tokens waited in reverse           (mm:349-401)    test_async_out_of_order
  isReady polling                      (mm:403-437)    test_async_is_ready
  async empty / n=0                    (mm:439-462)    test_empty_and_zero
PLUS coverage the reference is missing (SURVEY.md §2.3.1 / §4 "gap to fix"):
  large-k (k > 32, k = 1024) exact selection, recall@k, k > ntotal sentinels,
  incremental growth across adds, cross-path (chunked vs flat) consistency.
"""

import numpy as np
import pytest

import faiss_tpu
from faiss_tpu import MetricType, StorageType, TpuIndexFlat

from common import compare_results, make_data, numpy_search, recall_at_k


def build(xb, metric="l2", storage="float32"):
    idx = TpuIndexFlat(xb.shape[1], metric=metric, storage=storage)
    idx.add(xb)
    return idx


@pytest.mark.parametrize("d", [32, 128, 768, 1536])
def test_l2_dims(d):
    xb, xq = make_data(2000, 16, d)
    idx = build(xb)
    D, I = idx.search(xq, 10)
    Dr, Ir = numpy_search(xb, xq, 10)
    compare_results(D, I, Dr, Ir, dist_tol=1e-3, k=10, label=f"L2 d={d}")
    assert recall_at_k(I, Ir, 10) == 1.0


def test_inner_product():
    xb, xq = make_data(2000, 16, 128)
    idx = build(xb, metric="ip")
    D, I = idx.search(xq, 10)
    Dr, Ir = numpy_search(xb, xq, 10, metric="ip")
    compare_results(D, I, Dr, Ir, dist_tol=1e-2, k=10, label="IP")
    assert recall_at_k(I, Ir, 10) == 1.0


@pytest.mark.parametrize("storage", ["float16", "bfloat16"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_reduced_precision_storage(storage, metric):
    xb, xq = make_data(2000, 16, 128)
    idx = build(xb, metric=metric, storage=storage)
    D, I = idx.search(xq, 10)
    Dr, Ir = numpy_search(xb, xq, 10, metric=metric)
    compare_results(D, I, Dr, Ir, dist_tol=5e-2, k=10,
                    label=f"{storage} {metric}")
    # reference behavior: top-1 still matches after quantization (README.md:212)
    np.testing.assert_array_equal(I[:, 0], Ir[:, 0])


def test_reconstruct_reduced():
    xb, _ = make_data(500, 1, 64)
    idx = build(xb, storage="float16")
    for key in [0, 13, 499]:
        rec = idx.reconstruct(key)
        # f16 quantization error ≤ 2e-3 per element for N(0,1) data
        # (reference bound: test_metal_flat.mm:262-265)
        assert np.abs(rec - xb[key]).max() < 2e-3


def test_reconstruct_fp32():
    xb, _ = make_data(500, 1, 96)
    idx = build(xb)
    for key in [0, 250, 499]:
        np.testing.assert_array_equal(idx.reconstruct(key), xb[key])
    np.testing.assert_array_equal(idx.reconstruct_n(100, 50), xb[100:150])
    with pytest.raises(IndexError):
        idx.reconstruct(500)


def test_edge_single():
    xb, xq = make_data(1000, 1, 128)
    idx = build(xb)
    D, I = idx.search(xq[0], 1)  # also exercises 1-D query input
    Dr, Ir = numpy_search(xb, xq[:1], 1)
    compare_results(D, I, Dr, Ir, dist_tol=1e-3, k=1, label="nq=1 k=1")


def test_k_greater_than_ntotal():
    xb, xq = make_data(7, 3, 32)
    idx = TpuIndexFlat(32)
    idx.add(xb)
    D, I = idx.search(xq, 20)
    Dr, Ir = numpy_search(xb, xq, 20)
    # ranks 0..6 real, 7..19 sentinels (+inf, −1) — reference mm:384-400
    compare_results(D, I, Dr, Ir, dist_tol=1e-3, k=20, label="k>ntotal")
    assert (I[:, 7:] == -1).all()
    assert np.isinf(D[:, 7:]).all()


def test_empty_and_zero():
    idx = TpuIndexFlat(64)
    D, I = idx.search(np.zeros((4, 64), np.float32), 5)
    assert (I == -1).all() and np.isposinf(D).all()
    tok = idx.search_async(np.zeros((2, 64), np.float32), 3)
    assert tok.is_ready()
    D2, I2 = tok.wait()
    assert (I2 == -1).all() and np.isposinf(D2).all()
    # IP sentinel polarity
    idx_ip = TpuIndexFlat(64, metric="ip")
    D3, _ = idx_ip.search(np.zeros((1, 64), np.float32), 2)
    assert np.isneginf(D3).all()


def test_reset_readd():
    xb, xq = make_data(1000, 8, 64)
    idx = build(xb)
    idx.reset()
    assert idx.ntotal == 0
    xb2 = xb[::-1].copy()
    idx.add(xb2)
    D, I = idx.search(xq, 5)
    Dr, Ir = numpy_search(xb2, xq, 5)
    compare_results(D, I, Dr, Ir, dist_tol=1e-3, k=5, label="reset+readd")


def test_incremental_growth():
    """Amortized-doubling growth across many adds (reference mm:194-219)."""
    rng = np.random.default_rng(7)
    d = 48
    idx = TpuIndexFlat(d)
    chunks = [rng.standard_normal((n, d), dtype=np.float32)
              for n in [100, 900, 37, 2000, 1]]
    for c in chunks:
        idx.add(c)
    xb = np.concatenate(chunks)
    assert idx.ntotal == xb.shape[0]
    xq = rng.standard_normal((8, d), dtype=np.float32)
    D, I = idx.search(xq, 10)
    Dr, Ir = numpy_search(xb, xq, 10)
    compare_results(D, I, Dr, Ir, dist_tol=1e-3, k=10, label="growth")
    # stored data survives growth exactly
    np.testing.assert_array_equal(idx.vectors_numpy(), xb)


def test_large_k_exact():
    """k=1024 must be fully correct — the reference's block_select silently
    truncates to 8 real results (SURVEY.md §2.3.1)."""
    xb, xq = make_data(5000, 4, 64)
    idx = build(xb)
    k = 1024
    D, I = idx.search(xq, k)
    Dr, Ir = numpy_search(xb, xq, k)
    assert recall_at_k(I, Ir, k) == 1.0
    compare_results(D, I, Dr, Ir, dist_tol=1e-3, k=k, label="large-k",
                    check_top1=True)


def test_chunked_path_consistency():
    """Cross-path: chunked streaming top-k vs single-block path must agree
    (≈ forced-MPS vs simdgroup cross-path tests, test_metal_distance.mm:233-337).
    Uses a tiny chunk via a custom resources tuning."""
    import dataclasses

    from faiss_tpu.resources import TpuResources

    xb, xq = make_data(9000, 8, 32)
    res_small = TpuResources()
    caps = res_small._caps
    res_small._caps = dataclasses.replace(
        caps, tuning=dataclasses.replace(caps.tuning, chunk_v=2048)
    )
    idx_chunked = TpuIndexFlat(32, resources=res_small)
    idx_chunked.add(xb)
    idx_flat = TpuIndexFlat(32)
    idx_flat.add(xb)
    k = 50
    Dc, Ic = idx_chunked.search(xq, k)
    Df, If = idx_flat.search(xq, k)
    np.testing.assert_allclose(Dc, Df, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(Ic, If)
    Dr, Ir = numpy_search(xb, xq, k)
    assert recall_at_k(Ic, Ir, k) == 1.0


def test_async_matches_sync():
    xb, xq = make_data(3000, 16, 128)
    idx = build(xb)
    D_s, I_s = idx.search(xq, 10)
    tok = idx.search_async(xq, 10)
    D_a, I_a = tok.wait()
    np.testing.assert_array_equal(D_s, D_a)  # bit-exact (mm:340-345)
    np.testing.assert_array_equal(I_s, I_a)
    # waiting twice returns the same result
    D_b, I_b = tok.wait()
    np.testing.assert_array_equal(D_a, D_b)


def test_async_out_of_order():
    xb, xq = make_data(3000, 12, 64)
    idx = build(xb)
    toks = [idx.search_async(xq[i : i + 4], 5) for i in range(0, 12, 4)]
    # wait in reverse order (reference mm:349-401)
    results = [t.wait() for t in reversed(toks)]
    for j, (D, I) in enumerate(reversed(results)):
        Dr, Ir = numpy_search(xb, xq[4 * j : 4 * j + 4], 5)
        compare_results(D, I, Dr, Ir, dist_tol=1e-3, k=5, label=f"tok{j}")


def test_async_is_ready():
    xb, xq = make_data(2000, 8, 64)
    idx = build(xb)
    tok = idx.search_async(xq, 5)
    for _ in range(10_000):
        if tok.is_ready():
            break
    D, I = tok.wait()
    assert tok.is_ready()
    Dr, Ir = numpy_search(xb, xq, 5)
    compare_results(D, I, Dr, Ir, dist_tol=1e-3, k=5, label="is_ready")


def test_numpy_roundtrip():
    """index_numpy_to_tpu → vectors_numpy round trip (≈ cpu↔metal↔cpu,
    mm:132-176; faiss itself is not in this image, numpy is the interchange)."""
    xb, xq = make_data(1500, 8, 80)
    idx = faiss_tpu.index_numpy_to_tpu(xb)
    np.testing.assert_array_equal(idx.vectors_numpy(), xb)
    idx2 = faiss_tpu.index_numpy_to_tpu(idx.vectors_numpy())
    D1, I1 = idx.search(xq, 10)
    D2, I2 = idx2.search(xq, 10)
    np.testing.assert_array_equal(I1, I2)
    np.testing.assert_array_equal(D1, D2)
    # reduced precision: vectors_numpy unavailable, reconstruct_n is the path
    idx16 = faiss_tpu.index_numpy_to_tpu(xb, storage="float16")
    assert idx16.vectors_numpy() is None
    rec = idx16.reconstruct_n(0, idx16.ntotal)
    assert np.abs(rec - xb).max() < 2e-3


def test_describe():
    idx = TpuIndexFlat(32)
    s = idx.describe()
    assert "TpuIndexFlat" in s and "device_kind" in s


def test_add_device_arrays():
    """jax.Array inputs stay on device (embeddings produced on the accelerator)."""
    import jax.numpy as jnp

    xb, xq = make_data(1500, 8, 64)
    idx = TpuIndexFlat(64)
    idx.add(jnp.asarray(xb[:1000]))
    idx.add(xb[1000:])                  # mix device and host adds
    assert idx.ntotal == 1500
    D, I = idx.search(xq, 10)
    Dr, Ir = numpy_search(xb, xq, 10)
    compare_results(D, I, Dr, Ir, dist_tol=1e-3, k=10, label="device add")
    idx16 = TpuIndexFlat(64, storage="bf16")
    idx16.add(jnp.asarray(xb))
    D2, I2 = idx16.search(xq, 10)
    np.testing.assert_array_equal(I2[:, 0], Ir[:, 0])


def test_concurrent_searches():
    """Searches are thread-safe (the serving pattern bench.py relies on)."""
    import concurrent.futures as cf

    xb, xq = make_data(3000, 8, 64)
    idx = build(xb)
    D0, I0 = idx.search(xq, 10)
    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        futs = [pool.submit(idx.search, xq, 10) for _ in range(32)]
        for f in futs:
            D, I = f.result()
            np.testing.assert_array_equal(I, I0)
            np.testing.assert_array_equal(D, D0)


def test_ntotal_dev_tracks_mutation():
    """The cached device ntotal scalar (storage.DeviceStore.ntotal_dev —
    saves one host→device upload per search on remote-attached devices)
    must be invalidated by every mutation path."""
    import faiss_tpu

    idx = faiss_tpu.TpuIndexFlat(32)
    xb = np.random.default_rng(0).standard_normal((100, 32)).astype(np.float32)
    idx.add(xb)
    assert int(idx.store.ntotal_dev) == 100
    first = idx.store.ntotal_dev
    assert idx.store.ntotal_dev is first  # cached, not re-uploaded
    idx.add(xb[:7])
    assert int(idx.store.ntotal_dev) == 107
    idx.reset()
    assert int(idx.store.ntotal_dev) == 0


def test_assign_chunks_huge_batches():
    """Bulk assign (the IVF add path) must chunk on the host: one 1M-query
    search against a 4096-row table materialized a 16 GB score matrix and
    ran out of device memory. Chunks are enqueued
    async (pipelined through a remote link) and concatenate in order."""
    rng = np.random.default_rng(33)
    xb = rng.standard_normal((2048, 16)).astype(np.float32)
    idx = faiss_tpu.TpuIndexFlat(16)
    idx.add(xb)
    xq = rng.standard_normal((40_000, 16)).astype(np.float32)
    a = idx.assign(xq).ravel()
    qn = (xq ** 2).sum(1)[:, None]
    sc = qn - 2.0 * xq @ xb.T + (xb ** 2).sum(1)[None, :]
    # fp32-vs-f64 near-ties can flip argmin on a handful of rows
    assert (a == sc.argmin(1)).mean() > 0.999
