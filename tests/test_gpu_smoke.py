"""GPU smoke subset: the compiled sweep kernel and the fused path on the
card (interpret-mode tests cannot catch what the GPU compiler refuses).

Marked ``gpu``; every test skips unless JAX's first device is a GPU — the
decision is made in the ``gpu`` fixture at run time, never at import.
chip_smoke.py runs this file on the card in its own process:

    FAISS_TPU_TEST_PLATFORM=gpu python -m pytest -m gpu tests/test_gpu_smoke.py

Shapes mirror a SIFT1M-scale search (nv=1M, d=128, nq=100, k=10); the
oracle is float64 numpy plus the cross-path parity of the reference's
forced-MPS discipline (MetalDistance.mm:121-123).
"""

import numpy as np
import pytest

import jax

NV, D, NQ, K = 1_000_000, 128, 100, 10

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run by chip_smoke.py on the card)")


@pytest.fixture(scope="module")
def data(gpu):
    rng = np.random.default_rng(42)
    xb = rng.standard_normal((NV, D), dtype=np.float32)
    xq = rng.standard_normal((NQ, D), dtype=np.float32)
    # float64 oracle of the f32 ranking convention: top-100 ids by exact
    # distance, the recall denominator (bit-level ids are checked against
    # cross-path parity instead — f32 accumulation legitimately reorders
    # true near-ties)
    s64 = 2.0 * (xq.astype(np.float64) @ xb.astype(np.float64).T)
    s64 -= (xb.astype(np.float64) ** 2).sum(1)[None, :]
    oracle = np.argsort(-s64, axis=1, kind="stable")[:, :100]
    return {"xb": xb, "xq": xq, "s64": s64, "oracle": oracle, "idx": {},
            "rng": rng}


def _index(data, storage):
    from faiss_tpu import TpuIndexFlat

    if storage not in data["idx"]:
        idx = TpuIndexFlat(D, metric="l2", storage=storage)
        idx.add(data["xb"])
        data["idx"][storage] = idx
    return data["idx"][storage]


def _recall(I, oracle, k=K):
    return float(np.mean([
        len(set(I[i, :k]) & set(oracle[i, :k])) / k for i in range(len(I))
    ]))


def _plain(idx, xq, k, **kw):
    idx.set_force_xla(True)
    try:
        return idx.search(xq, k, **kw)
    finally:
        idx.set_force_xla(False)


@pytest.mark.parametrize("storage,min_recall", [
    ("f32", 0.999),   # exact: only f32-accumulation near-tie reorders
    ("bf16", 0.98),   # quantization vs the fp32 oracle
    ("f16", 0.99),
    ("int8", 0.95),
])
def test_fused_search_gpu(data, storage, min_recall):
    """Compiled fused path per storage mode: recall vs the f64 oracle,
    ascending distances, and cross-path (fused vs forced-XLA) parity —
    same top-k SET, same top-1, distances within rtol 1e-5 / atol 1e-4
    (the two paths accumulate in different orders)."""
    idx = _index(data, storage)
    xq = data["xq"]
    D_, I_ = idx.search(xq, K)
    assert I_.shape == (NQ, K) and D_.shape == (NQ, K)
    r = _recall(I_, data["oracle"])
    assert r >= min_recall, (storage, r)
    assert np.all(np.diff(D_, axis=1) >= -1e-5), "distances must ascend"
    D2, I2 = _plain(idx, xq[:8], K)
    for i in range(8):
        assert set(I_[i].tolist()) == set(I2[i].tolist()), (storage, i)
    np.testing.assert_array_equal(I_[:8, 0], I2[:, 0])
    np.testing.assert_allclose(np.sort(D_[:8], 1), np.sort(D2, 1),
                               rtol=1e-5, atol=1e-4)


def test_large_k_gpu(data):
    """k=1024 on bf16: exact set parity with the plain path (the reference
    truncates k > 8·threads; SURVEY §2.3.1 requires exactness at any k)."""
    idx = _index(data, "bf16")
    xq = data["xq"][:8]
    D_, I_ = idx.search(xq, 1024)
    D2, I2 = _plain(idx, xq, 1024)
    for i in range(8):
        assert set(I_[i].tolist()) == set(I2[i].tolist()), i


def test_hi_exact_integer_data_gpu(data):
    """fp32 on integer-valued data (the SIFT1M regime): stored split stats
    are exactly zero, so the hi_exact dispatch sweeps only the hi bf16
    plane — results bit-identical to the forced-XLA fp32 path (integer
    products and sums below 2^24 are exact in any order)."""
    from faiss_tpu import TpuIndexFlat

    rng = data["rng"]
    xb_i = rng.integers(0, 256, (NV, D)).astype(np.float32)
    xq_i = rng.integers(0, 256, (8, D)).astype(np.float32)
    idx = TpuIndexFlat(D, metric="l2", storage="f32")
    idx.add(xb_i)
    assert "hi_exact=True" in idx.describe()
    D_, I_ = idx.search(xq_i, K)
    D2, I2 = _plain(idx, xq_i, K)
    np.testing.assert_array_equal(I_, I2)
    np.testing.assert_array_equal(D_, D2)
    assert idx.fused_fallbacks == 0
    idx.reset()


def test_f16_clean_dispatch_gpu(data):
    """Gaussian data is inf/NaN-free, so f16 storage must engage the lean
    clean-bits in-kernel decode."""
    assert "f16_clean=True" in _index(data, "f16").describe()


def test_certificate_rate_gpu(data):
    """The runtime exactness certificate must hold on the card's
    arithmetic: zero fallbacks across every storage after the searches
    above (Gaussian data certifies at this shape)."""
    total = sum(ix.fused_fallbacks for ix in data["idx"].values())
    assert total == 0, {s: ix.fused_fallbacks
                        for s, ix in data["idx"].items()}


def test_capabilities_compiled_on_gpu(gpu):
    import faiss_tpu

    caps = faiss_tpu.query_device_capabilities()
    assert caps.platform == "gpu" and caps.kernel_mode == "compiled"
    assert not caps.interpret


def test_selector_filtered_search_gpu(data):
    """Filtered search at the headline shape: results must match the f64
    oracle restricted to the admitted rows (top-1 positional + recall)."""
    import faiss_tpu

    idx = _index(data, "f32")
    half = NV // 2
    sel = faiss_tpu.SearchParams(faiss_tpu.IDSelectorRange(0, half))
    D_, I_ = idx.search(data["xq"][:8], K, params=sel)
    assert (I_ < half).all() and (I_ >= 0).all()
    sub = np.argsort(-data["s64"][:8, :half], axis=1, kind="stable")[:, :K]
    np.testing.assert_array_equal(I_[:, 0], sub[:, 0])
    assert _recall(I_, sub) >= 0.999


def test_remove_ids_gpu(data):
    """remove_ids: the compaction gather must leave an index whose searches
    are bit-identical to a fresh index built from the survivors."""
    from faiss_tpu import TpuIndexFlat

    nv = 131_072
    xb, xq = data["xb"][:nv], data["xq"][:8]
    idx = TpuIndexFlat(D, metric="l2", storage="bf16")
    idx.add(xb)
    rm = np.arange(0, nv, 3)
    assert idx.remove_ids(rm) == rm.size
    D_, I_ = idx.search(xq, K)
    keep = np.setdiff1d(np.arange(nv), rm)
    fresh = TpuIndexFlat(D, metric="l2", storage="bf16")
    fresh.add(xb[keep])
    D2, I2 = fresh.search(xq, K)
    np.testing.assert_array_equal(I_, I2)
    np.testing.assert_array_equal(D_, D2)
