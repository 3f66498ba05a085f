"""Sharded multi-device search tests (8 emulated CPU devices, SURVEY.md §4).

No reference counterpart — faiss-metal is single-device. Acceptance:
the sharded index must return the SAME results as the single-device index
(and the numpy oracle), including global int64 ids, for any add pattern.
"""

import numpy as np
import pytest

import jax

from faiss_tpu import ShardedIndexFlat, TpuIndexFlat

from common import compare_results, make_data, numpy_search, recall_at_k

NDEV = len(jax.devices())


@pytest.fixture(autouse=True)
def require_multi_device():
    assert NDEV >= 2, "conftest must provide emulated multi-device CPU"


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_sharded_matches_oracle(metric):
    xb, xq = make_data(5000, 16, 64)
    idx = ShardedIndexFlat(64, metric=metric)
    idx.add(xb)
    assert idx.num_shards == NDEV
    D, I = idx.search(xq, 10)
    Dr, Ir = numpy_search(xb, xq, 10, metric=metric)
    tol = 1e-3 if metric == "l2" else 1e-2
    compare_results(D, I, Dr, Ir, dist_tol=tol, k=10, label=f"sharded {metric}")
    assert recall_at_k(I, Ir, 10) == 1.0


def test_sharded_matches_single_device():
    xb, xq = make_data(4000, 8, 96)
    sharded = ShardedIndexFlat(96)
    sharded.add(xb)
    single = TpuIndexFlat(96)
    single.add(xb)
    Ds, Is = sharded.search(xq, 10)
    D1, I1 = single.search(xq, 10)
    np.testing.assert_array_equal(Is, I1)
    np.testing.assert_allclose(Ds, D1, rtol=1e-5, atol=1e-5)


def test_sharded_incremental_adds():
    rng = np.random.default_rng(3)
    d = 32
    idx = ShardedIndexFlat(d)
    chunks = [rng.standard_normal((n, d), dtype=np.float32)
              for n in [5, 100, 1, 3000, 17]]
    for c in chunks:
        idx.add(c)
    xb = np.concatenate(chunks)
    assert idx.ntotal == xb.shape[0]
    xq = rng.standard_normal((6, d), dtype=np.float32)
    D, I = idx.search(xq, 20)
    Dr, Ir = numpy_search(xb, xq, 20)
    compare_results(D, I, Dr, Ir, dist_tol=1e-3, k=20, label="sharded adds",
                    check_top1=True)
    assert recall_at_k(I, Ir, 20) == 1.0


def test_sharded_k_greater_than_ntotal():
    xb, xq = make_data(5, 2, 16)  # fewer rows than shards → empty shards
    idx = ShardedIndexFlat(16)
    idx.add(xb)
    D, I = idx.search(xq, 12)
    Dr, Ir = numpy_search(xb, xq, 12)
    compare_results(D, I, Dr, Ir, dist_tol=1e-3, k=12, label="sharded k>n")
    assert (I[:, 5:] == -1).all()


def test_sharded_empty():
    idx = ShardedIndexFlat(16)
    D, I = idx.search(np.zeros((3, 16), np.float32), 4)
    assert (I == -1).all() and np.isposinf(D).all()


def test_sharded_large_k():
    xb, xq = make_data(4000, 4, 32)
    idx = ShardedIndexFlat(32)
    idx.add(xb)
    k = 512
    D, I = idx.search(xq, k)
    Dr, Ir = numpy_search(xb, xq, k)
    assert recall_at_k(I, Ir, k) == 1.0


def test_sharded_reduced_precision():
    xb, xq = make_data(3000, 8, 64)
    idx = ShardedIndexFlat(64, storage="bfloat16")
    idx.add(xb)
    D, I = idx.search(xq, 10)
    Dr, Ir = numpy_search(xb, xq, 10)
    compare_results(D, I, Dr, Ir, dist_tol=5e-2, k=10, label="sharded bf16")
    np.testing.assert_array_equal(I[:, 0], Ir[:, 0])


def test_sharded_reconstruct_and_reset():
    xb, _ = make_data(100, 1, 24)
    idx = ShardedIndexFlat(24)
    idx.add(xb)
    for key in [0, 57, 99]:
        np.testing.assert_array_equal(idx.reconstruct(key), xb[key])
    idx.reset()
    assert idx.ntotal == 0
    idx.add(xb[:10])
    np.testing.assert_array_equal(idx.reconstruct(3), xb[3])


def test_sharded_fused_path(monkeypatch):
    """Per-shard Pallas fused kernel (interpret on CPU) must agree with the
    single-device index and the oracle when shards are big enough to cross
    the fused gate (nv_eff >= FUSED_MIN_NV per shard)."""
    from faiss_tpu.ops import pallas_fused

    monkeypatch.setattr(pallas_fused, "FUSED_MIN_NV", 8192)  # small shards
    from faiss_tpu.ops.pallas_fused import FUSED_MIN_NV

    nv = NDEV * (FUSED_MIN_NV + 600)
    xb, xq = make_data(nv, 4, 32)
    idx = ShardedIndexFlat(32)
    idx.add(xb)
    D, I = idx.search(xq, 10)
    single = TpuIndexFlat(32)
    single.add(xb)
    D1, I1 = single.search(xq, 10)
    np.testing.assert_array_equal(I, I1)
    np.testing.assert_allclose(D, D1, rtol=1e-5, atol=1e-5)
    Dr, Ir = numpy_search(xb, xq, 10)
    assert recall_at_k(I, Ir, 10) == 1.0


@pytest.mark.parametrize("nreplicas", [2, 4])
def test_query_replicas(nreplicas):
    """2-D mesh: DB replicated over replica groups, queries split across
    them. Results must equal the 1-D sharded index and the oracle."""
    if NDEV % nreplicas or NDEV // nreplicas < 2:
        pytest.skip("need a divisible multi-device mesh")
    xb, xq = make_data(3000, 13, 48)  # odd nq exercises replica padding
    idx_r = ShardedIndexFlat(48, num_replicas=nreplicas)
    assert idx_r.num_shards == NDEV // nreplicas
    idx_r.add(xb)
    D_r, I_r = idx_r.search(xq, 10)
    idx_1 = ShardedIndexFlat(48)
    idx_1.add(xb)
    D_1, I_1 = idx_1.search(xq, 10)
    np.testing.assert_array_equal(I_r, I_1)
    np.testing.assert_allclose(D_r, D_1, rtol=1e-5, atol=1e-5)
    Dr, Ir = numpy_search(xb, xq, 10)
    assert recall_at_k(I_r, Ir, 10) == 1.0


def test_query_replicas_validation():
    with pytest.raises(ValueError):
        ShardedIndexFlat(16, num_replicas=NDEV + 1, num_shards=2)


def test_sharded_fused_bf16_path(monkeypatch):
    """bf16 per-shard fused path (sweep kernel + gather rescore) inside
    shard_map must match the quantized-db oracle."""
    from faiss_tpu.ops import pallas_fused

    monkeypatch.setattr(pallas_fused, "FUSED_MIN_NV", 8192)  # small shards
    from faiss_tpu.ops.pallas_fused import FUSED_MIN_NV

    nv = NDEV * (FUSED_MIN_NV + 600)
    xb, xq = make_data(nv, 4, 32)
    idx = ShardedIndexFlat(32, storage="bf16")
    idx.add(xb)
    D, I = idx.search(xq, 10)
    single = TpuIndexFlat(32, storage="bf16")
    single.add(xb)
    D1, I1 = single.search(xq, 10)
    np.testing.assert_array_equal(I, I1)
    np.testing.assert_allclose(D, D1, rtol=1e-5, atol=1e-5)


def test_uneven_shard_capacities_regression():
    """ADVICE r1 (high): _assemble's capacity equalization used doubling
    growth and overshot the target — 2 shards, add(4097) made shard
    capacities 3072/2048, the equalize grew shard 1 to 4096 instead of 3072,
    and every search raised at make_array_from_single_device_arrays."""
    rng = np.random.default_rng(11)
    d = 32
    xb = rng.standard_normal((4097, d), dtype=np.float32)
    xq = rng.standard_normal((5, d), dtype=np.float32)
    idx = ShardedIndexFlat(d, num_shards=2)
    idx.add(xb)
    caps = [s.store.capacity for s in idx.shards]
    D, I = idx.search(xq, 10)  # raised ValueError before the fix
    caps_after = [s.store.capacity for s in idx.shards]
    assert len(set(caps_after)) == 1, caps_after
    assert max(caps_after) == max(caps), (caps, caps_after)  # no overshoot
    Dr, Ir = numpy_search(xb, xq, 10)
    compare_results(D, I, Dr, Ir, dist_tol=1e-3, k=10, label="uneven caps")


def test_cross_shard_tie_order():
    """Duplicate vectors spread across shards over MULTIPLE add batches (so
    gid order diverges from shard order): merged ties must resolve to the
    lowest GLOBAL id, matching the single-device index and the stable
    oracle (VERDICT r1 weak #7)."""
    rng = np.random.default_rng(21)
    base = rng.standard_normal((64, 32)).astype(np.float32)
    xb = np.tile(base, (8, 1))  # every vector appears 8×, ids 64 apart
    idx = ShardedIndexFlat(32, num_shards=4)
    for i in range(8):  # separate batches rotate the split start
        idx.add(xb[i * 64 : (i + 1) * 64])
    single = TpuIndexFlat(32)
    single.add(xb)
    xq = rng.standard_normal((6, 32)).astype(np.float32)
    Ds, Is = idx.search(xq, 24)  # k > duplicate count → ties at many ranks
    D1, I1 = single.search(xq, 24)
    np.testing.assert_array_equal(Is, I1)
    np.testing.assert_allclose(Ds, D1, rtol=1e-5, atol=1e-5)


def test_sharded_force_xla_parity(monkeypatch):
    """Fused vs plain local scan on the sharded path must agree exactly
    (reference forced-MPS cross-path pattern) — forced via set_force_xla
    rather than relying on the gate flipping naturally."""
    from faiss_tpu.ops import pallas_fused as pf

    monkeypatch.setattr(pf, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 1024)
    xb, xq = make_data(9000, 8, 64)
    idx = ShardedIndexFlat(64, num_shards=4)
    idx.add(xb)
    D1, I1 = idx.search(xq, 10)      # fused local scan (forced eligible)
    idx.set_force_xla(True)
    D2, I2 = idx.search(xq, 10)      # plain local scan
    np.testing.assert_array_equal(I1, I2)
    np.testing.assert_allclose(D1, D2, rtol=1e-5, atol=1e-4)
    Dr, Ir = numpy_search(xb, xq, 10)
    compare_results(D1, I1, Dr, Ir, dist_tol=1e-3, k=10, label="sharded xpath")


def test_sharded_fallback_on_ties(monkeypatch):
    """Uncertified fused shard results re-run on the plain path — sharded
    ties still resolve exactly."""
    from faiss_tpu.ops import pallas_fused as pf

    monkeypatch.setattr(pf, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 1024)
    rng = np.random.default_rng(23)
    row = rng.standard_normal(32).astype(np.float32)
    xb = np.tile(row, (8192, 1))
    xq = rng.standard_normal((4, 32)).astype(np.float32)
    idx = ShardedIndexFlat(32, num_shards=4)
    idx.add(xb)
    D, I = idx.search(xq, 8)
    assert idx.fused_fallbacks == 1
    np.testing.assert_array_equal(I, np.tile(np.arange(8), (4, 1)))


def test_sharded_reconstruct_extents_after_load(tmp_path):
    """O(1) reconstruct bookkeeping (VERDICT r2 weak #6): gid extents must
    be maintained by BOTH mutation paths — add() and the io restore — and
    survive uneven multi-batch adds."""
    from faiss_tpu.io import load_index, save_index

    rng = np.random.default_rng(11)
    xb = rng.standard_normal((997, 32)).astype(np.float32)
    idx = ShardedIndexFlat(32, num_shards=4)
    idx.add(xb[:123])
    idx.add(xb[123:130])   # tiny batch → rotating remainder start
    idx.add(xb[130:])
    for key in (0, 122, 123, 129, 130, 996, 500):
        np.testing.assert_array_equal(idx.reconstruct(key), xb[key])
    p = str(tmp_path / "ext.npz")
    save_index(idx, p)
    idx2 = load_index(p, sharded=True)
    for key in (0, 499, 996):
        np.testing.assert_array_equal(idx2.reconstruct(key), xb[key])
    idx.reset()
    try:
        idx.reconstruct(0)
        raise AssertionError("reconstruct after reset must fail")
    except IndexError:
        pass
