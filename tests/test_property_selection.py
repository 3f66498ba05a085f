"""Property-style randomized differential tests for the selection paths
(SURVEY.md §5.2: the reference argues its SIMD-shuffle selection correct in
comments; here every path is hammered against the oracle across random
shapes, ks, metrics, duplicates and extreme values)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from faiss_tpu import TpuIndexFlat
from faiss_tpu.dtypes import MetricType
from faiss_tpu.ops import pallas_fused, topk

from common import numpy_search, recall_at_k


RNG = np.random.default_rng(1234)


def _random_case(i):
    nv = int(RNG.integers(1, 6000))
    nq = int(RNG.integers(1, 20))
    d = int(RNG.integers(1, 200))
    k = int(RNG.integers(1, 2 * nv + 4))
    metric = "l2" if i % 2 == 0 else "ip"
    xb = RNG.standard_normal((nv, d)).astype(np.float32)
    xq = RNG.standard_normal((nq, d)).astype(np.float32)
    if i % 3 == 0 and nv > 4:  # inject duplicates → score ties
        xb[nv // 2 :] = xb[: nv - nv // 2]
    if i % 5 == 0:  # extreme magnitudes
        xb *= 1e3
    return nv, nq, d, k, metric, xb, xq


@pytest.mark.parametrize("i", range(12))
def test_index_random_configs(i):
    nv, nq, d, k, metric, xb, xq = _random_case(i)
    idx = TpuIndexFlat(d, metric=metric)
    idx.add(xb)
    D, I = idx.search(xq, k)
    Dr, Ir = numpy_search(xb, xq, k, metric=metric)
    k_eff = min(k, nv)
    assert recall_at_k(I, Ir, k_eff) == 1.0, (nv, nq, d, k, metric)
    # sentinel structure beyond nv
    if k > nv:
        assert (I[:, nv:] == -1).all()
    finite = np.isfinite(Dr)
    np.testing.assert_allclose(D[finite], Dr[finite], rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("seed", range(6))
def test_chunked_equals_plain_random(seed):
    rng = np.random.default_rng(seed)
    nq = int(rng.integers(1, 12))
    nv = int(rng.integers(2, 40)) * 128
    chunk = int(rng.integers(1, 6)) * 128
    k = int(rng.integers(1, min(nv, 300)))
    scores = rng.standard_normal((nq, nv)).astype(np.float32)
    if seed % 2:
        scores = np.round(scores, 1)  # many ties
    sj = jnp.asarray(scores)
    nfull = max(1, nv // chunk)
    prefix = nfull * chunk
    v, i = topk.chunked_topk_scores(
        lambda s: jax.lax.dynamic_slice_in_dim(sj, s, chunk, axis=1),
        prefix, chunk, min(k, prefix),
    )
    vp, ip_ = jax.lax.top_k(sj[:, :prefix], min(k, prefix))
    scores = scores[:, :prefix]
    np.testing.assert_array_equal(np.asarray(v), np.asarray(vp))
    # ids may differ only where values tie across chunk boundaries in a way
    # top_k also permits; values at our ids must equal top_k values
    np.testing.assert_array_equal(
        np.take_along_axis(scores, np.asarray(i), axis=1), np.asarray(vp)
    )


# -- certificate soundness: the derived ε must dominate the REAL
# sweep-vs-rescore gap on adversarial data (VERDICT r3 ask #4 / ADVICE r2
# medium: the old bound ended in an undefended ×2; the new one is derived
# term-by-term, so probe it hard). Configs cover every sweep variant and the
# norm-skew regime (db norms ≫ query norms) where the previously-omitted
# epilogue-subtraction rounding u·(2Q·V + ‖v‖²_max) dominates.
# ``const_groups=True`` makes all 128 rows of each group identical, so the
# group-max IS every member and the test becomes a POINTWISE check of
# |sweep(x) − rescore(x)| ≤ ε for thousands of (query, row) pairs.
_CERT_CASES = [
    # storage, metric, passes, db_scale, const_groups
    ("f32", MetricType.L2, 2, 1.0, True),
    ("f32", MetricType.L2, 2, 1e4, True),     # ADVICE norm-skew regime
    ("f32", MetricType.L2, 1, 1e4, False),
    ("f32", MetricType.INNER_PRODUCT, 2, 1e4, True),
    ("bf16", MetricType.L2, 1, 1.0, True),
    ("bf16", MetricType.L2, 2, 1e4, True),
    ("bf16", MetricType.INNER_PRODUCT, 1, 1e-4, False),
    ("int8", MetricType.L2, 2, 1e3, True),
    ("int8", MetricType.INNER_PRODUCT, 2, 1.0, True),
]


@pytest.mark.parametrize("case", range(len(_CERT_CASES)))
def test_certificate_eps_sound(case):
    from faiss_tpu.storage import split_f32_bf16, _split_stats_fn, \
        _quantize_int8_fn

    storage, metric, passes, db_scale, const_groups = _CERT_CASES[case]
    nv, d, nq = 2048, 128, 256
    rng = np.random.default_rng(9000 + case)
    if const_groups:
        uniq = rng.standard_normal((nv // 128, d)).astype(np.float32)
        xb = np.repeat(uniq, 128, axis=0)
    else:
        xb = rng.standard_normal((nv, d)).astype(np.float32)
    xb *= db_scale
    # plant near-ties: make some rows ulp-perturbed copies of others
    xb[7] = xb[3] * (1 + np.float32(2.0 ** -22))
    xq = rng.standard_normal((nq, d)).astype(np.float32)
    q = jnp.asarray(xq)
    norms32 = jnp.sum(jnp.asarray(xb) * jnp.asarray(xb), axis=-1,
                      dtype=jnp.float32)
    kwargs = dict(metric=metric, nv_eff=nv, interpret=True,
                  sweep_passes=passes)
    if storage == "f32":
        db = jnp.asarray(xb)
        hi, lo = split_f32_bf16(db)
        stats = _split_stats_fn(jnp.zeros((2,), jnp.float32), db, hi, lo)
        kwargs.update(db_split=(hi, lo), split_stats=stats)
        eps = pallas_fused._sweep_eps(
            q, norms32, nv, metric=metric, pair_sweep=True, d_pad=d,
            single_pass=passes == 1, split_stats=stats)
    elif storage == "bf16":
        db = jnp.asarray(xb).astype(jnp.bfloat16)
        eps = pallas_fused._sweep_eps(
            q, norms32, nv, metric=metric, pair_sweep=False, d_pad=d,
            single_pass=passes == 1)
    else:  # int8
        scales = jnp.asarray(
            np.maximum(np.abs(xb).max(axis=0) / 127.0, 1e-12), jnp.float32)
        db, norms32, vqmax, _clip = _quantize_int8_fn(jnp.asarray(xb), scales)
        kwargs.update(scales=scales, int_norm_max=vqmax)
        eps = pallas_fused._sweep_eps_int8(
            q, scales, vqmax, norms32, nv, metric=metric, d_pad=d)
    gm = pallas_fused.groupmax_scores(
        q, db, norms32, jnp.int32(nv),
        kwargs.get("db_split"), metric=metric, nv_eff=nv,
        interpret=True, sweep_passes=passes, scales=kwargs.get("scales"))
    # rescore EVERY row: k = nv nominates all groups
    vals, ids, cert = pallas_fused.fused_search(
        q, db, norms32, jnp.int32(nv), k=nv, **kwargs)
    assert bool(np.asarray(cert).all())  # all groups nominated → trivial
    s_resc = np.full((nq, nv), np.nan, np.float32)
    np.put_along_axis(s_resc, np.asarray(ids), np.asarray(vals), axis=1)
    assert not np.isnan(s_resc).any()
    resc_gmax = s_resc.reshape(nq, nv // 128, 128).max(axis=2)
    gm_np = np.asarray(gm)
    eps_np = np.asarray(eps)[:, None]
    # soundness: a row's rescored score can NEVER exceed its group's sweep
    # max by ε (this is exactly the inequality the certificate relies on);
    # with const_groups this is pointwise over every (query, row) pair
    viol = resc_gmax - (gm_np + eps_np)
    assert (viol <= 0).all(), (
        _CERT_CASES[case], float(viol.max()),
        float(eps_np.min()))
    # and the reverse direction (pointwise |sweep − rescore| ≤ ε implies
    # max-sweep ≤ max-rescore + ε per group)
    viol2 = gm_np - (resc_gmax + eps_np)
    assert (viol2 <= 0).all(), (_CERT_CASES[case], float(viol2.max()))
    # the bound is a real bound, not vacuous slack: it should sit within a
    # few orders of magnitude of the observed gap's scale (sanity only)
    gap = np.abs(resc_gmax - gm_np).max()
    assert eps_np.max() >= gap  # both directions of the gap are covered


@pytest.mark.parametrize("seed", range(4))
def test_fused_random_configs(seed):
    rng = np.random.default_rng(100 + seed)
    nv = int(rng.integers(64, 200)) * 128       # GROUP-aligned
    nq = int(rng.integers(1, 3)) * 8
    d = int(rng.integers(1, 5)) * 128
    k = int(rng.integers(1, 40))
    xb = rng.standard_normal((nv, d)).astype(np.float32)
    xq = rng.standard_normal((nq, d)).astype(np.float32)
    if seed % 2:
        xb[nv // 2 :] = xb[: nv - nv // 2]      # ties
    db, q = jnp.asarray(xb), jnp.asarray(xq)
    norms = jnp.sum(db * db, axis=-1)
    vals, ids, cert = pallas_fused.fused_search(
        q, db, norms, jnp.int32(nv), k=k, metric=MetricType.L2,
        nv_eff=nv, interpret=True,
    )
    s = 2 * (xq.astype(np.float64) @ xb.astype(np.float64).T)
    s -= np.asarray(norms, np.float64)[None, :]
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    got = np.sort(np.asarray(ids), axis=1)
    want = np.sort(order, axis=1)
    # sets must match even under massive duplication
    sv = np.take_along_axis(s, order, 1)
    gv = np.take_along_axis(s, np.asarray(ids), 1)
    np.testing.assert_allclose(gv, sv, rtol=1e-5, atol=1e-5)
    # certified queries must match the oracle EXACTLY (ids, not just values)
    c = np.asarray(cert)
    np.testing.assert_array_equal(np.asarray(ids)[c], order[c])


_T2_CASES = [  # (metric, db_scale)
    (MetricType.L2, 1.0),
    (MetricType.L2, 316.0),            # norm-skewed db (ADVICE r2 regime)
    (MetricType.INNER_PRODUCT, 1.0),
]


@pytest.mark.parametrize("case", range(len(_T2_CASES)))
def test_pair_rescore_eps_sound(case):
    """Rescore soundness for pair-only fp32 storage (device memory holds
    only the bf16 (hi, lo) pair): for EVERY stored row, the phase-3
    rescore (gather hi + lo, reconstruct, HIGHEST dot) stays within the
    rescore-accumulation budget _sweep_eps charges for it — term (3),
    2·d·u·Q·V, doubled for L2, plus the epilogue rounding u·(2QV + N) —
    of the float64 score of the pair-represented vectors. Near-tie and
    norm-skewed cases included."""
    from faiss_tpu.storage import split_f32_bf16

    metric, db_scale = _T2_CASES[case]
    nv, d, nq = 1024, 128, 64
    rng = np.random.default_rng(7000 + case)
    xb = rng.standard_normal((nv, d)).astype(np.float32) * db_scale
    xb[7] = xb[3] * (1 + np.float32(2.0 ** -22))   # planted near-tie
    xq = rng.standard_normal((nq, d)).astype(np.float32)
    q, db = jnp.asarray(xq), jnp.asarray(xb)
    hi, lo = split_f32_bf16(db)
    norms = jnp.sum(db * db, axis=-1, dtype=jnp.float32)
    ng = nv // 128
    gidx = jnp.broadcast_to(jnp.arange(ng, dtype=jnp.int32)[None], (nq, ng))
    s_resc = np.asarray(pallas_fused.rescore_groups(
        q, hi, norms, gidx, metric=metric, db_lo=lo), np.float64)
    v64 = (np.asarray(hi, np.float64) + np.asarray(lo, np.float64))
    dots = xq.astype(np.float64) @ v64.T
    n64 = np.asarray(norms, np.float64)
    s_exact = 2.0 * dots - n64[None, :] if metric is MetricType.L2 else dots
    u = 2.0 ** -24
    Q = np.sqrt((xq.astype(np.float64) ** 2).sum(1))[:, None]
    V = np.sqrt((v64 ** 2).sum(1)).max()
    bound = 2.0 * d * u * Q * V
    if metric is MetricType.L2:
        bound = 2.0 * bound + u * (2.0 * Q * V + n64.max())
    gap = np.abs(s_resc - s_exact)
    viol = gap - bound
    assert (viol <= 0).all(), (case, float(viol.max()))
    assert gap.max() > 0  # the comparison is not vacuous
