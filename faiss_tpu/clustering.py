"""k-means + functional knn (faiss::Clustering / faiss.Kmeans
parity — beyond the reference surface).

The reference framework has no clustering (MetalIndexFlat IS its surface),
but faiss users lean on ``faiss.Kmeans`` — itself built on IndexFlat
search (faiss/Clustering.cpp) — for IVF training, PQ codebooks, and
dataset exploration; a converted user needs it here.

Design: training is ONE jitted program — ``lax.scan`` over a
static ``niter`` Lloyd iterations, each iteration a ``lax.map`` over
static data chunks where BOTH halves of Lloyd run as GEMMs:

  * E-step (assign): the shared ``matmul_scores`` GEMM convention
    (ops/distance.py — identical arithmetic to index search, so
    ``Kmeans.index`` assignments agree with training assignments), then an
    argmax over the (chunk, k) block.
  * M-step (update): scatter-add as a second GEMM — ``one_hotᵀ @ x`` with
    fp32 HIGHEST accumulation (XLA scatters serialize on accelerators; the GEMM
    matmul IS the fast scatter when the index set is dense). Counts are
    exact fp32 column sums.

No host↔device traffic inside training: the data rides in once as a jit
ARGUMENT (never a closure constant — CLAUDE.md), the objective series
comes back once at the end. ``nredo`` re-runs reuse the same compiled
program (shapes are identical; only the init centroids change).

Faiss-semantics notes:
  * init: ``k`` distinct points sampled without replacement (faiss's
    default random init, Clustering.cpp rnd_pick); kmeans++ is not needed
    for parity and costs k sequential device steps.
  * subsampling: > ``max_points_per_centroid``·k training points are
    subsampled exactly like faiss (Clustering.cpp:subsample_training_set).
  * empty clusters: faiss splits the largest cluster with a random sign
    flip (Clustering.cpp split_clusters). Shape-static variant: the
    j-th empty centroid is re-seeded on the point ranked j-th by distance
    to its assigned centroid (the worst-served points), computed with one
    top-k per iteration. Deterministic; documented divergence.
  * spherical: centroids L2-renormalized after every M-step
    (faiss::Clustering spherical flag, for IP / cosine codebooks).
"""

from __future__ import annotations

import warnings
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .dtypes import MetricType
from .ops import distance as dist_ops
from .storage import LANE, _round_up

__all__ = ["Kmeans", "balance_centroids", "kmeans_clustering", "knn",
           "pairwise_distances"]

# static chunk of training rows per E/M block: (chunk, k_pad) score tile and
# (chunk, d_pad) data tile both stay comfortably inside on-chip-friendly sizes
_CHUNK = 16_384
# at most this many empty clusters re-seeded per iteration (shape-static
# top-k budget; more than this many empties in one iteration is pathological
# and simply waits one more iteration)
_MAX_RESEED = 128


def _lloyd_train_fn(*, n_pad: int, k_pad: int, d_pad: int, niter: int,
                    chunk: int, k: int, metric: MetricType, spherical: bool):
    """Build the jitted full-training program for one (shapes, niter) class.

    fn(x (n_pad, d_pad) f32, valid (n_pad,) bool, init (k_pad, d_pad) f32)
      -> (centroids (k_pad, d_pad) f32, obj (niter,) f32)

    Rows past ``k`` in the centroid block are inert: forced to +inf
    coordinates so no point ever assigns to them (and their updates are
    discarded).
    """
    nchunks = n_pad // chunk
    reseed = min(_MAX_RESEED, k, chunk)

    def pad_mask():  # (k_pad,) True for real centroid slots
        return jax.lax.iota(jnp.int32, k_pad) < k

    def one_iter(cents, x, valid):
        cnorm = jnp.sum(cents * cents, axis=-1, dtype=jnp.float32)

        def block(c):
            xs = jax.lax.dynamic_slice_in_dim(x, c * chunk, chunk, axis=0)
            vs = jax.lax.dynamic_slice_in_dim(valid, c * chunk, chunk, axis=0)
            s = dist_ops.matmul_scores(xs, cents, cnorm, metric)
            s = jnp.where(pad_mask()[None, :], s, -jnp.inf)
            best = jnp.argmax(s, axis=-1)
            bscore = jnp.max(s, axis=-1)
            oh = (jax.nn.one_hot(best, k_pad, dtype=jnp.float32)
                  * vs[:, None].astype(jnp.float32))
            # scatter-add as a GEMM: exact fp32 (HIGHEST multiplies 1.0·x)
            sums = jax.lax.dot_general(
                oh, xs, (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            counts = jnp.sum(oh, axis=0, dtype=jnp.float32)
            # objective: L2 -> sum ‖x−c‖² = −Σ score ; IP -> Σ score
            contrib = jnp.where(vs, bscore, 0.0)
            obj = (jnp.sum(contrib, dtype=jnp.float32)
                   * (1.0 if metric is MetricType.INNER_PRODUCT else -1.0))
            # worst-served candidates for empty-cluster re-seeding
            worst = -jnp.where(vs, bscore, jnp.inf)  # big = far from centroid
            wv, wi = jax.lax.top_k(worst, reseed)
            return sums, counts, obj, wv, wi + c * chunk

        sums, counts, objs, wv, wi = jax.lax.map(
            block, jnp.arange(nchunks, dtype=jnp.int32))
        sums = jnp.sum(sums, axis=0)
        counts = jnp.sum(counts, axis=0)
        obj = jnp.sum(objs, dtype=jnp.float32)
        new = sums / jnp.maximum(counts, 1.0)[:, None]
        # re-seed empty REAL clusters on the globally worst-served points
        gv, gi = jax.lax.top_k(wv.reshape(-1), reseed)
        cand = jnp.take(x, jnp.take(wi.reshape(-1), gi), axis=0)
        empty = (counts == 0.0) & pad_mask()
        rank = jnp.cumsum(empty.astype(jnp.int32)) - 1  # j-th empty -> j
        take = jnp.clip(rank, 0, reseed - 1)
        new = jnp.where((empty & (rank < reseed))[:, None],
                        jnp.take(cand, take, axis=0), new)
        keep_old = (counts == 0.0) & empty & (rank >= reseed)
        new = jnp.where(keep_old[:, None], cents, new)
        if spherical:
            nrm = jnp.sqrt(jnp.sum(new * new, axis=-1, keepdims=True))
            new = new / jnp.maximum(nrm, 1e-30)
        return new, obj

    def fn(x, valid, init):
        def step(cents, _):
            new, obj = one_iter(cents, x, valid)
            return new, obj

        cents, obj = jax.lax.scan(step, init, None, length=niter)
        return cents, obj

    return jax.jit(fn)


def _assign_only_fn(*, n_pad: int, k_pad: int, d_pad: int, chunk: int,
                    k: int, metric: MetricType):
    """jitted fn(x (n_pad, d_pad), valid (n_pad,), cents (k_pad, d_pad))
    -> assign (n_pad,) int32 (-1 on pad rows) — the E-step alone, for the
    balance loop's host-side occupancy counts."""
    nchunks = n_pad // chunk

    def fn(x, valid, cents):
        cnorm = jnp.sum(cents * cents, axis=-1, dtype=jnp.float32)
        mask = jax.lax.iota(jnp.int32, k_pad) < k

        def block(c):
            xs = jax.lax.dynamic_slice_in_dim(x, c * chunk, chunk, axis=0)
            vs = jax.lax.dynamic_slice_in_dim(valid, c * chunk, chunk, axis=0)
            s = dist_ops.matmul_scores(xs, cents, cnorm, metric)
            s = jnp.where(mask[None, :], s, -jnp.inf)
            return jnp.where(vs, jnp.argmax(s, axis=-1), -1).astype(jnp.int32)

        return jax.lax.map(
            block, jnp.arange(nchunks, dtype=jnp.int32)).reshape(-1)

    return jax.jit(fn)


def balance_centroids(x: np.ndarray, centroids: np.ndarray, *,
                      cap_ratio: float = 2.0, rounds: int = 6,
                      lloyd_iters: int = 2, metric=MetricType.L2,
                      spherical: bool = False,
                      verbose: bool = False) -> np.ndarray:
    """Rebalance trained centroids so no cluster holds more than
    ~``cap_ratio`` × the mean occupancy of the training sample.

    Plain Lloyd on clustered data leaves heavy skew (1M mixture, k=1024:
    max list 9263 vs mean 977), and the IVF fine
    scan's STATIC per-query chunk budget is the sum of the nprobe largest
    lists (`ivf._chunk_budget`), so every query pays the skew tax in
    gather bytes: budget 80 chunks at nprobe=1 where the mean list needs 8.
    Each round: (E-step occupancy) → split each oversized cluster in two
    along its spread direction (the two half-means on either side of the
    median projection), retiring the currently smallest clusters to keep k
    fixed → a short warm-started Lloyd polish; a final split pass without
    polish pins the cap. faiss has no balancing (Clustering.cpp only
    splits EMPTY clusters); this is a deliberate divergence that trades a
    slightly higher k-means objective for a bounded search budget.
    """
    x = np.ascontiguousarray(x, np.float32)
    centroids = np.array(centroids, np.float32, copy=True)
    k, d = centroids.shape
    n = x.shape[0]
    if n < 4 * k:  # too few points to measure skew — leave as trained
        return centroids
    chunk = min(_CHUNK, _round_up(n, 8))
    n_pad = _round_up(n, chunk)
    d_pad = _round_up(d, LANE)
    k_pad = _round_up(k, 8)
    xp = np.zeros((n_pad, d_pad), np.float32)
    xp[:n, :d] = x
    valid = np.zeros((n_pad,), bool)
    valid[:n] = True
    xd = jax.device_put(xp)
    vd = jax.device_put(valid)
    assign_fn = _assign_only_fn(n_pad=n_pad, k_pad=k_pad, d_pad=d_pad,
                                chunk=chunk, k=k, metric=metric)
    polish_fn = _lloyd_train_fn(n_pad=n_pad, k_pad=k_pad, d_pad=d_pad,
                                niter=lloyd_iters, chunk=chunk, k=k,
                                metric=metric, spherical=spherical)
    cap = max(int(np.ceil(cap_ratio * n / k)), 2)

    def pad_cents(c):
        # pad ROWS are +inf (never win the argmax); real rows' pad COLUMNS
        # must be 0 (the data's pad columns are 0)
        cp = np.full((k_pad, d_pad), np.inf, np.float32)
        cp[:k] = 0.0
        cp[:k, :d] = c
        return cp

    def split_pass(cents, a):
        counts = np.bincount(a[a >= 0], minlength=k)[:k]
        over = np.nonzero(counts > cap)[0]
        if over.size == 0:
            return cents, counts, 0
        over = over[np.argsort(-counts[over])]
        order = np.argsort(a, kind="stable")       # members grouped by list
        starts = np.searchsorted(a[order], np.arange(k))
        ends = np.searchsorted(a[order], np.arange(k), side="right")
        victims = [v for v in np.argsort(counts) if counts[v] <= cap // 2]
        nsplit = min(over.size, len(victims))
        for i in range(nsplit):
            cl, v = int(over[i]), int(victims[i])
            m = x[order[starts[cl]:ends[cl]]]
            mu = m.mean(axis=0)
            dev = m - mu
            far = dev[int(np.argmax((dev * dev).sum(1)))]
            proj = dev @ far
            med = np.median(proj)
            lo, hi = m[proj <= med], m[proj > med]
            if not len(lo) or not len(hi):          # degenerate: all ties
                continue
            c1, c2 = lo.mean(axis=0), hi.mean(axis=0)
            if spherical:
                c1 = c1 / max(np.linalg.norm(c1), 1e-30)
                c2 = c2 / max(np.linalg.norm(c2), 1e-30)
            cents[cl], cents[v] = c1, c2
        return cents, counts, nsplit

    for r in range(rounds):
        a = np.asarray(jax.device_get(
            assign_fn(xd, vd, jax.device_put(pad_cents(centroids)))))[:n]
        centroids, counts, nsplit = split_pass(centroids, a)
        if verbose:
            print(f"balance round {r}: max {counts.max()} cap {cap} "
                  f"splits {nsplit}")
        if nsplit == 0:
            return centroids
        if r < rounds - 1:                          # last split stays raw:
            cp, _ = polish_fn(xd, vd, jax.device_put(pad_cents(centroids)))
            # copy=True: when (k, d) == (k_pad, d_pad) the slice is the
            # whole device_get buffer, which numpy marks read-only — the
            # next split_pass writes rows in place
            centroids = np.array(
                np.asarray(jax.device_get(cp))[:k, :d], np.float32)
    return centroids


class Kmeans:
    """faiss.Kmeans analog over this package's index machinery.

    After ``train(x)``: ``centroids`` (k, d) fp32, ``obj`` (niter,) per-
    iteration objective of the best redo (sum of squared distances for L2,
    negated summed similarity for IP, matching faiss's "to minimize"
    convention), and ``index`` — a TpuIndexFlat over the centroids, so
    ``assign`` / ``search`` run the production search path.
    """

    def __init__(self, d: int, k: int, *, niter: int = 25, nredo: int = 1,
                 seed: int = 1234, spherical: bool = False,
                 metric=MetricType.L2,
                 min_points_per_centroid: int = 39,
                 max_points_per_centroid: int = 256,
                 verbose: bool = False, resources=None):
        if k <= 0 or d <= 0 or niter <= 0 or nredo <= 0:
            raise ValueError(f"bad Kmeans config: {d=} {k=} {niter=} {nredo=}")
        self.d, self.k = int(d), int(k)
        self.niter, self.nredo = int(niter), int(nredo)
        self.seed, self.spherical = int(seed), bool(spherical)
        self.metric = MetricType.coerce(metric)
        self.min_points_per_centroid = int(min_points_per_centroid)
        self.max_points_per_centroid = int(max_points_per_centroid)
        self.verbose = bool(verbose)
        self.resources = resources
        self.centroids: Optional[np.ndarray] = None
        self.obj: Optional[np.ndarray] = None
        self.index = None

    def train(self, x: np.ndarray) -> float:
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected (n, {self.d}) training data, "
                             f"got {x.shape}")
        n = x.shape[0]
        if n < self.k:
            raise ValueError(f"need at least k={self.k} training points, "
                             f"got {n}")
        rng = np.random.default_rng(self.seed)
        if n < self.k * self.min_points_per_centroid:
            warnings.warn(
                f"kmeans: {n} training points for k={self.k} is below "
                f"faiss's recommended {self.min_points_per_centroid}/centroid")
        cap = self.k * self.max_points_per_centroid
        if n > cap:  # faiss Clustering.cpp subsample_training_set
            x = x[rng.choice(n, cap, replace=False)]
            n = cap
        if self.spherical:
            nrm = np.linalg.norm(x, axis=1, keepdims=True)
            x = x / np.maximum(nrm, 1e-30)

        chunk = min(_CHUNK, _round_up(n, 8))
        n_pad = _round_up(n, chunk)
        d_pad = _round_up(self.d, LANE)
        k_pad = _round_up(self.k, 8)
        xp = np.zeros((n_pad, d_pad), np.float32)
        xp[:n, : self.d] = x
        valid = np.zeros((n_pad,), bool)
        valid[:n] = True

        fn = _lloyd_train_fn(
            n_pad=n_pad, k_pad=k_pad, d_pad=d_pad, niter=self.niter,
            chunk=chunk, k=self.k, metric=self.metric,
            spherical=self.spherical)
        xd = jax.device_put(xp)
        vd = jax.device_put(valid)

        best = None
        for redo in range(self.nredo):
            sel = rng.choice(n, self.k, replace=False)
            init = np.full((k_pad, d_pad), np.inf, np.float32)
            init[: self.k] = xp[sel]
            cents, obj = jax.device_get(fn(xd, vd, jax.device_put(init)))
            final = float(obj[-1])
            if self.verbose:
                print(f"kmeans redo {redo}: obj {obj[0]:.6g} -> {final:.6g}")
            if best is None or final < best[0]:
                best = (final, cents, np.asarray(obj))
        final, cents, obj = best
        self.obj = obj
        self.centroids = np.ascontiguousarray(cents[: self.k, : self.d])
        from .index import TpuIndexFlat  # late: avoid import cycle

        self.index = TpuIndexFlat(self.d, metric=self.metric,
                                  resources=self.resources)
        self.index.add(self.centroids)
        return final

    def assign(self, x: np.ndarray, k: int = 1) -> np.ndarray:
        if self.index is None:
            raise RuntimeError("Kmeans.train has not run")
        return self.index.assign(x, k)


def kmeans_clustering(x: np.ndarray, k: int, **kw) -> Tuple[np.ndarray, float]:
    """faiss.kmeans_clustering analog: (centroids (k, d), final objective)."""
    x = np.asarray(x, np.float32)
    km = Kmeans(x.shape[1], k, **kw)
    obj = km.train(x)
    return km.centroids, obj


def knn(xq: np.ndarray, xb: np.ndarray, k: int, metric=MetricType.L2,
        storage="f32", resources=None) -> Tuple[np.ndarray, np.ndarray]:
    """faiss.knn analog: one-shot exact top-k without keeping an index.
    Runs the full production search path (fused kernels, certificate)."""
    from .index import index_numpy_to_tpu

    idx = index_numpy_to_tpu(np.asarray(xb, np.float32), metric=metric,
                             storage=storage, resources=resources)
    try:
        return idx.search(np.asarray(xq, np.float32), k)
    finally:
        idx.reset()


def pairwise_distances(xq: np.ndarray, xb: np.ndarray,
                       metric=MetricType.L2) -> np.ndarray:
    """faiss.pairwise_distances analog: dense (nq, nv) fp32 distances in the
    index's plain arithmetic class (squared L2 / inner product)."""
    metric = MetricType.coerce(metric)
    xq = jnp.asarray(np.asarray(xq, np.float32))
    xb = jnp.asarray(np.asarray(xb, np.float32))

    @jax.jit
    def fn(q, b):
        nrm = jnp.sum(b * b, axis=-1, dtype=jnp.float32)
        s = dist_ops.matmul_scores(q, b, nrm, metric)
        return dist_ops.scores_to_distances(s, metric)

    return np.asarray(jax.device_get(fn(xq, xb)))
