"""Profiling / benchmark harness.

≈ the reference's bench_metal_flat (tests/bench_metal_flat.mm:16-96: warmup
iterations + wall-clock timing per config) plus what it lacks (SURVEY.md
§5.1): a recall check against an exact oracle, pipelined-async throughput
measurement, and a `jax.profiler` trace hook.

Throughput is measured with several searches in flight on a thread pool —
the serving pattern of concurrent request handlers sharing one index
(reference parity: multiple tokens in flight, MetalIndexFlat.mm:403-490).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Iterable, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class BenchResult:
    name: str
    nv: int
    nq: int
    d: int
    k: int
    storage: str
    latency_ms: float          # one blocking search, host-to-host
    pipelined_ms: float        # per-search with PIPELINE_DEPTH in flight
    qps: float                 # nq / pipelined_ms
    recall_at_k: Optional[float]

    def line(self) -> str:
        r = "" if self.recall_at_k is None else f" recall@{self.k}={self.recall_at_k:.4f}"
        return (f"{self.name:<16} nv={self.nv:>9} nq={self.nq:>4} d={self.d:>5} "
                f"k={self.k:>4} {self.storage:<8} lat={self.latency_ms:8.2f}ms "
                f"pipe={self.pipelined_ms:8.2f}ms qps={self.qps:10.1f}{r}")


# searches in flight on the thread pool (enough to keep the device queue
# non-empty between host-side query uploads and result fetches)
PIPELINE_DEPTH = 8
WARMUP = 3
ITERS = 10


def measure_search(index, xq: np.ndarray, k: int,
                   iters: int = ITERS, warmup: int = WARMUP,
                   depth: int = PIPELINE_DEPTH) -> Tuple[float, float]:
    """Returns (blocking latency ms, pipelined per-search ms)."""
    for _ in range(warmup):
        index.search(xq, k)
    lat = []
    for _ in range(iters):
        t0 = time.perf_counter()
        index.search(xq, k)
        lat.append(time.perf_counter() - t0)
    latency = min(lat)

    # pipelined: `depth` whole searches in flight on a thread pool, so every
    # per-call host step (query upload, dispatch, result fetch) overlaps
    # across calls. This is the serving pattern: concurrent request
    # handlers sharing one index. Best of 3 blocks.
    import concurrent.futures as cf

    n_total = max(iters, depth * 2)
    pipelined = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(max_workers=depth) as pool:
            futs = [pool.submit(index.search, xq, k) for _ in range(n_total)]
            for f in futs:
                f.result()
        pipelined = min(pipelined, (time.perf_counter() - t0) / n_total)
    return latency * 1e3, pipelined * 1e3


def _oracle_recall(xb, xq, k, metric, I_test, sample=None) -> float:
    """Recall@k vs the exact float64 oracle. ``sample=None`` checks EVERY
    query (a 16-query sample can leave regressions in the rest of the batch
    invisible)."""
    ns = xq.shape[0] if sample is None else min(sample, xq.shape[0])
    sub = xq[:ns].astype(np.float64)
    xb64 = xb.astype(np.float64)
    if metric == "l2":
        s = -((sub * sub).sum(1)[:, None] - 2 * sub @ xb64.T
              + (xb64 * xb64).sum(1)[None, :])
    else:
        s = sub @ xb64.T
    k_eff = min(k, xb.shape[0])
    ref = np.argsort(-s, axis=1, kind="stable")[:, :k_eff]
    hits = sum(len(set(map(int, I_test[i, :k_eff])) & set(map(int, ref[i])))
               for i in range(ns))
    return hits / (ns * k_eff)


def bench_grid(index_factory, configs: Iterable[dict],
               check_recall: bool = True, recall_sample=None,
               verbose: bool = True) -> List[BenchResult]:
    """Run a benchmark grid. Each config: {name, nv, nq, d, k, storage,
    metric?}. ``index_factory(d, metric, storage)`` builds an empty index.

    The default grid mirrors the reference's seven configs
    (tests/bench_metal_flat.mm:115-129) — see DEFAULT_GRID.
    """
    results = []
    rng = np.random.default_rng(42)
    for cfg in configs:
        metric = cfg.get("metric", "l2")
        if cfg.get("data") == "int":
            # SIFT-like integer descriptors: exact split stats are zero →
            # fp32 storage dispatches the hi_exact fused path
            xb = rng.integers(0, 218, (cfg["nv"], cfg["d"])).astype(
                np.float32)
        else:
            xb = rng.standard_normal((cfg["nv"], cfg["d"]), dtype=np.float32)
        xq = rng.standard_normal((cfg["nq"], cfg["d"]), dtype=np.float32)
        idx = index_factory(cfg["d"], metric, cfg["storage"])
        idx.add(xb)
        lat, pipe = measure_search(idx, xq, cfg["k"])
        recall = None
        if check_recall:
            D, I = idx.search(xq, cfg["k"])
            recall = _oracle_recall(xb, xq, cfg["k"], metric, I, recall_sample)
        r = BenchResult(
            name=cfg["name"], nv=cfg["nv"], nq=cfg["nq"], d=cfg["d"],
            k=cfg["k"], storage=str(cfg["storage"]),
            latency_ms=lat, pipelined_ms=pipe,
            qps=cfg["nq"] / (pipe / 1e3), recall_at_k=recall,
        )
        results.append(r)
        if verbose:
            print(r.line(), flush=True)
        del idx
    return results


# the reference's grid (bench_metal_flat.mm:115-129), f32 + bf16 variants
DEFAULT_GRID = [
    dict(name="small-32d", nv=10_000, nq=100, d=32, k=10, storage="f32"),
    dict(name="small-128d", nv=10_000, nq=100, d=128, k=10, storage="f32"),
    dict(name="medium-128d", nv=100_000, nq=100, d=128, k=10, storage="f32"),
    dict(name="medium-128d.bf16", nv=100_000, nq=100, d=128, k=10, storage="bf16"),
    dict(name="medium-768d", nv=100_000, nq=10, d=768, k=10, storage="f32"),
    dict(name="large-1536d", nv=10_000, nq=10, d=1536, k=10, storage="f32"),
    dict(name="highk-128d", nv=10_000, nq=10, d=128, k=100, storage="f32"),
    dict(name="latency-128d", nv=100_000, nq=1, d=128, k=10, storage="f32"),
    # regimes the reference cannot do correctly / at all:
    dict(name="hugek-128d", nv=100_000, nq=10, d=128, k=2048, storage="f32"),
    dict(name="sift1m-shape", nv=1_000_000, nq=100, d=128, k=10, storage="bf16"),
    dict(name="sift1m-shape.int8", nv=1_000_000, nq=100, d=128, k=10,
         storage="int8"),
    dict(name="sift1m-int.f32", nv=1_000_000, nq=100, d=128, k=10,
         storage="f32", data="int"),
    dict(name="ip-1M.bf16", nv=1_000_000, nq=100, d=128, k=10,
         storage="bf16", metric="ip"),
    dict(name="ip-768d", nv=100_000, nq=100, d=768, k=100,
         storage="f32", metric="ip"),
]


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace context (SURVEY.md §5.1). View with TensorBoard or
    read with jax.profiler.ProfileData."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
