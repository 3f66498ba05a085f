#!/usr/bin/env python3
"""On-card smoke run of faiss_tpu: the library's main paths, compiled for
one NVIDIA GPU, through the entry points a user calls.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # four cards: the sharded phase only

One card, in order:
  flat_<storage>   TpuIndexFlat at 10M×128 (Gaussian rows from a seed) for
                   f32 / bf16 / f16 / int8 storage, L2 and IP: search and
                   search_async at nq=100 k=10, k=1024 at nq=8, a filtered
                   search, range_search, and (bf16) remove_ids. Every
                   certified query must equal the exact plain path
                   (id sets, top-1, distances rtol 1e-5 atol 1e-4), on
                   Gaussian and on near-duplicate queries; recall@10 of 16
                   queries against a float64 numpy oracle streamed over the
                   rows; zero certificate fallbacks on Gaussian data.
  flat_f32_int     f32 storage on integer-valued rows (the hi_exact
                   dispatch): results bit-identical to the plain fp32 path.
  ivf_<storage>    TpuIndexIVFFlat at 1M×128 clustered rows, nlist=1024,
                   nprobe=16 (gather route) and nprobe=nlist (dense route),
                   bf16 / int8 / f32, against the index's own plain dense
                   sweep and a float64 oracle over the probed lists.
  gpu_tests        tests/test_gpu_smoke.py in this process (pytest.main).

Four cards: ShardedIndexFlat at 100M×128 bf16 (4 shards, and 2 replicas ×
2 shards), fused vs forced-XLA ids, an 8-query float64 oracle streamed over
the same batches, per-device memory; ShardedIndexIVFFlat against a
single-card TpuIndexIVFFlat at 4M×128.

Exits non-zero, without the final line, when JAX finds no GPU, when any
Pallas kernel ran in interpret mode, or when any phase failed. The last
line is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
import traceback


@dataclasses.dataclass
class Sizes:
    flat_nv: int = 10_000_000
    d: int = 128
    nq: int = 100
    k: int = 10
    k_large: int = 1024
    nq_large: int = 8
    oracle_nq: int = 16
    ivf_nv: int = 1_000_000
    nlist: int = 1024
    nprobe: int = 16
    sharded_nv: int = 100_000_000
    sharded_batch: int = 10_000_000
    sharded_ivf_nv: int = 4_000_000
    sharded_ivf_nlist: int = 1024
    chunk: int = 1_000_000          # host oracle row chunk
    storages: tuple = ("f32", "bf16", "f16", "int8")
    ivf_storages: tuple = ("bf16", "int8", "f32")


RECALL_MIN = {"f32": 0.999, "bf16": 0.98, "f16": 0.99, "int8": 0.95}


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


class Smoke:
    """Phase runner: times each phase, records failures, keeps going."""

    def __init__(self, card: str):
        self.card = card
        self.failed = []
        self.times = {}

    def run(self, name, fn, *args):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn(*args)
            ok = True
        except Exception:
            traceback.print_exc()
            self.failed.append(name)
            ok = False
        dt = time.perf_counter() - t0
        self.times[name] = dt
        print(f"-- {name}: {'ok' if ok else 'FAILED'} in {dt:.1f} s "
              f"[{self.card}]", flush=True)
        gc.collect()


class KernelLog:
    """Records every pallas_call (name, backend, interpret) as it is
    traced, so the run can show each kernel's route and refuse any
    interpret-mode launch."""

    def __init__(self):
        from jax.experimental import pallas as pl

        self.calls = []
        orig = pl.pallas_call

        def recording(*a, **kw):
            self.calls.append((kw.get("name"), kw.get("backend"),
                               bool(kw.get("interpret", False))))
            return orig(*a, **kw)

        pl.pallas_call = recording

    def routes(self):
        return sorted(set(self.calls), key=str)

    def interpreted(self):
        return [c for c in self.calls if c[2]]


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def timed(fn, *a, reps=5, **kw):
    """(first call s — compile included, steady ms per call, result)."""
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*a, **kw)
    steady = (time.perf_counter() - t0) / reps * 1e3
    return first, steady, out


# -- data + oracles -----------------------------------------------------------

def gaussian_rows(n, d, seed):
    import jax
    import jax.numpy as jnp

    return jax.random.normal(jax.random.PRNGKey(seed), (n, d), jnp.float32)


def oracle_topk(xb_dev, xq, k, metric, chunk):
    """float64 top-k ids of xq over device rows, streamed chunk by chunk
    through host memory (ties to the lower id)."""
    import numpy as np
    import jax

    q64 = np.asarray(xq, np.float64)
    best_s = np.full((len(q64), 0), -np.inf)
    best_i = np.zeros((len(q64), 0), np.int64)
    n = xb_dev.shape[0]
    for r0 in range(0, n, chunk):
        rows = np.asarray(jax.device_get(xb_dev[r0:r0 + chunk]), np.float64)
        s = q64 @ rows.T
        if metric == "l2":
            s = 2.0 * s - (rows * rows).sum(1)[None, :]
        top = np.argsort(-s, axis=1, kind="stable")[:, :k]
        best_s = np.concatenate(
            [best_s, np.take_along_axis(s, top, 1)], axis=1)
        best_i = np.concatenate([best_i, top + r0], axis=1)
        order = np.lexsort((best_i, -best_s), axis=1)[:, :k]
        best_s = np.take_along_axis(best_s, order, 1)
        best_i = np.take_along_axis(best_i, order, 1)
    return best_i


def recall(I, ref):
    k = ref.shape[1]
    return sum(len(set(I[i, :k].tolist()) & set(ref[i].tolist()))
               for i in range(len(ref))) / ref.size


def compare_to_plain(D, I, Dp, Ip, rows, what, atol=1e-4):
    """Cross-path contract: id sets equal, top-1 equal, distances within
    rtol 1e-5 / atol. An id may differ only where the two paths' k-th
    distances tie within that tolerance (the two paths round the expanded
    distance differently, so an exact tie in one can be a 1-ulp order in
    the other); such boundary swaps are counted and printed."""
    import numpy as np

    swaps = 0
    for i in rows:
        a, b = set(I[i].tolist()), set(Ip[i].tolist())
        if a == b:
            continue
        tol = 1e-5 * abs(Dp[i, -1]) + atol
        only_f = [j for j, x in enumerate(I[i]) if x not in b]
        only_p = [j for j, x in enumerate(Ip[i]) if x not in a]
        check(all(abs(D[i, j] - Dp[i, -1]) <= tol for j in only_f)
              and all(abs(Dp[i, j] - D[i, -1]) <= tol for j in only_p),
              f"{what}: query {i} id set differs from the plain path "
              f"beyond a k-th-distance tie")
        swaps += 1
    check((I[rows, 0] == Ip[rows, 0]).all(), f"{what}: top-1 differs")
    np.testing.assert_allclose(np.sort(D[rows], 1), np.sort(Dp[rows], 1),
                               rtol=1e-5, atol=atol, err_msg=what)
    if swaps:
        print(f"  {what}: {swaps} queries swap ids tied at the k-th "
              "distance", flush=True)


def fused_raw(idx, xq, k):
    """(D, I, cert) of the fused program BEFORE any fallback rerun."""
    import numpy as np
    import jax

    out, nq, _ = idx._search_device(xq, k)
    d, i, c = jax.device_get(out[:3])
    return (np.asarray(d)[:nq], np.asarray(i)[:nq].astype(np.int64),
            np.asarray(c)[:nq].astype(bool))


def plain(idx, xq, k, params=None):
    idx.set_force_xla(True)
    try:
        return idx.search(xq, k, params=params)
    finally:
        idx.set_force_xla(False)


# -- one card -----------------------------------------------------------------

def flat_phase(sz, storage, xb, xq, xq_dup, oracles):
    import numpy as np
    import jax
    import faiss_tpu

    for metric in ("l2", "ip"):
        what = f"flat {storage} {metric}"
        idx = faiss_tpu.TpuIndexFlat(sz.d, metric=metric, storage=storage)
        t0 = time.perf_counter()
        if storage == "int8":
            idx.train(np.asarray(jax.device_get(xb[:200_000])))
        idx.add(xb)
        jax.block_until_ready(idx.store.norms)
        print(f"  {what}: add {sz.flat_nv} rows {time.perf_counter() - t0:.2f}"
              f" s; {idx.describe().splitlines()[0]}", flush=True)
        first, steady, (D, I) = timed(idx.search, xq, sz.k)
        print(f"  {what}: search nq={sz.nq} k={sz.k} first call {first:.2f} s"
              f" (compile included), steady {steady:.3f} ms", flush=True)
        Df, If, cert = fused_raw(idx, xq, sz.k)
        Dp, Ip = plain(idx, xq, sz.k)
        rows = np.nonzero(cert)[0]
        print(f"  {what}: certified {rows.size}/{sz.nq}", flush=True)
        compare_to_plain(Df, If, Dp, Ip, rows, what + " certified")
        compare_to_plain(D, I, Dp, Ip, np.arange(sz.nq), what + " final")
        check(idx.fused_fallbacks == 0,
              f"{what}: {idx.fused_fallbacks} certificate fallbacks on "
              "Gaussian data")
        r = recall(I[:sz.oracle_nq], oracles[metric])
        print(f"  {what}: recall@{sz.k} vs float64 oracle {r:.4f} "
              f"(min {RECALL_MIN[storage]})", flush=True)
        check(r >= RECALL_MIN[storage], f"{what}: recall {r}")
        # near-duplicate queries: the nearest distance is ~0, where the
        # expanded form ‖q‖² − 2q·v + ‖v‖² cancels terms of ~‖q‖² + ‖v‖²,
        # so the distance tolerance scales with those terms, not the result
        Df, If, cert = fused_raw(idx, xq_dup, sz.k)
        Dp, Ip = plain(idx, xq_dup, sz.k)
        rows = np.nonzero(cert)[0]
        print(f"  {what}: near-duplicate queries certified "
              f"{rows.size}/{len(xq_dup)}", flush=True)
        cancel = 2.0 * float((np.asarray(xq_dup, np.float64) ** 2).sum(1).max())
        compare_to_plain(Df, If, Dp, Ip, rows, what + " near-dup certified",
                         atol=1e-5 * cancel)
        tok = idx.search_async(xq, sz.k)
        Da, Ia = tok.wait()
        check((Ia == I).all() and (Da == D).all(),
              f"{what}: search_async differs from search")
        if metric == "l2":
            q8 = xq[:sz.nq_large]
            first, steady, (Dl, Il) = timed(idx.search, q8, sz.k_large,
                                            reps=2)
            print(f"  {what}: k={sz.k_large} nq={sz.nq_large} first "
                  f"{first:.2f} s, steady {steady:.3f} ms", flush=True)
            Dlp, Ilp = plain(idx, q8, sz.k_large)
            compare_to_plain(Dl, Il, Dlp, Ilp, np.arange(sz.nq_large),
                             what + f" k={sz.k_large}")
            half = sz.flat_nv // 2
            params = faiss_tpu.SearchParams(faiss_tpu.IDSelectorRange(0, half))
            Ds, Is = idx.search(xq, sz.k, params=params)
            check(((Is >= 0) & (Is < half)).all(), f"{what}: selector leak")
            Dsp, Isp = plain(idx, xq, sz.k, params=params)
            compare_to_plain(Ds, Is, Dsp, Isp, np.arange(sz.nq),
                             what + " filtered")
            radius = float(D[:sz.nq_large, 4].max())
            lims, Dr, Ir = idx.range_search(q8, radius)
            for i in range(sz.nq_large):
                hits = set(Ir[lims[i]:lims[i + 1]].tolist())
                want = set(I[i][D[i] < radius].tolist())
                check(want <= hits, f"{what}: range_search misses hits")
                check((Dr[lims[i]:lims[i + 1]] < radius).all(),
                      f"{what}: range_search hit beyond the radius")
            print(f"  {what}: range_search radius {radius:.3f}: "
                  f"{int(lims[-1])} hits for {sz.nq_large} queries",
                  flush=True)
            if storage == "bf16":
                memory_report(idx, xq, sz.k)
                removal_check(idx, xq[:sz.nq_large], I[:sz.nq_large], what)
        del idx
        gc.collect()


def memory_report(idx, xq, k):
    """compiled.memory_analysis() of the cached 10M search program."""
    q, nq, nq_pad = idx._prep_queries(xq)
    key = next(c for c in idx.res._cache
               if c[0] == "flat_search" and c[3] == nq_pad and c[4] == k
               and c[8])
    fn = idx.res._cache[key]
    compiled = fn.lower(idx.store.db, idx.store.norms, q,
                        idx.store.ntotal_dev).compile()
    print(f"  memory_analysis (10M bf16 search, nq_pad={nq_pad}): "
          f"{compiled.memory_analysis()}", flush=True)


def removal_check(idx, q8, I_before, what):
    """remove_ids of each query's top-1: the new top-1 is the old top-2,
    renumbered down by the removed ids below it."""
    import numpy as np

    gone = np.unique(I_before[:, 0])
    n0 = idx.ntotal
    check(idx.remove_ids(gone) == gone.size, f"{what}: remove_ids count")
    check(idx.ntotal == n0 - gone.size, f"{what}: ntotal after remove")
    _, I2 = idx.search(q8, 2)
    for i in range(len(q8)):
        old = I_before[i, 1]
        if old in gone:
            continue
        want = old - np.searchsorted(gone, old)
        check(I2[i, 0] == want, f"{what}: remove_ids renumbering")
    print(f"  {what}: remove_ids({gone.size}) ok", flush=True)


def flat_int_phase(sz):
    import numpy as np
    import jax
    import jax.numpy as jnp
    import faiss_tpu

    xb = jax.random.randint(jax.random.PRNGKey(7), (sz.flat_nv, sz.d), 0,
                            256).astype(jnp.float32)
    xq = np.asarray(jax.random.randint(jax.random.PRNGKey(8), (sz.nq, sz.d),
                                       0, 256), np.float32)
    idx = faiss_tpu.TpuIndexFlat(sz.d, metric="l2", storage="f32")
    idx.add(xb)
    del xb
    check("hi_exact=True" in idx.describe(), "integer data must prove hi_exact")
    first, steady, (D, I) = timed(idx.search, xq, sz.k)
    print(f"  f32 integer rows: search first {first:.2f} s, steady "
          f"{steady:.3f} ms", flush=True)
    Dp, Ip = plain(idx, xq, sz.k)
    check((I == Ip).all(), "hi_exact ids differ from the plain fp32 path")
    check((D == Dp).all(), "hi_exact distances not bit-identical")
    check(idx.fused_fallbacks == 0, "hi_exact fallbacks")


def clustered(n, d, nlist, seed):
    """Mixture of nlist Gaussian clusters (device-generated)."""
    import jax
    import jax.numpy as jnp

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    cents = jax.random.normal(k1, (nlist, d), jnp.float32)
    lab = jax.random.randint(k2, (n,), 0, nlist)
    return cents[lab] + 0.35 * jax.random.normal(k3, (n, d), jnp.float32)


def ivf_phase(sz, storage, xb, xq):
    import numpy as np
    import jax
    import faiss_tpu

    xb_h = np.asarray(jax.device_get(xb))
    ivf = faiss_tpu.TpuIndexIVFFlat(sz.d, sz.nlist, storage=storage,
                                    nprobe=sz.nprobe, seed=3)
    t0 = time.perf_counter()
    ivf.train(xb_h)
    t1 = time.perf_counter()
    ivf.add(xb_h)
    print(f"  ivf {storage}: train {t1 - t0:.2f} s, add "
          f"{time.perf_counter() - t1:.2f} s; {ivf.describe()}", flush=True)
    # gather route
    first, steady, (D, I) = timed(ivf.search, xq, sz.k)
    print(f"  ivf {storage} nprobe={sz.nprobe}: first {first:.2f} s, steady "
          f"{steady:.3f} ms", flush=True)
    # float64 oracle over the probed lists (8 queries) in the index's own
    # convention: distances to the STORED rows (bf16 rows with the
    # pre-quantization norms; int8 rows decoded, with their own norms)
    if storage == "bf16":
        import ml_dtypes

        stored = xb_h.astype(ml_dtypes.bfloat16).astype(np.float64)
        vnorm = (xb_h.astype(np.float64) ** 2).sum(1)
    elif storage == "int8":
        s = np.asarray(jax.device_get(ivf._scales), np.float64)[:sz.d]
        stored = np.clip(np.round(xb_h / s), -127, 127) * s
        vnorm = (stored ** 2).sum(1)
    else:
        stored = xb_h.astype(np.float64)
        vnorm = (stored ** 2).sum(1)
    assign = ivf.quantizer.assign(xb_h).ravel()
    cents = np.stack([ivf.quantizer.reconstruct(j)
                      for j in range(sz.nlist)]).astype(np.float64)
    hits = 0
    for qi in range(8):
        q64 = xq[qi].astype(np.float64)
        probe = np.argsort(((q64[None] - cents) ** 2).sum(1),
                           kind="stable")[:sz.nprobe]
        cand = np.nonzero(np.isin(assign, probe))[0]
        dq = vnorm[cand] - 2.0 * (stored[cand] @ q64)
        want = cand[np.lexsort((cand, dq))[:sz.k]]
        hits += len(set(I[qi].tolist()) & set(want.tolist()))
    r_probe = hits / (8 * sz.k)
    print(f"  ivf {storage} nprobe={sz.nprobe}: recall vs float64 oracle "
          f"over the probed lists {r_probe:.4f}", flush=True)
    # exact within the probed lists, up to f32 near-ties of the probe set
    check(r_probe >= 0.99, f"ivf {storage}: probed-list recall {r_probe}")
    # dense route (nprobe == nlist) against the index's own plain sweep
    params = faiss_tpu.SearchParametersIVF(nprobe=sz.nlist)
    first, steady, (Dd, Id) = timed(ivf.search, xq, sz.k, params=params)
    out, nq = ivf._search_device(xq, sz.k, params, force_xla_dense=True)
    Dx, Ix = (np.asarray(a)[:nq] for a in jax.device_get(out[:2]))
    route = "fused" if ivf._dense_fused_ok(ivf.npool * 128) else "plain XLA"
    print(f"  ivf {storage} nprobe=nlist ({route} dense route): first "
          f"{first:.2f} s, steady {steady:.3f} ms", flush=True)
    compare_to_plain(Dd, Id, Dx, Ix, np.arange(len(xq)),
                     f"ivf {storage} dense")
    check(ivf.fused_fallbacks == 0, f"ivf {storage}: dense fallbacks")
    del ivf


def gpu_tests_phase():
    import os
    import pytest

    os.environ["FAISS_TPU_TEST_PLATFORM"] = "gpu"
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                      "tests/test_gpu_smoke.py"])
    check(rc == 0, f"tests/test_gpu_smoke.py exited {rc}")


def run_single(sz: Sizes, smoke: Smoke):
    import numpy as np
    import jax

    xb = gaussian_rows(sz.flat_nv, sz.d, 0)
    xq = np.asarray(gaussian_rows(sz.nq, sz.d, 1))
    noise = np.asarray(gaussian_rows(sz.nq, sz.d, 2))
    xq_dup = np.asarray(xb[:sz.nq]) + 1e-3 * noise
    t0 = time.perf_counter()
    oracles = {m: oracle_topk(xb, xq[:sz.oracle_nq], sz.k, m, sz.chunk)
               for m in ("l2", "ip")}
    print(f"float64 oracles over {sz.flat_nv} rows: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for storage in sz.storages:
        smoke.run(f"flat_{storage}", flat_phase, sz, storage, xb, xq, xq_dup,
                  oracles)
    del xb
    gc.collect()
    smoke.run("flat_f32_int", flat_int_phase, sz)
    xb = clustered(sz.ivf_nv, sz.d, sz.nlist, 5)
    xq_c = np.asarray(xb[:sz.nq]) + 0.1 * noise
    for storage in sz.ivf_storages:
        smoke.run(f"ivf_{storage}", ivf_phase, sz, storage, xb, xq_c)
    del xb
    gc.collect()
    stats = jax.devices()[0].memory_stats() or {}
    print(f"peak_bytes_in_use {stats.get('peak_bytes_in_use')} "
          f"bytes_in_use {stats.get('bytes_in_use')}", flush=True)
    smoke.run("gpu_tests", gpu_tests_phase)


# -- four cards -----------------------------------------------------------------

def sharded_phase(sz: Sizes):
    import numpy as np
    import jax
    import faiss_tpu

    idx4 = faiss_tpu.ShardedIndexFlat(sz.d, storage="bf16", num_shards=4)
    idx22 = faiss_tpu.ShardedIndexFlat(sz.d, storage="bf16", num_shards=2,
                                       num_replicas=2)
    xq = np.asarray(gaussian_rows(8, sz.d, 101))
    q64 = xq.astype(np.float64)
    best_s = np.full((8, 0), -np.inf)
    best_i = np.zeros((8, 0), np.int64)
    t0 = time.perf_counter()
    for b, r0 in enumerate(range(0, sz.sharded_nv, sz.sharded_batch)):
        n = min(sz.sharded_batch, sz.sharded_nv - r0)
        xb = np.asarray(jax.device_get(gaussian_rows(n, sz.d, 1000 + b)))
        idx4.add(xb)
        idx22.add(xb)
        for c0 in range(0, n, sz.chunk):
            rows = xb[c0:c0 + sz.chunk].astype(np.float64)
            s = 2.0 * (q64 @ rows.T) - (rows * rows).sum(1)[None, :]
            top = np.argsort(-s, axis=1, kind="stable")[:, :sz.k]
            best_s = np.concatenate([best_s, np.take_along_axis(s, top, 1)], 1)
            best_i = np.concatenate([best_i, top + r0 + c0], 1)
            order = np.lexsort((best_i, -best_s), axis=1)[:, :sz.k]
            best_s = np.take_along_axis(best_s, order, 1)
            best_i = np.take_along_axis(best_i, order, 1)
        del xb
    print(f"  added {sz.sharded_nv} rows to both meshes + oracle in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, idx in (("4 shards", idx4), ("2 replicas x 2 shards", idx22)):
        first, steady, (D, I) = timed(idx.search, xq, sz.k)
        Dp, Ip = plain(idx, xq, sz.k)
        print(f"  {name}: search nq=8 first {first:.2f} s, steady "
              f"{steady:.3f} ms; fallbacks {idx.fused_fallbacks}", flush=True)
        compare_to_plain(D, I, Dp, Ip, np.arange(8), name + " fused vs XLA")
        r = recall(I, best_i)
        print(f"  {name}: recall@{sz.k} vs float64 oracle {r:.4f}",
              flush=True)
        check(r >= RECALL_MIN["bf16"], f"{name}: recall {r}")
    shard_bytes = sz.sharded_nv * sz.d * 2 // 4   # one bf16 shard of four
    for dev in jax.devices()[:4]:
        st = dev.memory_stats()
        print(f"  {dev}: bytes_in_use {st and st.get('bytes_in_use')} "
              f"peak {st and st.get('peak_bytes_in_use')}", flush=True)
        if st:
            check(st["bytes_in_use"] >= shard_bytes,
                  f"{dev} does not hold its shards")
    del idx4, idx22
    gc.collect()
    # sharded IVF against one card
    xb = np.asarray(jax.device_get(clustered(sz.sharded_ivf_nv, sz.d,
                                             sz.sharded_ivf_nlist, 11)))
    xq = xb[:64] + 0.1 * np.asarray(gaussian_rows(64, sz.d, 12))
    sh = faiss_tpu.ShardedIndexIVFFlat(sz.d, sz.sharded_ivf_nlist,
                                       storage="bf16", nprobe=sz.nprobe,
                                       num_shards=4, seed=3)
    sh.train(xb)
    sh.add(xb)
    one = faiss_tpu.TpuIndexIVFFlat(sz.d, sz.sharded_ivf_nlist,
                                    storage="bf16", nprobe=sz.nprobe, seed=3)
    one.train(xb)
    one.add(xb)
    first, steady, (Ds, Is) = timed(sh.search, xq, sz.k)
    D1, I1 = one.search(xq, sz.k)
    print(f"  sharded IVF 4 shards {sz.sharded_ivf_nv} rows: first "
          f"{first:.2f} s, steady {steady:.3f} ms", flush=True)
    compare_to_plain(Ds, Is, D1, I1, np.arange(len(xq)),
                     "sharded IVF vs one card")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded phase, on four cards")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU ({devices[0].platform} devices only)",
              file=sys.stderr)
        return 1
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1
    from faiss_tpu.utils.compile_cache import enable_compile_cache

    card = card_line()
    print(card, flush=True)
    label = "; ".join(sorted(set(card.splitlines())))  # one per distinct card
    print(f"jax.devices(): {devices}", flush=True)
    print(f"compile cache: {enable_compile_cache()}", flush=True)
    import faiss_tpu

    caps = faiss_tpu.query_device_capabilities()
    print(caps.describe(), flush=True)
    log = KernelLog()
    smoke = Smoke(label)
    sz = Sizes()
    if args.four_cards:
        smoke.run("sharded_4cards", sharded_phase, sz)
    else:
        if caps.kernel_mode != "compiled":
            print("chip_smoke: kernels would run interpreted",
                  file=sys.stderr)
            return 1
        run_single(sz, smoke)
    print(f"kernel routes (name, backend, interpret): {log.routes()}",
          flush=True)
    print(f"phase wall times [{label}]: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in smoke.times.items()),
          flush=True)
    bad = log.interpreted()
    if bad:
        print(f"chip_smoke: kernels ran in interpret mode: {bad}",
              file=sys.stderr)
        return 1
    if smoke.failed:
        print(f"chip_smoke: failed phases: {smoke.failed}", file=sys.stderr)
        return 1
    d0 = jax.devices()[0]
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
