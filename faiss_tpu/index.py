"""TpuIndexFlat — the flat (brute-force) exact-search index.

≈ MetalIndexFlat (include/faiss-metal/MetalIndexFlat.h:47-121,
src/MetalIndexFlat.mm). API parity map:

    reference                           here
    ---------                           ----
    MetalIndexFlat(res, d, metric,      TpuIndexFlat(d, metric=..., storage=...,
                   StorageType)                      resources=...)
    add(n, x)                           add(x)
    search(n, x, k, D, I)               search(x, k) -> (D, I)
    searchAsync(...) -> token           search_async(x, k) -> TpuSearchToken
    (range_search: not in the reference  range_search(x, radius) ->
     — its faiss::Index base throws)     (lims, D, I), faiss::IndexFlat parity
    (remove_ids: same — base throws)     remove_ids(ids) -> n_removed
    (merge_from: same — base throws)     merge_from(other)  # bit-exact
    reset()                             reset()
    reconstruct(key, out)               reconstruct(key) -> np.ndarray
    getVectorsData()                    vectors_numpy()  (None for bf16/f16)
    isFloat16Storage()/getStorageType   storage_type property
    setForceMPS(bool)                   set_force_xla(bool)  (cross-path testing)
    index_cpu_to_metal/metal_to_cpu     index_cpu_to_tpu/index_tpu_to_cpu
                                        (+ index_numpy_to_tpu, no faiss needed)

Behavioral parity (SURVEY.md §2.3):
  * the whole search is ONE jitted XLA program — distance GEMM + norm epilogue
    + top-k with no host round-trips (reference: one MTLCommandBuffer,
    src/MetalIndexFlat.mm:358-381);
  * k is clamped to ntotal with sentinel fill beyond (+inf/-inf distance,
    label −1; mm:328-337, :384-400); empty index returns all sentinels;
  * per-shard ids are int32 internally, widened to int64 for the user
    (mm:384-400); unlike the reference, k > 8 large-k selection is exact
    (fixes the block_select LOCAL_K=8 truncation, SURVEY.md §2.3.1);
  * norms precomputed fp32 before storage quantization (storage.py).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .dtypes import MetricType, StorageType, worst_distance
from .ops import distance as dist_ops
from .ops import pallas_fused
from .ops import topk as topk_ops
from .resources import TpuResources, default_resources
from . import selector as sel_mod
from .storage import ROW_TILE, DeviceStore, _round_up

# Static-shape compile policy: queries padded to a multiple of this many rows.
NQ_PAD = 8

# range_search: initial per-(query, chunk) extraction capacity; doubles (as a
# power of two, up to the chunk width) when a chunk holds more hits — the
# count output is exact regardless, so one re-run always suffices.
RANGE_CAP0 = 1024


def _masked_scores_block(db, norms, queries, ntotal, split, start, width, *,
                         metric, int8, f16bits, pair_only, use_direct,
                         sel=None):
    """(nq_pad, width) scores for db rows [start, start+width) in the plain
    XLA arithmetic class (fp32-true w.r.t. the stored/decoded vectors),
    padding/invalid columns −inf. `start` may be traced. Shared by the plain
    search path and range_search so their hit criteria can never drift.
    ``sel`` (optional traced (capacity,) bool — selector.SearchParams):
    excluded rows score −inf, exactly like padding."""
    ns = jax.lax.dynamic_slice_in_dim(norms, start, width, axis=0)
    if int8:
        dbs = jax.lax.dynamic_slice_in_dim(db, start, width, axis=0)
        s = dist_ops.int8_scores(queries, split[0], dbs, ns, metric)
    elif f16bits:
        from .storage import decode_f16_bits

        dbs = jax.lax.dynamic_slice_in_dim(db, start, width, axis=0)
        if use_direct and metric is MetricType.L2:
            s = dist_ops.direct_l2_scores(
                queries, decode_f16_bits(dbs))
        else:
            s = dist_ops.f16_scores(queries, dbs, ns, metric)
    elif pair_only:
        dh = jax.lax.dynamic_slice_in_dim(split[0], start, width, axis=0)
        dl = jax.lax.dynamic_slice_in_dim(split[1], start, width, axis=0)
        if use_direct and metric is MetricType.L2:
            s = dist_ops.direct_l2_scores(
                queries,
                dh.astype(jnp.float32) + dl.astype(jnp.float32))
        else:
            s = dist_ops.pair_scores(queries, dh, dl, ns, metric)
    else:
        dbs = jax.lax.dynamic_slice_in_dim(db, start, width, axis=0)
        if use_direct and metric is MetricType.L2:
            s = dist_ops.direct_l2_scores(queries, dbs)
        else:
            s = dist_ops.matmul_scores(queries, dbs, ns, metric)
    col = jax.lax.broadcasted_iota(jnp.int32, (1, width), 1) + start
    valid = col < ntotal
    if sel is not None:
        valid = valid & jax.lax.dynamic_slice_in_dim(
            sel, start, width, axis=0)[None, :]
    return jnp.where(valid, s, -jnp.inf)


def _build_range_fn(*, nv_eff: int, chunk: int, cap: int,
                    metric: MetricType, use_direct: bool, int8: bool,
                    f16bits: bool, pair_only: bool, with_sel: bool = False):
    """One jitted range-search scan over nv_eff/chunk column blocks.

    For each block: count rows whose score beats the (traced) threshold and
    extract the top-``cap`` of them, so one block of scores is live at a time
    (the same never-materialize-nq×nv discipline as the chunked top-k path).
    Returns (counts (nchunks, nq_pad) i32 — EXACT even when a count exceeds
    cap — vals (nchunks, nq_pad, cap) f32 desc, ids (nchunks, nq_pad, cap)
    i32 global column ids; entries past a block's count are −inf/garbage)."""
    assert nv_eff % chunk == 0 and cap <= chunk, (nv_eff, chunk, cap)
    nchunks = nv_eff // chunk

    def fn(db, norms, queries, ntotal, thr, *split):
        sel = None
        if with_sel:
            sel, split = split[0], split[1:]

        def body(c):
            start = c * chunk
            s = _masked_scores_block(
                db, norms, queries, ntotal, split, start, chunk,
                metric=metric, int8=int8, f16bits=f16bits,
                pair_only=pair_only, use_direct=use_direct, sel=sel)
            hit = s > thr  # strict: faiss's dist<radius (L2) / dist>radius (IP)
            counts = jnp.sum(hit, axis=-1, dtype=jnp.int32)
            v, i = topk_ops.topk_scores(jnp.where(hit, s, -jnp.inf), cap)
            return counts, v, i + start
        return jax.lax.map(body, jnp.arange(nchunks, dtype=jnp.int32))

    return jax.jit(fn)


def _range_csr(run_range, nq: int, metric: MetricType):
    """Shared range_search driver + host CSR assembly (TpuIndexFlat and
    ShardedIndexFlat). ``run_range(cap)`` executes the jitted chunk scan and
    returns host (counts (nchunks, nq_pad), vals, ids, cap_used); counts are
    exact regardless of cap, so one capacity-doubling re-run suffices."""
    counts, vals, ids, cap = run_range(RANGE_CAP0)
    cmax = int(counts[:, :nq].max()) if nq else 0
    if cmax > cap:
        counts, vals, ids, cap = run_range(1 << (cmax - 1).bit_length())
        assert int(counts[:, :nq].max()) <= cap
    counts_q = counts[:, :nq].astype(np.int64)          # (nchunks, nq)
    lims = np.zeros(nq + 1, np.int64)
    np.cumsum(counts_q.sum(axis=0), out=lims[1:])
    # vectorized assembly (VERDICT r3 weak #7: the per-(query, chunk) copy
    # loop was hostile at dense hit counts): valid-slot mask in query-major
    # order — np.nonzero enumerates it exactly in CSR segment order — then
    # ONE global lexsort keyed (query, score desc, id asc), which both
    # merges the per-chunk runs and applies the best-first tie order.
    valid = (np.arange(cap)[None, None, :]
             < counts_q.T[:, :, None])                  # (nq, nchunks, cap)
    qq, ch, pp = np.nonzero(valid)
    D = np.asarray(vals)[ch, qq, pp].astype(np.float32, copy=False)
    I = np.asarray(ids)[ch, qq, pp].astype(np.int64)
    order = np.lexsort((I, -D, qq))
    D, I = D[order], I[order]
    if metric is MetricType.L2:
        np.negative(D, out=D)  # scores → squared distances
    return lims, D, I

# Cap on nq·nv·d elements for the direct (per-pair, unexpanded) L2 path
# (reference gates on nv ≤ 256 — MetalDistance.mm:238; we additionally bound
# the materialized (nq, nv, d) difference tensor).
DIRECT_PATH_MAX_ELEMS = 1 << 24


def _build_search_fn(
    *,
    nv_eff: int,
    d_pad: int,
    nq_pad: int,
    k: int,
    metric: MetricType,
    use_direct: bool,
    use_fused: bool,
    chunk: int,
    interpret: bool = False,
    pair_only: bool = False,
    sweep_passes: int = 2,
    int8: bool = False,
    f16bits: bool = False,
    hi_exact: bool = False,
    f16_clean: bool = False,
    with_sel: bool = False,
):
    """Compile one search pipeline for a static (nv_eff, nq_pad, k) shape.

    Returns fn(db, norms, queries, ntotal, *split) -> (distances (nq_pad,k)
    f32, labels (nq_pad,k) i32, certified (nq_pad,) bool). `db` is
    (capacity, d_pad); only the first nv_eff rows participate. Sentinels are
    applied on device. ``pair_only`` (storage.DeviceStore.pair_only): HBM
    holds only the bf16 (hi, lo) pair — `db` is db_hi and `split` is
    (db_hi, db_lo); every path scores against the pair-represented vectors.
    ``with_sel``: fn takes a (capacity,) bool selector stream after
    ``ntotal`` (selector.SearchParams); filtered rows mask out of EVERY
    path — the fused kernels fold the selector into the same pre-masked
    norm stream as padding (pallas_fused), the plain paths into the block
    validity mask.
    """
    k_eff = min(k, nv_eff)

    def _finalize(vals, ids, ntotal):
        """Shared sentinel mapping + k>nv_eff padding (reference mm:384-400)."""
        valid = (ids >= 0) & (ids < ntotal) & (vals > -jnp.inf)
        dists = dist_ops.scores_to_distances(vals, metric)
        dists = jnp.where(valid, dists, worst_distance(metric))
        ids = jnp.where(valid, ids, jnp.int32(-1))
        if k_eff < k:  # k > nv_eff: sentinel-fill the tail (static shapes)
            pad_d = jnp.full((nq_pad, k - k_eff), worst_distance(metric),
                             jnp.float32)
            pad_i = jnp.full((nq_pad, k - k_eff), -1, jnp.int32)
            dists = jnp.concatenate([dists, pad_d], axis=-1)
            ids = jnp.concatenate([ids, pad_i], axis=-1)
        return dists, ids

    masked_block = functools.partial(
        _masked_scores_block, metric=metric, int8=int8, f16bits=f16bits,
        pair_only=pair_only, use_direct=use_direct)

    def fn(db, norms, queries, ntotal, *split):
        sel = None
        if with_sel:
            sel, split = split[0], split[1:]
        if use_fused:
            # Pallas streaming kernel: group-max sweep + gather/rescore
            # (never materializes nq×nv — ops/pallas_fused.py). For fp32
            # storage `split` carries the precomputed bf16 (hi, lo) pair.
            # `cert` proves per-query exactness; uncertified queries are
            # re-run on the plain path by TpuSearchToken.wait().
            # split is (hi, lo, split_stats) for fp32 storage — the stats
            # are the exact v-side maxima the certificate uses — just
            # (split_stats,) for 2 B/elem f16-bits storage (the pair is
            # decoded in-kernel), or (scales, int_norm_max) for int8
            vals, ids, cert = pallas_fused.fused_search(
                queries, db, norms, ntotal,
                k=k, metric=metric, nv_eff=nv_eff, interpret=interpret,
                db_split=None if int8 or f16bits or not split
                else split[:2],
                pair_only=pair_only,
                sweep_passes=sweep_passes,
                split_stats=(split[0] if f16bits and split else
                             None if int8 or not split else split[2]),
                scales=split[0] if int8 else None,
                int_norm_max=split[1] if int8 else None,
                hi_exact=hi_exact,
                f16_clean=f16_clean,
                sel=sel,
            )
            if metric is MetricType.L2:
                # kernel scores omit the rank-invariant −‖q‖² term; restore it
                qn = jnp.sum(queries * queries, axis=-1, dtype=jnp.float32)
                vals = vals - qn[:, None]
            return _finalize(vals, ids, ntotal) + (cert,)

        blk = functools.partial(masked_block, db, norms, queries, ntotal,
                                split, sel=sel)
        if nv_eff > chunk:
            # Two-stage streaming path: never materializes (nq, nv_eff).
            nfull = nv_eff // chunk
            prefix = nfull * chunk
            vals, ids = topk_ops.chunked_topk_scores(
                lambda start: blk(start, chunk), prefix, chunk, k_eff
            )
            tail = nv_eff - prefix
            if tail:
                tv, ti = topk_ops.topk_scores(
                    blk(prefix, tail), min(k_eff, tail)
                )
                vals, ids = topk_ops.merge_topk(vals, ids, tv, ti + prefix, k_eff)
        else:
            vals, ids = topk_ops.topk_scores(blk(0, nv_eff), k_eff)

        # plain paths are exact by construction — certificate always true
        return _finalize(vals, ids, ntotal) + (
            jnp.ones((nq_pad,), jnp.bool_),
        )

    return jax.jit(fn)


class TpuSearchToken:
    """Async search handle (≈ MetalSearchToken, MetalIndexFlat.h:15-36).

    JAX dispatch is natively asynchronous: `search_async` returns as soon as
    the XLA program is enqueued; the device arrays held here own the result
    buffers (the reference's token owns its per-call MTLBuffers,
    src/MetalIndexFlat.mm:17-33). Multiple tokens may be in flight and waited
    in any order. `wait()` blocks and returns (D, I); `is_ready()` polls.

    ``cert``/``fallback``: the fused path ships a per-query exactness
    certificate with the results (ops/pallas_fused.fused_search). If any
    query is uncertified (near-ties at the nomination boundary), ``wait()``
    transparently re-runs ONLY the uncertified query rows through an exact
    path via ``fallback(cert, dists, labels)`` (which patches those rows
    into the certified results) — so the API contract is unconditionally
    exact search, and one near-tie query does not force a full-batch rerun
    (VERDICT r2 weak #5).
    """

    def __init__(self, dists: jax.Array, labels: jax.Array, nq: int,
                 cert: Optional[jax.Array] = None, fallback=None):
        self._dists = dists
        self._labels = labels
        self._cert = cert
        self._fallback = fallback
        self._nq = nq
        self._result: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def wait(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._result is None:
            # one device_get for all outputs: each transfer is a host round
            # trip, so don't pay it twice
            d, i, c = jax.device_get(
                (self._dists, self._labels, self._cert)
            )
            if c is not None and not np.asarray(c).all() and self._fallback:
                self._result = self._fallback(
                    np.asarray(c), np.asarray(d), np.asarray(i))
            else:
                d, i = np.asarray(d)[: self._nq], np.asarray(i)[: self._nq]
                self._result = (
                    np.ascontiguousarray(d, dtype=np.float32),
                    np.ascontiguousarray(i, dtype=np.int64),
                )
            self._dists = self._labels = self._cert = None  # release buffers
            self._fallback = None
        return self._result

    def is_ready(self) -> bool:
        if self._result is not None:
            return True
        try:
            ready = self._dists.is_ready() and self._labels.is_ready()
            if self._cert is not None:
                ready = ready and self._cert.is_ready()
            return bool(ready)
        except AttributeError:
            # unknown runtime: report NOT ready rather than lying (the
            # reference polls real command-buffer status,
            # MetalIndexFlat.mm:74-78); wait() always works regardless
            return False


class ConcatSearchToken:
    """Async handle over several row-chunk tokens of ONE logical search
    (IVF splits oversized query batches so the fine scan's per-dispatch
    score array stays under the gather budget — ADVICE r4). wait()
    concatenates the chunk results in query order; all chunks are already
    enqueued, so they pipeline on device like independent tokens."""

    def __init__(self, toks):
        self._toks = toks
        self._result = None

    def wait(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._result is None:
            parts = [t.wait() for t in self._toks]
            self._result = (
                np.concatenate([p[0] for p in parts], axis=0),
                np.concatenate([p[1] for p in parts], axis=0))
            self._toks = None
        return self._result

    def is_ready(self) -> bool:
        return self._result is not None or all(
            t.is_ready() for t in self._toks)


def make_selective_fallback(index, queries: np.ndarray, nq: int, k: int, *,
                            pad_unit: int, pin_key: int, reduced: bool,
                            to_device=None, sel=None):
    """Tier-1/tier-2 per-query certificate fallback, shared by TpuIndexFlat
    and ShardedIndexFlat (the two copies of this closure drifted once —
    hi_exact, 5de30c8 — so it lives here exactly once).

    When the certificate failed for SOME queries, re-run ONLY those rows,
    gathered into a small pad_unit-aligned batch, and patch them into the
    certified results. Tier 1 (only when this search ran the ``reduced``
    single-pass sweep): the exact-pair fused sweep — ~5× cheaper than
    plain — and pin ``pin_key`` in ``index._no_reduced_sweep`` so the shape
    stops paying tier-1 reruns; tier 2: the plain XLA path, exact by
    construction. ``to_device`` maps the gathered host batch to the
    representation ``index._run_search_fn`` expects (the sharded index
    device_puts it with the replica sharding). Padding-row-only failures
    return the results untouched and are NOT counted as fallbacks. ``sel``:
    the search's selector stream — the reruns MUST keep filtering (a
    certificate failure under a selector would otherwise re-rank against
    the excluded rows)."""

    def fallback(cert_h, d0, i0):
        d_out = np.ascontiguousarray(np.asarray(d0)[:nq], np.float32).copy()
        i_out = np.ascontiguousarray(np.asarray(i0)[:nq], np.int64).copy()
        bad = np.nonzero(~np.asarray(cert_h)[:nq])[0]
        if bad.size == 0:  # only padding rows failed — results exact
            return d_out, i_out
        index.fused_fallbacks += 1  # count only real re-runs
        nb_pad = max(pad_unit, _round_up(bad.size, pad_unit))
        qb = np.zeros((nb_pad, queries.shape[1]), np.float32)
        qb[: bad.size] = queries[bad]
        qd = to_device(qb) if to_device is not None else qb
        todo = np.arange(bad.size)
        if reduced:
            # this shape's margins don't cover the reduced sweep's error
            # bound on this data — use the exact pair from now on
            index._no_reduced_sweep.add(pin_key)
            d2, i2, c2, uf2, _ = index._run_search_fn(
                qd, k, nb_pad, force_plain=False, full_sweep=True, sel=sel)
            d2, i2, c2 = jax.device_get((d2, i2, c2))
            c2 = np.asarray(c2)
            ok = todo[c2[todo]] if uf2 else todo
            d_out[bad[ok]] = np.asarray(d2)[ok]
            i_out[bad[ok]] = np.asarray(i2)[ok]
            todo = todo[~c2[todo]] if uf2 else todo[:0]
            if todo.size == 0:
                return d_out, i_out
        d2, i2, _, _, _ = index._run_search_fn(
            qd, k, nb_pad, force_plain=True, sel=sel)
        d2, i2 = jax.device_get((d2, i2))
        d_out[bad[todo]] = np.asarray(d2)[todo]
        i_out[bad[todo]] = np.asarray(i2)[todo]
        return d_out, i_out

    return fallback


class TpuIndexFlat:
    """Flat exact-search index. See module docstring for parity map."""

    def __init__(
        self,
        d: int,
        metric=MetricType.L2,
        storage=StorageType.FLOAT32,
        resources: Optional[TpuResources] = None,
        tuning=None,
        keep_master: bool = True,
    ):
        self.metric = MetricType.coerce(metric)
        self.storage_type = StorageType.coerce(storage)
        self.res = resources if resources is not None else default_resources()
        # per-index KernelTuning override (the per-kind table in
        # resources.py covers the cards this package was measured on)
        self.tuning = tuning if tuning is not None \
            else self.res.capabilities.tuning
        # keep_master=False (fp32 only): HBM holds just the bf16 (hi, lo)
        # pair (4 B/elem instead of 8); the exact fp32 master lives in host
        # RAM for reconstruct/IO. Search ranks by the hi+lo value (~2^-16
        # relative quantization). See storage.DeviceStore docs.
        self.store = DeviceStore(
            d, self.storage_type, self.metric,
            device=self.res.default_device, keep_master=keep_master,
        )
        self._force_xla = False
        # observability: searches whose fused-path certificate failed and
        # were transparently re-run on the exact plain path
        self.fused_fallbacks = 0
        # shapes (nq_pad) where the reduced single-pass sweep failed to
        # certify on this index's data — switched to the exact-pair sweep
        # to stop paying tier-1 reruns (cleared by reset())
        self._no_reduced_sweep: set = set()

    # -- faiss-style properties ------------------------------------------------
    @property
    def d(self) -> int:
        return self.store.d

    @property
    def ntotal(self) -> int:
        return self.store.ntotal

    @property
    def is_trained(self) -> bool:
        """Flat float storage needs no training (faiss IndexFlat parity);
        int8 storage is trained once its quantization scales are frozen
        (explicit train() or auto-train on the first add batch)."""
        return self.store.is_trained

    def train(self, x: np.ndarray) -> None:
        """Freeze int8 per-dimension scales from a sample (no-op for float
        storage, like faiss IndexFlat::train)."""
        self.store.train(x)

    def is_float16_storage(self) -> bool:
        return self.storage_type is StorageType.FLOAT16

    def is_bfloat16_storage(self) -> bool:
        return self.storage_type is StorageType.BFLOAT16

    def set_force_xla(self, force: bool) -> None:
        """Force the plain-XLA path even where a Pallas kernel exists
        (≈ setForceMPS — cross-path differential testing,
        MetalIndexFlat.h:106)."""
        self._force_xla = bool(force)

    # -- mutation ---------------------------------------------------------------
    def add(self, x: np.ndarray) -> None:
        self.store.add(x)

    def reset(self) -> None:
        self.store.reset()
        self._no_reduced_sweep.clear()  # new data, new margins

    def remove_ids(self, ids) -> int:
        """Remove the given vector ids; remaining vectors keep their order
        and renumber down (faiss::IndexFlat::remove_ids semantics — the
        reference never implements removal, its faiss::Index base throws).
        Returns the number of vectors removed. Duplicate ids count once;
        out-of-range ids raise IndexError. One jitted, donated device gather
        per stored array — no host round-trip of the database."""
        ids = np.unique(np.asarray(ids, np.int64).ravel())
        if ids.size == 0:
            return 0
        if ids[0] < 0 or ids[-1] >= self.ntotal:
            raise IndexError(
                f"remove_ids: ids outside [0, {self.ntotal}): "
                f"[{ids[0]}, {ids[-1]}]")
        keep = np.setdiff1d(np.arange(self.ntotal, dtype=np.int64), ids,
                            assume_unique=True)
        self.store.remove_rows(keep)
        self._no_reduced_sweep.clear()  # new data, new margins
        return int(ids.size)

    def merge_from(self, other: "TpuIndexFlat") -> None:
        """faiss::IndexFlat::merge_from semantics: append ``other``'s
        vectors to self (their ids continue at self.ntotal, insertion order
        preserved) and empty ``other``. Bit-exact for every storage mode —
        raw planes, pre-quantization norms, and certificate statistics
        transfer at the storage level (DeviceStore.merge_storage); searching
        the merged index equals searching an index built by the same add()
        sequence. The reference never implements merging (faiss::Index base
        throws)."""
        if other is self:
            raise ValueError("cannot merge an index into itself")
        if other.d != self.d or other.metric is not self.metric:
            raise ValueError(
                f"merge_from: d/metric mismatch "
                f"(({self.d}, {self.metric}) vs ({other.d}, {other.metric}))")
        self.store.merge_storage(other.store)
        self._no_reduced_sweep.clear()  # new data, new margins
        other.reset()

    def reconstruct(self, key: int) -> np.ndarray:
        return self.store.reconstruct(key)

    def reconstruct_n(self, i0: int, n: int) -> np.ndarray:
        return self.store.reconstruct_n(i0, n)

    def vectors_numpy(self) -> Optional[np.ndarray]:
        return self.store.vectors_numpy()

    # -- search -------------------------------------------------------------------
    def _prep_queries(self, x: np.ndarray) -> Tuple[np.ndarray, int, int]:
        """Pad on the host (numpy) and let the jitted call do ONE transfer —
        separate asarray/pad/device_put ops would each cost a dispatch."""
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected (n, {self.d}) queries, got {x.shape}")
        nq = x.shape[0]
        nq_pad = max(NQ_PAD, _round_up(nq, NQ_PAD))
        d_pad = self.store.d_pad
        if nq_pad != nq or d_pad != self.d:
            q = np.zeros((nq_pad, d_pad), np.float32)
            q[:nq, : self.d] = x
        else:
            q = x
        return q, nq, nq_pad

    def _empty_result(self, nq: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
        d = np.full((nq, k), worst_distance(self.metric), np.float32)
        i = np.full((nq, k), -1, np.int64)
        return d, i

    def _run_search_fn(self, q, k: int, nq_pad: int, *, force_plain: bool,
                       full_sweep: bool = False, sel=None):
        """Build (cached) + enqueue one search program for the current shape.

        Returns (dists, labels, cert) unrealized device arrays.
        ``full_sweep`` forces the exact-pair nomination sweep (used by the
        two-tier certificate fallback before resorting to the plain path).
        ``sel`` (device (capacity,) bool, selector.SearchParams): restrict
        the search to admitted rows — honored by EVERY dispatch path,
        including the fused sweep (the selector folds into the pre-masked
        norm stream like padding)."""
        nv_eff = _round_up(self.ntotal, ROW_TILE)
        tuning = self.tuning
        is_int8 = self.storage_type is StorageType.INT8
        is_f16 = self.storage_type is StorageType.FLOAT16
        use_direct = (
            self.metric is MetricType.L2
            and not is_int8
            and nv_eff <= dist_ops.DIRECT_PATH_MAX_NV * 4
            and nq_pad * nv_eff * self.store.d_pad <= DIRECT_PATH_MAX_ELEMS
        )
        # hi_exact: the stored EXACT split statistics prove the lo/residual
        # planes are all-zero (integer-valued data, e.g. SIFT) — the fused
        # path then sweeps/rescores the hi bf16 plane alone, bit-identical
        # at half the sweep traffic, the cost gate sees the EFFECTIVE
        # 2 B/elem sweep, and the reduced single-pass policy applies as if
        # this were bf16 storage (RNE queries round exactly on such data's
        # near-tie structure far more often than Gaussian)
        stats_zero = (not is_int8 and not is_f16
                      and self.store.db_hi is not None
                      and self.store.split_stats_host() == (0.0, 0.0))
        use_fused = (
            not force_plain
            and not self._force_xla
            and not use_direct
            and pallas_fused.fused_path_eligible(
                metric=self.metric, k=int(k), nv_eff=nv_eff,
                d_pad=self.store.d_pad, nq_pad=nq_pad,
                itemsize=2 if stats_zero
                else jnp.dtype(self.store.dtype).itemsize,
                dtype=self.store.dtype,
            )
        )
        # adaptive reduced-sweep policy: once the single-pass certificate
        # fails at a shape (data-dependent — near-boundary margins vs the
        # RNE error bound), stop paying the tier-1 rerun there and go
        # straight to the exact-pair sweep for that shape
        pair_storage = self.store.dtype != jnp.bfloat16
        hi_exact = use_fused and stats_zero
        # f16 bits proven subnormal/inf/NaN-free → lean in-kernel decode
        f16_clean = is_f16 and self.store.f16_clean()
        sweep_passes = 2 if (full_sweep or nq_pad in self._no_reduced_sweep) \
            else pallas_fused.pick_sweep_passes(
                nq_pad, pair_storage and not hi_exact)
        interpret = self.res.capabilities.interpret
        pair_only = self.store.pair_only
        with_sel = sel is not None
        key = (
            "flat_search", nv_eff, self.store.d_pad, nq_pad, int(k),
            self.metric, self.storage_type, use_direct, use_fused,
            tuning.chunk_v, pair_only, sweep_passes, hi_exact, f16_clean,
            with_sel,
        )
        fn = self.res.cached(
            key,
            lambda: _build_search_fn(
                nv_eff=nv_eff,
                d_pad=self.store.d_pad,
                nq_pad=nq_pad,
                k=int(k),
                metric=self.metric,
                use_direct=use_direct,
                use_fused=use_fused,
                chunk=tuning.chunk_v,
                interpret=interpret,
                pair_only=pair_only,
                sweep_passes=sweep_passes,
                int8=is_int8,
                f16bits=is_f16,
                hi_exact=hi_exact,
                f16_clean=f16_clean,
                with_sel=with_sel,
            ),
        )
        split = ()
        if is_int8:
            split = (self.store.scales, self.store.int_norm_max)
        elif is_f16:
            if use_fused:
                split = (self.store.split_stats,)
        elif self.store.db_hi is not None and (use_fused or pair_only):
            split = (self.store.db_hi, self.store.db_lo,
                     self.store.split_stats)
        if with_sel:
            split = (sel,) + split
        db_arg = self.store.db if self.store.db is not None else self.store.db_hi
        # the last element tells the fallback whether THIS search ran the
        # reduced single-pass sweep (tier-1 rerun + shape pinning apply);
        # returning it beats re-deriving the dispatch at the call site,
        # which drifted once already (hi_exact, commit 5de30c8)
        return fn(
            db_arg, self.store.norms, q, self.store.ntotal_dev,
            *split,
        ) + (use_fused, use_fused and sweep_passes == 1)

    def _sel_stream(self, params):
        """Evaluate ``params``' selector over this index's positional ids →
        (capacity,) device bool stream, or None when nothing is filtered
        (including the all-admitted selector, which keeps the fused path —
        the result is identical by construction). Rows past ntotal are
        False, matching the freshly-allocated padding state."""
        sel_mod.reject_ivf_params(params)
        if getattr(params, "sel", None) is None:
            sel_mod.selector_mask(params, np.empty(0, np.int64))  # validate
            return None
        mask = sel_mod.selector_mask(
            params, np.arange(self.ntotal, dtype=np.int64))
        if mask is None or mask.all():
            return None
        pad = np.zeros((self.store.capacity,), dtype=bool)
        pad[: self.ntotal] = mask
        return self.store._put(jnp.asarray(pad))

    def _search_device(self, x: np.ndarray, k: int, params=None):
        """Enqueue the search; returns an unrealized token + nq."""
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        q, nq, nq_pad = self._prep_queries(x)
        if self.ntotal == 0:
            sel_mod.selector_mask(params, np.empty(0, np.int64))  # validate
            return None, nq, nq_pad  # resolved on host, reference mm:328-334
        sel = self._sel_stream(params)
        dists, labels, cert, use_fused, reduced = self._run_search_fn(
            q, k, nq_pad, force_plain=False, sel=sel)
        fallback = None
        if use_fused:
            fallback = make_selective_fallback(
                self, q, nq, k, pad_unit=NQ_PAD, pin_key=nq_pad,
                reduced=reduced, sel=sel)
        return (dists, labels, cert, fallback), nq, nq_pad

    def search(self, x: np.ndarray, k: int,
               params=None) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k search. Returns (distances f32 (nq,k), labels i64
        (nq,k)). ``params`` (selector.SearchParams): restrict the search to
        the selector-admitted rows — honored exactly (the reference accepts
        and silently IGNORES its params argument, MetalIndexFlat.mm:313-319;
        see selector.py)."""
        out, nq, _ = self._search_device(x, k, params)
        if out is None:
            return self._empty_result(nq, k)
        return TpuSearchToken(out[0], out[1], nq, out[2], out[3]).wait()

    def search_async(self, x: np.ndarray, k: int,
                     params=None) -> TpuSearchToken:
        """Non-blocking search (≈ searchAsync, MetalIndexFlat.mm:403-490)."""
        out, nq, _ = self._search_device(x, k, params)
        if out is None:
            tok = TpuSearchToken(None, None, nq)
            tok._result = self._empty_result(nq, k)
            return tok
        return TpuSearchToken(out[0], out[1], nq, out[2], out[3])

    def assign(self, x: np.ndarray, k: int = 1) -> np.ndarray:
        """Labels-only search (faiss::Index::assign — the reference inherits
        it from the faiss base, MetalIndexFlat.h:47). Returns (nq, k) i64.

        Chunks huge query batches on the host: assign() is the bulk path,
        and one 1M-query search against a 4096-row centroid table would
        materialize a 16 GB score matrix in the plain path's single block.
        Chunks are sized by
        what a search dispatch actually keeps live PER QUERY (ADVICE r4 —
        sizing on the full (nq, nv) matrix floored big-index assigns to
        8-query sweeps of the whole database): one (nq, nv_eff) block when
        nv_eff fits a single chunk, else the larger of a streamed
        (nq, chunk_v) score block and the fused sweep's (nq, nv_eff/128)
        group maxes. In-flight tokens are bounded — each pending token pins
        its padded query buffer on device."""
        x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, self.d)
        nv_eff = max(_round_up(max(self.ntotal, 1), ROW_TILE), ROW_TILE)
        budget = 256 << 20  # bytes of live f32 scores per enqueued chunk
        per_q = 4 * (nv_eff if nv_eff <= self.tuning.chunk_v
                     else max(self.tuning.chunk_v, nv_eff // 128))
        nq_chunk = max(NQ_PAD, (budget // per_q) // NQ_PAD * NQ_PAD)
        if len(x) <= nq_chunk:
            return self.search(x, k)[1]
        # enqueue chunks ahead of the waits (the dispatches pipeline instead
        # of paying a blocking round trip per chunk), but keep at most
        # MAX_INFLIGHT enqueued: wait() pops the oldest while newer chunks
        # keep the device busy
        MAX_INFLIGHT = 32
        from collections import deque

        toks: deque = deque()
        out = []
        for i0 in range(0, len(x), nq_chunk):
            if len(toks) >= MAX_INFLIGHT:
                out.append(toks.popleft().wait()[1])
            toks.append(self.search_async(x[i0:i0 + nq_chunk], k))
        out.extend(t.wait()[1] for t in toks)
        return np.concatenate(out, axis=0)

    def search_and_reconstruct(
        self, x: np.ndarray, k: int, params=None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """faiss::Index::search_and_reconstruct: top-k search plus the
        DECODED stored vectors of every result, R (nq, k, d) f32 (the same
        bits reconstruct() returns — for reduced-precision storage that is
        the dequantized row, not the original input). Sentinel -1 rows of R
        are zero-filled. One batched device gather over the unique labels
        + numpy fancy-indexing — loop-free (VERDICT r3 weak #7)."""
        D, I = self.search(x, k, params=params)
        R = np.zeros((I.shape[0], I.shape[1], self.d), dtype=np.float32)
        pos = I >= 0
        if pos.any():
            uniq, inv = np.unique(I[pos], return_inverse=True)
            R[pos] = self.store.reconstruct_batch(uniq)[inv]
        return D, I, R

    # -- range search ---------------------------------------------------------
    def _run_range_fn(self, q, nq_pad: int, thr: np.float32, cap: int,
                      sel=None):
        """Build (cached) + run one range-search scan at the current shape.
        Returns host (counts (nchunks, nq_pad), vals, ids) arrays."""
        nv_eff = _round_up(self.ntotal, ROW_TILE)
        tuning = self.tuning
        chunk = min(tuning.chunk_v, nv_eff)
        while nv_eff % chunk:       # largest ≤chunk_v divisor of nv_eff that
            chunk -= ROW_TILE       # is a ROW_TILE multiple (≥ ROW_TILE)
        cap = min(cap, chunk)
        is_int8 = self.storage_type is StorageType.INT8
        is_f16 = self.storage_type is StorageType.FLOAT16
        use_direct = (
            self.metric is MetricType.L2
            and not is_int8
            and nv_eff <= dist_ops.DIRECT_PATH_MAX_NV * 4
            and nq_pad * nv_eff * self.store.d_pad <= DIRECT_PATH_MAX_ELEMS
        )
        pair_only = self.store.pair_only
        if (nv_eff // chunk) * nq_pad * cap * 8 > (2 << 30):
            raise ValueError(
                "range_search result buffers would exceed 2 GB "
                f"(~{(nv_eff // chunk) * nq_pad * cap} candidate slots); "
                "split the query batch or tighten the radius")
        with_sel = sel is not None
        key = ("range_search", nv_eff, self.store.d_pad, nq_pad, self.metric,
               self.storage_type, use_direct, chunk, cap, pair_only, with_sel)
        fn = self.res.cached(
            key,
            lambda: _build_range_fn(
                nv_eff=nv_eff, chunk=chunk, cap=cap, metric=self.metric,
                use_direct=use_direct, int8=is_int8, f16bits=is_f16,
                pair_only=pair_only, with_sel=with_sel,
            ),
        )
        if is_int8:
            split = (self.store.scales,)
        elif pair_only:
            split = (self.store.db_hi, self.store.db_lo)
        else:
            split = ()
        if with_sel:
            split = (sel,) + split
        db_arg = (self.store.db if self.store.db is not None
                  else self.store.db_hi)
        counts, vals, ids = fn(db_arg, self.store.norms, q,
                               self.store.ntotal_dev, thr, *split)
        return jax.device_get((counts, vals, ids)) + (cap,)

    def range_search(
        self, x: np.ndarray, radius: float, params=None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All neighbors within ``radius`` of each query, faiss CSR layout:
        (lims (nq+1,) i64, D (lims[nq],) f32, I (lims[nq],) i64) with query
        q's results in D[lims[q]:lims[q+1]] sorted best-first. Criterion is
        faiss's (strict): squared-L2 distance < radius for L2, inner product
        > radius for IP, evaluated in the plain path's arithmetic class
        (fp32-true w.r.t. the stored/decoded vectors — identical to what
        search() would rank for the same rows).

        Beyond the reference surface: MetalIndexFlat never implements
        range_search (its faiss::Index base throws, faiss Index.h) — the
        semantics here follow faiss::IndexFlat::range_search so converted
        users keep the API. Static-shape discipline: a jitted chunk scan counts
        and extracts hits at a static capacity; a chunk whose hit count
        exceeds it triggers ONE re-run at the next power of two (counts are
        exact either way), so results are complete for any radius."""
        q, nq, nq_pad = self._prep_queries(x)
        if self.ntotal == 0:
            sel_mod.selector_mask(params, np.empty(0, np.int64))  # validate
            return (np.zeros(nq + 1, np.int64), np.empty(0, np.float32),
                    np.empty(0, np.int64))
        sel = self._sel_stream(params)
        thr = np.float32(-radius if self.metric is MetricType.L2 else radius)
        return _range_csr(
            lambda cap: self._run_range_fn(q, nq_pad, thr, cap, sel=sel),
            nq, self.metric)

    def describe(self) -> str:
        """Observability hook (≈ describeCapabilities +
        the index's own config; SURVEY.md §5.5)."""
        hbm = self.store.hbm_bytes()
        per = (hbm / (self.store.capacity * self.store.d_pad)
               if self.store.capacity else 0.0)
        int8_note = ""
        if self.storage_type is StorageType.INT8:
            int8_note = (f"int8_clipped_fraction="
                         f"{self.store.int8_clipped_fraction:.2e}, ")
        elif self.storage_type is StorageType.FLOAT16:
            int8_note = f"f16_clean={self.store.f16_clean()}, "
        elif self.store.db_hi is not None and self.ntotal:
            int8_note = (f"hi_exact="
                         f"{self.store.split_stats_host() == (0.0, 0.0)}, ")
        return (
            f"TpuIndexFlat(d={self.d}, metric={self.metric.value}, "
            f"storage={self.storage_type.value}, ntotal={self.ntotal}, "
            f"capacity={self.store.capacity}, d_pad={self.store.d_pad}, "
            f"force_xla={self._force_xla}, fused_fallbacks="
            f"{self.fused_fallbacks}, "
            f"reduced_sweep_disabled_shapes={sorted(self._no_reduced_sweep)},"
            f" {int8_note}\n"
            f"  hbm={hbm / 1e6:.1f} MB ({per:.2f} B/elem, "
            f"pair_only={self.store.pair_only}))\n" + self.res.describe()
        )


# -- conversions (≈ index_cpu_to_metal / index_metal_to_cpu,
#    src/MetalIndexFlat.mm:552-587) ------------------------------------------


def index_numpy_to_tpu(
    xb: np.ndarray,
    metric=MetricType.L2,
    storage=StorageType.FLOAT32,
    resources: Optional[TpuResources] = None,
) -> TpuIndexFlat:
    """Build a TpuIndexFlat directly from an (n, d) fp32 matrix."""
    xb = np.ascontiguousarray(xb, dtype=np.float32)
    idx = TpuIndexFlat(xb.shape[1], metric=metric, storage=storage,
                       resources=resources)
    idx.add(xb)
    return idx


def _faiss():
    try:
        import faiss  # type: ignore
        return faiss
    except ImportError as e:
        raise ImportError(
            "faiss is not installed; use index_numpy_to_tpu / vectors_numpy "
            "for numpy-based interchange"
        ) from e


def index_cpu_to_tpu(
    cpu_index,
    storage=StorageType.FLOAT32,
    resources: Optional[TpuResources] = None,
) -> TpuIndexFlat:
    """CPU faiss.IndexFlat → TpuIndexFlat (copies vectors to device)."""
    faiss = _faiss()
    metric = (MetricType.L2 if cpu_index.metric_type == faiss.METRIC_L2
              else MetricType.INNER_PRODUCT)
    xb = cpu_index.reconstruct_n(0, cpu_index.ntotal)
    idx = TpuIndexFlat(cpu_index.d, metric=metric, storage=storage,
                       resources=resources)
    idx.add(np.asarray(xb, dtype=np.float32).reshape(cpu_index.ntotal, cpu_index.d))
    return idx


def index_tpu_to_cpu(tpu_index: TpuIndexFlat):
    """TpuIndexFlat → CPU faiss.IndexFlat. fp32 storage round-trips exactly;
    reduced precision goes through decode (reconstruct), like the reference's
    per-vector slow path (MetalIndexFlat.mm:567-587)."""
    faiss = _faiss()
    metric = (faiss.METRIC_L2 if tpu_index.metric is MetricType.L2
              else faiss.METRIC_INNER_PRODUCT)
    cpu = faiss.IndexFlat(tpu_index.d, metric)
    if tpu_index.ntotal:
        xb = tpu_index.vectors_numpy()
        if xb is None:
            xb = tpu_index.reconstruct_n(0, tpu_index.ntotal)
        cpu.add(xb)
    return cpu
