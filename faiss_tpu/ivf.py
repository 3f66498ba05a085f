"""IVF-Flat index (faiss::IndexIVFFlat parity — beyond the reference
surface).

The reference framework is MetalIndexFlat only; faiss users deploying at
scale run IndexIVFFlat (faiss/IndexIVFFlat.h): a coarse k-means quantizer
routes every vector to one of ``nlist`` inverted lists, and search scans
only the ``nprobe`` lists whose centroids are closest to the query —
trading recall for a ~nlist/nprobe scan reduction.

Accelerator-first design (nothing like faiss's pointer-chasing
InvertedLists):

  * CHUNK-PAGED POOL storage: one (npool·128, d_pad) device tensor of
    128-row chunks (pool doubles; 128 = the fused path's GROUP) plus
    per-slot norms and insertion ids. A (nlist, maxc) int32 PAGE TABLE
    maps each list's j-th chunk to its pool chunk, so device memory, gather
    traffic, and the dense sweep all follow OCCUPANCY — a skewed list-size
    distribution costs what it stores, never nlist × max-list (a per-list
    padded tensor held 17× the live rows on real k-means output and was
    un-allocatable at 10M rows). Static shapes — the compiled search
    program is keyed on (npool, maxc, nprobe, k, nq_pad) only.
  * Coarse probe = one GEMM against the centroids (the shared
    ``matmul_scores`` convention) + ``lax.top_k`` — identical arithmetic
    to the quantizer's own flat search.
  * Fine scan = the probed lists' occupied chunks laid out contiguously
    per query (``_chunk_ids``), gathered chunk-wise with one ``take`` and
    scored with one batched ``dot_general`` per query block (lax.map over
    query blocks bounds the gather working set); search and range_search
    share the block. No data-dependent shapes anywhere (empty / short
    lists are masked, never branched on).
  * add() keeps the data on device: the coarse assignment comes back to
    the host (n int32 — tiny), page-table growth and slot indices are
    host arithmetic on the counts mirror, and the rows land with one
    donated scatter. Pool growth appends chunks — slots never move.

Distances are computed exactly (same fp32-true-to-stored-bits class as
the flat plain path), so ``nprobe == nlist`` reproduces TpuIndexFlat
results; smaller nprobe trades recall exactly like faiss.

Reference for API semantics: faiss/IndexIVF.h (train/add/search/nprobe,
reconstruct via direct map; untrained add raises).

Design note — skew: the fine scan's per-shape budget is the ``sum of the
nprobe largest per-list chunk counts`` — a skewed list-size distribution
pays for the lists a probe can actually hit. The page table extends the
same occupancy-proportionality to device memory and the dense sweep
(``describe()`` reports ``bucket_load`` = rows per occupied slot).

IVF recall is data-dependent by construction (faiss semantics, not a
quality bug): on unclusterable data (pure i.i.d. Gaussian) true neighbors
scatter across cells and low-nprobe recall is poor; on clusterable
embeddings recall@nprobe≪nlist is high.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .clustering import Kmeans
from .dtypes import MetricType, StorageType, worst_distance
from .index import RANGE_CAP0, _range_csr
from .ops import distance as dist_ops
from .resources import TpuResources, default_resources
from . import selector as sel_mod
from .storage import LANE, _round_up

__all__ = ["TpuIndexIVFFlat"]

_QB = 8            # query rows per fine-scan block (static)
_POOL0 = 8         # initial chunk-pool capacity (chunks; doubles)
_GATHER_BUDGET = 512 << 20  # bytes of gathered candidates per block
# fine-scan sub-bucket granularity (rows): the gather walks CHUNK-row
# pieces of the probed lists instead of whole cap-row buckets, so a
# skewed list-size distribution no longer makes every probe pay for the
# largest list (k-means on 1M mixture data produced cap=16384 at mean size
# 977 — the whole-bucket gather moved 16.8x the live rows). 128 rows = the
# fused path's GROUP, so one chunk is one contiguous take slice.
_CHUNK = 128


def _chunk_ids(probe, counts, ctable, chunk: int, nbudget: int,
               nprobe: int):
    """Lay the probed lists' OCCUPIED chunks out contiguously per query:
    (cidx (nq, nbudget) int32 POOL chunk ids, okc (nq, nbudget) bool —
    False for over-budget positions, which point at chunk 0 and must be
    post-masked). ``ctable`` (nlist, maxc) int32 is the page table: entry
    [l, j] is the pool chunk holding list l's rows [j·chunk, (j+1)·chunk)."""
    maxc = ctable.shape[1]
    cnt = jnp.take(counts, probe, axis=0)            # (nq, nprobe)
    ccnt = -(-cnt // chunk)                          # chunks per probed list
    offs = jnp.cumsum(ccnt, axis=-1) - ccnt          # exclusive prefix
    pos = jax.lax.iota(jnp.int32, nbudget)
    # owner of budget position p = last probed list whose offset ≤ p
    # (nprobe ≤ 64 → the compare tensor is tiny)
    li = jnp.sum((offs[:, :, None] <= pos[None, None, :]).astype(jnp.int32),
                 axis=1) - 1
    li = jnp.clip(li, 0, nprobe - 1)
    within = pos[None, :] - jnp.take_along_axis(offs, li, axis=-1)
    okc = within < jnp.take_along_axis(ccnt, li, axis=-1)
    lst = jnp.take_along_axis(probe, li, axis=-1)
    # page-table lookup: (list, within) -> pool chunk (a tiny gather —
    # nlist·maxc int32, nothing like the row gather it steers)
    cidx = jnp.take(ctable.reshape(-1),
                    lst * maxc + jnp.where(okc, within, 0), axis=0)
    return jnp.where(okc, cidx, 0), okc


def _round_budget(b: int) -> int:
    """Round a chunk budget up to ~2 significant bits (≤25% slack) so the
    compiled-fn cache sees a handful of budget shapes per octave instead
    of one per add batch."""
    b = max(b, 1)
    step = 1 << max(0, b.bit_length() - 3)
    return -(-b // step) * step


def _chunk_budget(counts: np.ndarray, nprobe: int, chunk: int) -> int:
    """Static per-query chunk budget: the sum of the ``nprobe`` largest
    per-list chunk counts — an exact upper bound over ANY probe set, so
    results are always complete within the probed lists. Quantized by
    _round_budget for cache stability."""
    ccnt = -(-counts.astype(np.int64) // chunk)
    top = np.sort(ccnt)[-nprobe:] if nprobe < ccnt.size else ccnt
    return _round_budget(int(top.sum()))


def _probed_scores(*, nprobe: int, metric: MetricType,
                   kind: str, with_sel: bool, nbudget: int):
    """Shared fine-scan block: gather the probed lists' OCCUPIED chunks for
    a QB-query slice and score them — search and range_search use the SAME
    criterion (like the flat index's `_masked_scores_block` discipline).

    Chunked two-level gather (r4): each query walks ``nbudget`` CHUNK-row
    pieces laid out per probed list by its actual occupancy — empty lists
    contribute nothing and a skewed distribution pays the sum of its
    nprobe largest lists, not nprobe × the global cap (the whole-bucket
    gather lost to the flat sweep on skewed 1M data). Chunk
    positions map to (list, within) via one rank-vs-offsets comparison;
    over-budget positions clamp to slot 0 and mask −inf.

    ``kind``: "f32" (HIGHEST fp32 dot), "bf16" (exact 3-way query split —
    fp32-true to the quantized rows) or "int8" (rows decode to bf16
    EXACTLY, the query side is the exact split of q∘s — the flat index's
    dist_ops.int8_scores contract; the gather moves 1 B/elem).

    Returns block(data, norms, counts, ids, ctable, sel, q, qeff, qn,
    probe, b) -> (scores (QB, ncand) with invalid/filtered -inf, cid
    (QB, ncand)); ``qeff`` is the dot-side query (q for float kinds,
    q∘scales for int8)."""
    chunk = _CHUNK
    ncand = nbudget * chunk

    def block(data, norms, counts, ids, ctable, sel, q, qeff, qn, probe, b):
        qs = jax.lax.dynamic_slice_in_dim(qeff, b * _QB, _QB, axis=0)
        qns = jax.lax.dynamic_slice_in_dim(qn, b * _QB, _QB, axis=0)
        pr = jax.lax.dynamic_slice_in_dim(probe, b * _QB, _QB, axis=0)
        cidx, okc = _chunk_ids(pr, counts, ctable, chunk, nbudget, nprobe)
        # CHUNK-granular gather: reshape the slot-major tensors so one take
        # row moves one whole chunk contiguously
        d_pad = data.shape[1]
        cand = jnp.take(data.reshape(-1, chunk * d_pad), cidx, axis=0
                        ).reshape(_QB, ncand, d_pad)
        cnn = jnp.take(norms.reshape(-1, chunk), cidx, axis=0
                       ).reshape(_QB, ncand)
        cid = jnp.take(ids.reshape(-1, chunk), cidx, axis=0
                       ).reshape(_QB, ncand)
        # slot validity == occupancy: ids are −1 in empty/padding slots
        valid = okc[:, :, None] & (
            cid.reshape(_QB, nbudget, chunk) >= 0)
        valid = valid.reshape(_QB, ncand)
        if with_sel:
            # selector stream indexed by SLOT (selector.SearchParams):
            # filtered rows mask out exactly like padding
            valid = valid & jnp.take(sel.reshape(-1, chunk), cidx, axis=0
                                     ).reshape(_QB, ncand)
        # fine distances, fp32-true to the stored bits (plain-path
        # arithmetic class): one batched dot per block
        if kind == "f32":
            dots = jax.lax.dot_general(
                cand, qs, (((2,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)
        else:
            # bf16 rows (int8 rows cast EXACTLY — |code| ≤ 127) against the
            # exact 3-way query split, stacked so the rows are read once:
            # fp32-true to the stored / decoded rows
            from .storage import split3_f32_bf16

            if kind == "int8":
                cand = cand.astype(jnp.bfloat16)
            q3 = jnp.stack(split3_f32_bf16(qs), axis=1)   # (QB, 3, d)
            dots = jnp.sum(jax.lax.dot_general(
                cand, q3, (((2,), (2,)), ((0,), (0,))),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.DEFAULT), axis=-1)
        if metric is MetricType.L2:
            # int8: cnn are the DECODED ‖v̂‖² (storage._quantize_int8_fn),
            # matching dots = (q∘s)·v_q = q·v̂ — the self-consistent contract
            s = 2.0 * dots - cnn - qns[:, None]
        else:
            s = dots
        return jnp.where(valid, s, -jnp.inf), cid

    return block


def _kernel_scan(data, norms, counts, ids, ctable, sel, qeff, qn, probe, *,
                 nbudget, nprobe, k, metric, interpret):
    """Gather-route fine scan through ops/ivf_scan's kernel: (top-k scores
    (nq, k) with −ρ‖q‖² already applied for L2, their insertion ids)."""
    from .ops import ivf_scan
    from .ops import topk as topk_ops

    cidx, okc = _chunk_ids(probe, counts, ctable, _CHUNK, nbudget, nprobe)
    valid = ids >= 0            # slot validity (counts + removals)
    if sel is not None:
        valid = valid & sel
    s = ivf_scan.scan_chunks(qeff, qn, cidx, okc, data, norms, valid,
                             metric=metric, interpret=interpret)
    v, pos = topk_ops.topk_scores(s, k)
    slot = (jnp.take_along_axis(cidx, pos // _CHUNK, axis=-1) * _CHUNK
            + pos % _CHUNK)
    return v, jnp.take(ids, slot, axis=0)


def _build_ivf_search_fn(*, nlist: int, nprobe: int, nq_pad: int,
                         k: int, d_pad: int, metric: MetricType,
                         kind: str, nbudget: int, nsweep: int = 0,
                         with_sel: bool = False, dense_fused: bool = False,
                         interpret: bool = False, xla_scan: bool = False):
    """fn(data (npool·128, d_pad), norms (npool·128,), counts (nlist,) i32,
    ids (npool·128,) i32, ctable (nlist, maxc) i32, cents (nlist_pad,
    d_pad), cnorms (nlist_pad,), q (nq_pad, d_pad) [, sel (npool·128,)
    bool] [, scales (d_pad,) — int8])
    -> (dists (nq_pad, k) f32, labels (nq_pad, k) i32).

    One jitted program: coarse GEMM -> top-nprobe -> fine scan -> top-k.

    Storage is a chunk-paged pool (one 128-row chunk = one page; ``ctable``
    is the page table), so device memory and the dense sweep cost follow
    OCCUPANCY, not nlist × the largest list.

    Fine scan: the probed chunk ids feed the chunk-scan kernel
    (ops/ivf_scan.py — each program reads its chunks once and writes their
    scores; no gathered copy of the rows), then one top_k per query. Slot
    validity (occupancy + selector) masks −inf. ``xla_scan`` runs the plain
    XLA form instead — lax.map over _QB-query blocks of ``_probed_scores``
    (chunk take + one batched dot), the block range_search uses.
    """
    chunk = _CHUNK
    ncand = nbudget * chunk
    k_eff = min(k, ncand)
    nblocks = nq_pad // _QB
    # nprobe == nlist (exhaustive): probing is a no-op — skip the coarse
    # GEMM and the per-query gather entirely and SWEEP the pool like the
    # flat plain path (shared across the batch; a per-query gather of the
    # whole database would cost nq× the sweep). The chunk-paged pool keeps
    # this within ~1/load of a true flat sweep (load = live rows per
    # occupied chunk, ≈ 0.9 for mean list sizes ≫ 128).
    dense = nprobe >= nlist
    if not dense and xla_scan:
        scores_blk = _probed_scores(nprobe=nprobe, metric=metric,
                                    kind=kind, with_sel=with_sel,
                                    nbudget=nbudget)

    def fn(data, norms, counts, ids, ctable, cents, cnorms, q, sel=None,
           scales=None, inorm=None):
        qn = jnp.sum(q * q, axis=-1, dtype=jnp.float32)
        qeff = q * scales[None, :] if kind == "int8" else q
        if dense:
            from .ops import topk as topk_ops

            # occupied chunks are always the POOL PREFIX (sequential
            # allocation; remove_ids rebuilds compactly), so the sweep
            # covers only ``nsweep`` rows (the quantized used prefix) —
            # never the doubling headroom above it
            nslots = min(nsweep, data.shape[0]) if nsweep else data.shape[0]
            occ = ids >= 0
            sel_eff = occ if sel is None else occ & sel
            if dense_fused:
                # the FLAT fused program over the pool prefix: group-max
                # sweep -> top groups -> gather/rescore, never
                # materializing (nq, nslots). Hole /
                # filtered slots ride the pre-masked norm stream; exact
                # query-split nomination (sweep_passes=2) keeps the
                # certificate rate ~1; uncertified queries re-run the XLA
                # dense program via TpuSearchToken.wait() (the flat tiered
                # discipline, index.make_selective_fallback).
                from .ops import pallas_fused as pf

                ke = min(k, nslots)
                v, slot, cert = pf.fused_search(
                    q, data, norms, jnp.int32(nslots), k=ke, metric=metric,
                    nv_eff=nslots, interpret=interpret, sweep_passes=2,
                    scales=scales if kind == "int8" else None,
                    int_norm_max=inorm if kind == "int8" else None,
                    sel=sel_eff)
                if metric is MetricType.L2:
                    # kernel scores omit the rank-invariant −‖q‖²
                    v = v - qn[:, None]
                lab = jnp.take(ids, slot, axis=0)
                ok = v > -jnp.inf
                dists = dist_ops.scores_to_distances(v, metric)
                dists = jnp.where(ok, dists, worst_distance(metric))
                lab = jnp.where(ok, lab, jnp.int32(-1))
                if ke < k:
                    dists = jnp.concatenate([
                        dists, jnp.full((nq_pad, k - ke),
                                        worst_distance(metric), jnp.float32)],
                        axis=-1)
                    lab = jnp.concatenate([
                        lab, jnp.full((nq_pad, k - ke), -1, jnp.int32)],
                        axis=-1)
                return dists, lab, cert
            # halve only while even → sweep_chunk always divides nslots
            # exactly (nsweep is quantized to ~2 significant bits of
            # chunks), so no clamped tail slice
            sweep_chunk = nslots
            while (sweep_chunk % 2 == 0
                   and sweep_chunk * nq_pad * 4 > (256 << 20)):
                sweep_chunk //= 2

            def score_blk(start):
                dbs = jax.lax.dynamic_slice_in_dim(data, start, sweep_chunk,
                                                   axis=0)
                ns = jax.lax.dynamic_slice_in_dim(norms, start, sweep_chunk,
                                                  axis=0)
                if kind == "f32":
                    s = dist_ops.matmul_scores(qeff, dbs, ns, metric)
                else:
                    dn = (((1,), (1,)), ((), ()))
                    from .storage import split3_f32_bf16

                    vb = (dbs.astype(jnp.bfloat16) if kind == "int8"
                          else dbs)
                    dots = None
                    for qp_ in split3_f32_bf16(qeff):
                        dp = jax.lax.dot_general(
                            qp_, vb, dn, preferred_element_type=jnp.float32)
                        dots = dp if dots is None else dots + dp
                    s = (2.0 * dots - qn[:, None] - ns[None, :]
                         if metric is MetricType.L2 else dots)
                ok = jax.lax.dynamic_slice_in_dim(sel_eff, start, sweep_chunk,
                                                  axis=0)
                return jnp.where(ok[None, :], s, -jnp.inf)

            ke = min(k, nslots)
            v, slot = topk_ops.chunked_topk_scores(
                score_blk, nslots, sweep_chunk, ke)
            lab = jnp.take(ids, slot, axis=0)
            ok = v > -jnp.inf
            dists = dist_ops.scores_to_distances(v, metric)
            dists = jnp.where(ok, dists, worst_distance(metric))
            lab = jnp.where(ok, lab, jnp.int32(-1))
            if ke < k:
                dists = jnp.concatenate([
                    dists, jnp.full((nq_pad, k - ke),
                                    worst_distance(metric), jnp.float32)],
                    axis=-1)
                lab = jnp.concatenate([
                    lab, jnp.full((nq_pad, k - ke), -1, jnp.int32)], axis=-1)
            return dists, lab

        # coarse probe: same arithmetic as the quantizer's flat search;
        # padded centroid rows carry +inf norms -> -inf scores
        cs = dist_ops.matmul_scores(q, cents, cnorms, metric)
        _, probe = jax.lax.top_k(cs, nprobe)        # (nq_pad, nprobe) i32

        if xla_scan:
            def block(b):
                s, cid = scores_blk(data, norms, counts, ids, ctable, sel,
                                    q, qeff, qn, probe, b)
                vb, i = jax.lax.top_k(s, k_eff)
                return vb, jnp.take_along_axis(cid, i, axis=-1)

            v, lab = jax.lax.map(block, jnp.arange(nblocks, dtype=jnp.int32))
            v = v.reshape(nq_pad, k_eff)
            lab = lab.reshape(nq_pad, k_eff)
        else:
            v, lab = _kernel_scan(data, norms, counts, ids, ctable, sel,
                                  qeff, qn, probe, nbudget=nbudget,
                                  nprobe=nprobe, k=k_eff, metric=metric,
                                  interpret=interpret)
        ok = v > -jnp.inf
        dists = dist_ops.scores_to_distances(v, metric)
        dists = jnp.where(ok, dists, worst_distance(metric))
        lab = jnp.where(ok, lab, jnp.int32(-1))
        if k_eff < k:
            dists = jnp.concatenate([
                dists, jnp.full((nq_pad, k - k_eff), worst_distance(metric),
                                jnp.float32)], axis=-1)
            lab = jnp.concatenate([
                lab, jnp.full((nq_pad, k - k_eff), -1, jnp.int32)], axis=-1)
        return dists, lab

    return jax.jit(fn)


def _build_ivf_range_fn(*, nprobe: int, nq_pad: int, rcap: int,
                        metric: MetricType, kind: str, nbudget: int,
                        with_sel: bool = False):
    """Range scan over the probed lists (faiss IndexIVF::range_search
    semantics: hits are complete WITHIN the nprobe probed lists).

    fn(data, norms, counts, ids, ctable, cents, cnorms, q, thr [, sel]) ->
    (counts_out (1, nq_pad) i32, vals (1, nq_pad, rcap), gids (1, ...)) —
    shaped as ONE chunk for the shared host CSR assembly (_range_csr);
    counts are exact past rcap, so its capacity-doubling re-run applies."""
    ncand = nbudget * _CHUNK
    nblocks = nq_pad // _QB
    rcap = min(rcap, ncand)
    scores_blk = _probed_scores(nprobe=nprobe, metric=metric,
                                kind=kind, with_sel=with_sel,
                                nbudget=nbudget)

    def fn(data, norms, counts, ids, ctable, cents, cnorms, q, thr,
           sel=None, scales=None):
        cs = dist_ops.matmul_scores(q, cents, cnorms, metric)
        _, probe = jax.lax.top_k(cs, nprobe)
        qn = jnp.sum(q * q, axis=-1, dtype=jnp.float32)
        qeff = q * scales[None, :] if kind == "int8" else q

        def block(b):
            s, cid = scores_blk(data, norms, counts, ids, ctable, sel, q,
                                qeff, qn, probe, b)
            hit = s > thr  # strict, like the flat path
            nhit = jnp.sum(hit, axis=-1, dtype=jnp.int32)
            v, i = jax.lax.top_k(jnp.where(hit, s, -jnp.inf), rcap)
            g = jnp.take_along_axis(cid, i, axis=-1)
            return nhit, v, g

        nh, v, g = jax.lax.map(block, jnp.arange(nblocks, dtype=jnp.int32))
        return (nh.reshape(1, nq_pad), v.reshape(1, nq_pad, rcap),
                g.reshape(1, nq_pad, rcap))

    return jax.jit(fn)


def _scatter_rows_fn(data, rows, slots):
    return data.at[slots].set(rows)


_scatter_rows = jax.jit(_scatter_rows_fn, donate_argnums=(0,))


def _compact_slots_fn(arr, perm):
    # hole slots gather stale rows; every search path masks them via the
    # per-list counts, and the ids column is rewritten with -1 there
    return jnp.take(arr, perm, axis=0)


_compact_slots = jax.jit(_compact_slots_fn, donate_argnums=(0,))


def _grow_pool_fn(old, new_rows, fill):
    """Extend a pool tensor along axis 0 (chunk-pool doubling). Existing
    slots keep their flat index — growth never moves a row (unlike the r3
    per-list padded layout, which re-strided every slot on cap growth)."""
    pad = [(0, new_rows - old.shape[0])] + [(0, 0)] * (old.ndim - 1)
    return jnp.pad(old, pad, constant_values=fill)


# donate the old pool: growth can't alias (the output is bigger) but
# donation invalidates the caller's reference at the call, so the old
# buffer frees as soon as the pad completes instead of surviving until the
# Python rebind — multi-GB transients at 10M-row scale (ADVICE r4)
_grow_pool = jax.jit(_grow_pool_fn, static_argnums=(1, 2),
                     donate_argnums=(0,))


_ASSIGN_BLK = 8192  # coarse-assign GEMM rows per lax.map block: bounds the
#                     live (blk, nlist_pad) score slab to ≤ 256 MB at
#                     nlist=8192 while keeping the GEMM batched


def _build_assign_fn(*, n_pad: int, metric: MetricType):
    """fn(xd (n_pad, d_pad) f32, cents (nlist_pad, d_pad), cnorms) ->
    (n_pad,) int32 nearest-centroid ids. The add-path coarse router: the
    SAME matmul_scores arithmetic as the quantizer's flat search (padded
    centroid rows carry +inf norms -> -inf scores), argmax ties break
    low-id like lax.top_k. One jitted program over lax.map blocks — the
    batch crosses the host boundary ONCE (routing through
    quantizer.assign would re-transfer the rows it is about to scatter)."""
    blk = min(n_pad, _ASSIGN_BLK)
    assert n_pad % blk == 0, (n_pad, blk)
    nblocks = n_pad // blk

    def fn(xd, cents, cnorms):
        def body(i):
            qs = jax.lax.dynamic_slice_in_dim(xd, i * blk, blk, axis=0)
            cs = dist_ops.matmul_scores(qs, cents, cnorms, metric)
            return jnp.argmax(cs, axis=-1).astype(jnp.int32)

        return jax.lax.map(body,
                           jnp.arange(nblocks, dtype=jnp.int32)).reshape(n_pad)

    return jax.jit(fn)


class TpuIndexIVFFlat:
    """faiss::IndexIVFFlat analog. ``storage``: f32 (exact fp32 distances),
    bf16 (2 B/elem, distances fp32-true to the quantized rows) or int8
    (1 B/elem lists — the flat index's int8 contract: per-dim scales frozen
    at train(), DECODED norms, exact distances vs the decoded database;
    ≈ faiss IndexIVFScalarQuantizer(QT_8bit))."""

    def __init__(self, d: int, nlist: int, metric=MetricType.L2,
                 storage=StorageType.FLOAT32, nprobe: int = 1,
                 resources: Optional[TpuResources] = None,
                 train_niter: int = 10, seed: int = 1234,
                 balance: float = 2.0):
        self.d, self.nlist = int(d), int(nlist)
        if self.d <= 0 or self.nlist <= 0:
            raise ValueError(f"bad IVF config: d={d}, nlist={nlist}")
        self.metric = MetricType.coerce(metric)
        self.storage_type = StorageType.coerce(storage)
        if self.storage_type not in (StorageType.FLOAT32,
                                     StorageType.BFLOAT16,
                                     StorageType.INT8):
            raise ValueError(
                "TpuIndexIVFFlat supports f32/bf16/int8 storage (f16 is a "
                "flat-index feature; see storage.py)")
        self.nprobe = int(nprobe)
        self.res = resources if resources is not None else default_resources()
        self.train_niter = int(train_niter)
        self.seed = int(seed)
        # train-time list balancing (clustering.balance_centroids): cap any
        # list at ~balance x the mean so the fine scan's static chunk budget
        # (_chunk_budget = sum of the nprobe FATTEST lists) stops paying the
        # k-means skew tax (1M mixture: max list 9.5x mean -> budget 80
        # chunks at nprobe=1 where the mean list needs 8). 0/None
        # disables (raw faiss Clustering behavior).
        self.balance = float(balance) if balance else 0.0
        self.d_pad = _round_up(self.d, LANE)
        self._dtype = {StorageType.FLOAT32: jnp.float32,
                       StorageType.BFLOAT16: jnp.bfloat16,
                       StorageType.INT8: jnp.int8}[self.storage_type]
        self._kind = {StorageType.FLOAT32: "f32",
                      StorageType.BFLOAT16: "bf16",
                      StorageType.INT8: "int8"}[self.storage_type]
        self.quantizer = None            # TpuIndexFlat over the centroids
        self._cents = None               # (nlist_pad, d_pad) f32 device
        self._cnorms = None              # (nlist_pad,) f32 (+inf on pads)
        self.ntotal = 0
        # chunk-paged pool storage: npool 128-row chunks, paged to lists
        # through the (nlist, maxc) page table (see module docstring)
        self.npool = 0                   # pool capacity (chunks; doubles)
        self.maxc = 0                    # page-table width (chunks)
        self._used_chunks = 0            # pool allocation top
        self._data = None                # (npool*128, d_pad) storage dtype
        self._norms = None               # (npool*128,) f32 (pre-quant norms;
        #                                  int8: DECODED norms — see storage)
        self._ids = None                 # (npool*128,) i32 insertion ids
        self._ctable_host = np.zeros((self.nlist, 0), np.int32)
        self._ctable = None              # device page table (nlist, maxc)
        self._chunk_list = np.empty(0, np.int32)  # pool chunk -> owning list
        self._list_nchunks = np.zeros(self.nlist, np.int32)
        self._counts = np.zeros(self.nlist, np.int32)   # host mirror
        self._counts_dev = None
        self._slot_of = np.empty(0, np.int64)  # insertion id -> pool slot
        # int8 list storage: per-dim scales frozen at train() (flat-index
        # discipline, storage.DeviceStore.train) + clip observability
        self._scales = None              # (d_pad,) f32 device
        self._int8_clipped = None        # () f32 device counter
        self._int8_elems = 0
        self._int8_qn = None             # () f32 running max ‖codes‖ (the
        #                                  dense-fused certificate operand)
        self.fused_fallbacks = 0         # dense-fused cert re-runs

    @property
    def is_trained(self) -> bool:
        return self.quantizer is not None and (
            self.storage_type is not StorageType.INT8
            or self._scales is not None)

    # -- train ----------------------------------------------------------------
    def train(self, x: np.ndarray) -> None:
        """Train the coarse quantizer (faiss IndexIVF::train -> Clustering
        over the flat quantizer; here clustering.Kmeans — one jitted Lloyd
        scan). int8 storage additionally freezes the per-dim
        quantization scales from the SAME sample (faiss IndexIVFScalar-
        Quantizer::train trains both in one call)."""
        if self.is_trained:
            return
        x = np.ascontiguousarray(x, np.float32)
        if self.storage_type is StorageType.INT8 and self._scales is None:
            self._set_scales(np.maximum(np.abs(x).max(axis=0) / 127.0,
                                        1e-12).astype(np.float32))
        if self.quantizer is None:
            km = Kmeans(self.d, self.nlist, niter=self.train_niter,
                        seed=self.seed, metric=self.metric,
                        spherical=self.metric is MetricType.INNER_PRODUCT,
                        resources=self.res)
            km.train(x)
            cents = km.centroids
            if self.balance and self.nlist > 1:
                from .clustering import balance_centroids

                # same subsample budget as Kmeans.train so the balance
                # rounds cost what one extra train costs
                sub = x
                cap_n = self.nlist * km.max_points_per_centroid
                if len(sub) > cap_n:
                    rng = np.random.default_rng(self.seed)
                    sub = sub[rng.choice(len(sub), cap_n, replace=False)]
                cents = balance_centroids(
                    sub, cents, cap_ratio=self.balance, metric=self.metric,
                    spherical=self.metric is MetricType.INNER_PRODUCT)
                self._set_centroids(cents)
                return
            self._set_centroids(cents, quantizer=km.index)

    def _set_scales(self, scales: np.ndarray) -> None:
        """Install frozen int8 per-dim scales (train() and io.load_index)."""
        assert scales.shape == (self.d,), scales.shape
        sp = np.ones((self.d_pad,), np.float32)  # pad dims: q is 0 there
        sp[: self.d] = scales
        self._scales = jax.device_put(jnp.asarray(sp))

    def _set_centroids(self, centroids: np.ndarray, quantizer=None) -> None:
        """Install trained centroids (train() and io.load_index)."""
        centroids = np.ascontiguousarray(centroids, np.float32)
        assert centroids.shape == (self.nlist, self.d), centroids.shape
        if quantizer is None:
            from .index import TpuIndexFlat  # late: avoid import cycle

            quantizer = TpuIndexFlat(self.d, metric=self.metric,
                                     resources=self.res)
            quantizer.add(centroids)
        self.quantizer = quantizer
        nl_pad = _round_up(self.nlist, 8)
        c = np.zeros((nl_pad, self.d_pad), np.float32)
        c[: self.nlist, : self.d] = centroids
        cn = np.full((nl_pad,), np.inf, np.float32)  # pad rows: -inf score
        cn[: self.nlist] = (centroids.astype(np.float64) ** 2).sum(1)
        self._cents = jax.device_put(c)
        self._cnorms = jax.device_put(cn)

    # -- add ------------------------------------------------------------------
    def _ensure_pool(self, need_chunks: int, need_maxc: int) -> None:
        """Grow the chunk pool (device tensors, by doubling) and the page
        table (host + device width) to hold ``need_chunks`` total allocated
        chunks / ``need_maxc`` chunks on the fattest list. Pool growth
        appends rows — existing slots never move, so ``_slot_of`` survives
        growth untouched (the r3 padded layout re-strided every slot)."""
        new_pool = self.npool if self.npool else _POOL0
        while need_chunks > new_pool:
            new_pool *= 2
        if new_pool != self.npool:
            rows = new_pool * _CHUNK
            if self._data is None:
                self._data = jnp.zeros((rows, self.d_pad), self._dtype)
                self._norms = jnp.zeros((rows,), jnp.float32)
                self._ids = jnp.full((rows,), -1, jnp.int32)
            else:
                self._data = _grow_pool(self._data, rows, 0)
                self._norms = _grow_pool(self._norms, rows, 0)
                self._ids = _grow_pool(self._ids, rows, -1)
            self._chunk_list = np.concatenate([
                self._chunk_list,
                np.full(new_pool - self.npool, -1, np.int32)])
            self.npool = new_pool
        if need_maxc > self.maxc:
            new_maxc = max(self.maxc, 1)
            while need_maxc > new_maxc:
                new_maxc *= 2
            self._ctable_host = np.pad(
                self._ctable_host, ((0, 0), (0, new_maxc - self.maxc)))
            self.maxc = new_maxc

    def _coarse_assign(self, x: np.ndarray):
        """Pad + transfer an add batch ONCE and route it on device: returns
        (xd (n_pad, d_pad) f32 device rows, assign (n,) int64 host list
        ids). The scatter consumes ``xd`` directly, so add() moves the batch
        over the host link exactly once — the r4 path routed through
        quantizer.assign() (its own chunked transfers + search programs)
        and then re-transferred the same rows for the scatter."""
        n = x.shape[0]
        blk = min(_ASSIGN_BLK, max(_QB, _round_up(n, _QB)))
        n_pad = _round_up(n, blk)
        xp = np.zeros((n_pad, self.d_pad), np.float32)
        xp[:n, : self.d] = x
        xd = jnp.asarray(xp)
        fn = self.res.cached(
            ("ivf_assign", n_pad, self.d_pad, self._cents.shape[0],
             self.metric),
            lambda: _build_assign_fn(n_pad=n_pad, metric=self.metric))
        assign = np.asarray(jax.device_get(fn(xd, self._cents, self._cnorms)))
        return xd, assign[:n].astype(np.int64)

    def add(self, x: np.ndarray) -> None:
        if not self.is_trained:
            raise RuntimeError(
                "IndexIVFFlat requires train() before add (faiss throws the "
                "same way, faiss/IndexIVF.cpp)")
        x = np.ascontiguousarray(x, np.float32)
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected (n, {self.d}) vectors, got {x.shape}")
        n = x.shape[0]
        if n == 0:
            return
        xd, assign = self._coarse_assign(x)
        if self.storage_type is StorageType.INT8:
            # quantize on device with the frozen scales; norms are of the
            # DECODED rows (storage._quantize_int8_fn — the flat index's
            # self-consistent int8 ranking contract). Zero pad rows can't
            # clip, so the clip counter is exact over the padded batch.
            from .storage import _quantize_int8_fn

            vq, nrm, _qn, clip = _quantize_int8_fn(xd, self._scales)
            # running max ‖codes‖ (device scalar, no host sync): the
            # dense-fused route's int8 certificate operand (zero pad rows
            # cannot raise it)
            self._int8_qn = (_qn if self._int8_qn is None
                             else jnp.maximum(self._int8_qn, _qn))
            self._int8_elems += n * self.d
            self._int8_clipped = (clip if self._int8_clipped is None
                                  else self._int8_clipped + clip)
            self._add_preassigned(vq[:n], nrm[:n], assign)
            return
        # norms stay host-f64-accumulated pre-quantization (the storage.add
        # contract every oracle subtracts)
        norms = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
        self._add_preassigned(xd[:n], norms, assign)

    def _add_preassigned(self, x, norms, assign: np.ndarray,
                         global_ids: Optional[np.ndarray] = None) -> None:
        """Core insertion with the coarse assignment already decided —
        shared by add() and io.load_index (which restores the SAVED
        assignment and stored norms so a reload is bit-exact, never a
        re-route through fp32 re-assignment). ``x`` is host (n, d) f32
        (float kinds / io restore), host (n, d) int8 codes (io restore),
        or a device (n, d_pad) array already in the stored dtype (int8
        add path). ``global_ids``: what the device id column records for
        these rows (ShardedIndexIVFFlat stores GLOBAL ids so the cross-device merge
        needs no translation); defaults to the local insertion ids."""
        n = x.shape[0]
        # host slot assignment against the counts mirror (vectorized,
        # stable within each list: sorted order -> rank within group)
        add_per_list = np.bincount(assign, minlength=self.nlist)
        new_counts = self._counts.astype(np.int64) + add_per_list
        need_c = -(-new_counts // _CHUNK)            # chunks per list after
        grow = (need_c - self._list_nchunks).astype(np.int64)
        total_new = int(grow.sum())
        self._ensure_pool(self._used_chunks + total_new, int(need_c.max()))
        if total_new:
            # allocate fresh pool chunks to the growing lists, in list
            # order, and page them into the table
            ll = np.repeat(np.arange(self.nlist, dtype=np.int64), grow)
            j = (np.arange(total_new)
                 - np.repeat(np.cumsum(grow) - grow, grow))
            new_chunks = self._used_chunks + np.arange(total_new,
                                                       dtype=np.int64)
            self._ctable_host[ll, self._list_nchunks[ll] + j] = new_chunks
            self._chunk_list[new_chunks] = ll
            self._used_chunks += total_new
            self._list_nchunks = need_c.astype(np.int32)
        self._ctable = jax.device_put(jnp.asarray(self._ctable_host))
        order = np.argsort(assign, kind="stable")
        sa = assign[order]
        rank = np.arange(n) - np.searchsorted(sa, sa)
        pos = self._counts.astype(np.int64)[sa] + rank   # within-list index
        slots = np.empty(n, np.int64)
        slots[order] = (self._ctable_host[sa, pos // _CHUNK].astype(np.int64)
                        * _CHUNK + pos % _CHUNK)
        if isinstance(x, jax.Array):
            rows = x.astype(self._dtype)  # already padded + stored dtype
        elif np.dtype(x.dtype) == np.int8:  # raw codes (io restore)
            xp = np.zeros((n, self.d_pad), np.int8)
            xp[:, : self.d] = x
            rows = jnp.asarray(xp)
            qn = np.float32(np.sqrt(
                (x.astype(np.float64) ** 2).sum(1).max()))
            self._int8_qn = (jnp.float32(qn) if self._int8_qn is None
                             else jnp.maximum(self._int8_qn,
                                              jnp.float32(qn)))
        else:
            xp = np.zeros((n, self.d_pad), np.float32)
            xp[:, : self.d] = x
            rows = jnp.asarray(xp).astype(self._dtype)
        sl = jnp.asarray(slots.astype(np.int32))
        self._data = _scatter_rows(self._data, rows, sl)
        self._norms = _scatter_rows(self._norms, jnp.asarray(norms), sl)
        new_ids = (np.asarray(global_ids, np.int32) if global_ids is not None
                   else np.arange(self.ntotal, self.ntotal + n,
                                  dtype=np.int32))
        self._ids = _scatter_rows(self._ids, jnp.asarray(new_ids), sl)
        self._counts = new_counts.astype(np.int32)
        self._counts_dev = jax.device_put(self._counts)
        self._slot_of = np.concatenate([self._slot_of, slots])
        self.ntotal += n

    def _assignments(self) -> np.ndarray:
        """(ntotal,) list id of every insertion id (io.save_index)."""
        return self._chunk_list[self._slot_of // _CHUNK].astype(np.int64)

    def _rows_by_id(self) -> Tuple[np.ndarray, np.ndarray]:
        """Raw stored rows + norms in insertion-id order (io.save_index).
        bf16 storage returns the exact bit patterns as uint16; int8 the
        quantized codes."""
        data = np.asarray(jax.device_get(self._data))
        norms = np.asarray(jax.device_get(self._norms))
        rows = np.ascontiguousarray(data[self._slot_of][:, : self.d])
        if rows.dtype not in (np.float32, np.int8):
            rows = rows.view(np.uint16)
        return rows, norms[self._slot_of]

    # -- search ---------------------------------------------------------------
    def _prep_search(self, x: np.ndarray, params):
        """Shared search/range_search prologue: validation, query padding,
        probe width, and the selector stream (indexed by SLOT through the
        id->slot map, so the fine scan masks filtered rows like padding)."""
        if not self.is_trained:
            raise RuntimeError("IndexIVFFlat requires train() before search")
        x = np.ascontiguousarray(x, np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected (n, {self.d}) queries, got {x.shape}")
        nq = x.shape[0]
        if params is None or getattr(params, "sel", None) is None:
            sel_mod.selector_mask(params, np.empty(0, np.int64))  # validate
            mask = None
        else:  # only materialize the ntotal-long id vector for real selectors
            mask = sel_mod.selector_mask(
                params, np.arange(self.ntotal, dtype=np.int64))
        sel = None
        if mask is not None and not mask.all():
            s = np.zeros((self.npool * _CHUNK,), bool)
            s[self._slot_of[mask]] = True
            sel = jnp.asarray(s)
        # per-query probe-width override (faiss::SearchParametersIVF.nprobe)
        req = getattr(params, "nprobe", None) if params is not None else None
        nprobe = min(req if req is not None else self.nprobe, self.nlist)
        # static chunk budget for the two-level gather (exact worst case
        # over any probe set, from the host counts mirror)
        nbudget = (_chunk_budget(self._counts, nprobe, _CHUNK)
                   if self.npool else 1)
        nq_pad = max(_QB, _round_up(nq, _QB))
        # working-set gate (nprobe == nlist routes to the dense shared
        # sweep: no gather, no gate): the chunk-scan kernel materializes
        # the (nq_pad, nbudget·CHUNK) f32 score array
        footprint = nq_pad * nbudget * _CHUNK * 4
        if nprobe < self.nlist and footprint > _GATHER_BUDGET:
            raise ValueError(
                f"IVF fine scan working set would be {footprint >> 20} MB "
                f"(nprobe={nprobe}, chunk budget={nbudget}); lower nprobe "
                "(oversized query batches are split automatically — hitting "
                "this means even one query block exceeds the budget)")
        qp = np.zeros((nq_pad, self.d_pad), np.float32)
        qp[:nq, : self.d] = x
        return qp, nq, nq_pad, nprobe, nbudget, sel

    def _dense_fused_ok(self, nsweep: int) -> bool:
        """The dense (nprobe == nlist) route rides the flat fused program
        when the quantized pool prefix is large enough for the fused path
        to pay (FUSED_MIN_NV rows; smaller pools keep the cheap XLA sweep)
        and, for int8, the running max-code-norm certificate operand
        exists. f32 pools keep the XLA sweep: the fused f32 program needs
        the bf16 (hi, lo) pair planes, which IVF storage does not keep."""
        from .ops.pallas_fused import FUSED_MIN_NV

        nslots = min(nsweep, self.npool * _CHUNK)
        return (self._kind in ("bf16", "int8") and nslots >= FUSED_MIN_NV
                and (self._kind != "int8" or self._int8_qn is not None))

    def _search_device(self, x: np.ndarray, k: int, params=None,
                       force_xla_dense: bool = False):
        """Enqueue one IVF search; returns (unrealized (dists, labels
        [, cert, fallback]), nq) or (None, nq) for the empty index."""
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        qp, nq, nq_pad, nprobe, nbudget, sel = self._prep_search(x, params)
        if self.ntotal == 0:
            return None, nq
        with_sel = sel is not None
        # dense-route sweep width: the quantized used-chunk prefix (pool
        # doubling headroom never enters the sweep; quantization bounds
        # compiled-fn churn to a handful of shapes per octave). Gather
        # routes ignore it — keep it out of their cache key.
        nsweep = (_round_budget(self._used_chunks) * _CHUNK
                  if nprobe >= self.nlist else 0)
        dense_fused = (bool(nsweep) and not force_xla_dense
                       and self._dense_fused_ok(nsweep))
        key = ("ivf_search", self.nlist, self.npool, self.maxc, nprobe,
               nbudget, nsweep, nq_pad, int(k), self.d_pad, self.metric,
               self.storage_type, with_sel, dense_fused)
        fn = self.res.cached(
            key,
            lambda: _build_ivf_search_fn(
                nlist=self.nlist, nprobe=nprobe,
                nq_pad=nq_pad, k=int(k), d_pad=self.d_pad,
                metric=self.metric, kind=self._kind, nbudget=nbudget,
                nsweep=nsweep, with_sel=with_sel, dense_fused=dense_fused,
                interpret=self.res.capabilities.interpret))
        out = fn(self._data, self._norms, self._counts_dev, self._ids,
                 self._ctable, self._cents, self._cnorms, jnp.asarray(qp),
                 sel, self._scales, self._int8_qn)
        if dense_fused:
            x_host = np.ascontiguousarray(x, np.float32).reshape(-1, self.d)

            def fallback(cert_h, d0, i0):
                d_out = np.ascontiguousarray(
                    np.asarray(d0)[:nq], np.float32).copy()
                i_out = np.ascontiguousarray(
                    np.asarray(i0)[:nq], np.int64).copy()
                bad = np.nonzero(~np.asarray(cert_h)[:nq])[0]
                if bad.size == 0:  # only padding rows failed — exact
                    return d_out, i_out
                self.fused_fallbacks += 1
                out2, _ = self._search_device(x_host[bad], k, params,
                                              force_xla_dense=True)
                d2, i2 = jax.device_get(out2[:2])
                d_out[bad] = np.asarray(d2)[: bad.size]
                i_out[bad] = np.asarray(i2)[: bad.size]
                return d_out, i_out

            return (out[0], out[1], out[2], fallback), nq
        return out, nq

    def search(self, x: np.ndarray, k: int,
               params=None) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over the nprobe closest lists (faiss recall semantics:
        exact distances within the probed lists; nprobe == nlist ==
        exhaustive). ``params`` (selector.SearchParams): filtered rows mask
        out of the fine scan exactly like padding."""
        return self.search_async(x, k, params=params).wait()

    def _nq_cap(self, nprobe: int) -> Optional[int]:
        """Max query rows per gather-route dispatch: the chunk scan
        materializes an (nq_pad, nbudget·CHUNK) f32 score array, so the
        batch — not only nprobe — drives the working set. Oversized
        batches split on this cap."""
        if not self.npool or nprobe >= self.nlist:
            return None  # dense route self-bounds its sweep slab
        nbudget = _chunk_budget(self._counts, nprobe, _CHUNK)
        cap = _GATHER_BUDGET // max(nbudget * _CHUNK * 4, 1)
        return max(_QB, cap // _QB * _QB)

    def search_async(self, x: np.ndarray, k: int, params=None):
        """Non-blocking IVF search returning a TpuSearchToken (the fine
        scan is ONE jitted program — JAX dispatch is natively async, so
        searches pipeline instead of paying a blocking device_get each).
        IVF results
        are exact within the probed lists by construction — no certificate,
        no fallback on the gather routes; the dense-fused route (nprobe ==
        nlist over the pool prefix) ships the flat path's per-query
        certificate, and wait() re-runs uncertified queries through the
        exact XLA dense sweep. Query batches whose score array would exceed
        the gather budget are split into row chunks (all enqueued up front,
        so they pipeline) and concatenated at wait()."""
        from .index import ConcatSearchToken, TpuSearchToken

        xa = np.ascontiguousarray(x, np.float32)
        if xa.ndim == 2 and self.is_trained:
            req = (getattr(params, "nprobe", None)
                   if params is not None else None)
            nprobe = min(req if req is not None else self.nprobe, self.nlist)
            cap = self._nq_cap(nprobe)
            if cap is not None and xa.shape[0] > cap:
                return ConcatSearchToken([
                    self.search_async(xa[i0:i0 + cap], k, params=params)
                    for i0 in range(0, xa.shape[0], cap)])
        out, nq = self._search_device(x, k, params)
        if out is None:
            tok = TpuSearchToken(None, None, nq)
            tok._result = (
                np.full((nq, k), worst_distance(self.metric), np.float32),
                np.full((nq, k), -1, np.int64))
            return tok
        if len(out) == 4:  # dense-fused: certificate + tiered fallback
            return TpuSearchToken(out[0], out[1], nq, cert=out[2],
                                  fallback=out[3])
        return TpuSearchToken(out[0], out[1], nq)

    def range_search(
        self, x: np.ndarray, radius: float, params=None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All in-radius neighbors WITHIN the nprobe probed lists, faiss
        CSR contract (faiss::IndexIVF::range_search semantics — completeness
        is bounded by the probe like search recall; nprobe == nlist makes
        it exhaustive). Same strict hit criterion and arithmetic class as
        search()."""
        qp, nq, nq_pad, nprobe, nbudget, sel = self._prep_search(x, params)
        if self.ntotal == 0:
            return (np.zeros(nq + 1, np.int64), np.empty(0, np.float32),
                    np.empty(0, np.int64))
        # range always runs the gather block (no dense shortcut), so the
        # budget gate applies even at nprobe == nlist
        if _QB * nbudget * _CHUNK * self.d_pad * 4 > _GATHER_BUDGET:
            raise ValueError(
                f"IVF range_search would gather too much per block "
                f"(nprobe={nprobe}, chunk budget={nbudget}); lower nprobe")
        thr = np.float32(-radius if self.metric is MetricType.L2 else radius)
        with_sel = sel is not None

        def run(rcap):
            key = ("ivf_range", self.nlist, self.npool, self.maxc, nprobe,
                   nbudget, nq_pad, rcap, self.d_pad, self.metric,
                   self.storage_type, with_sel)
            fn = self.res.cached(
                key,
                lambda: _build_ivf_range_fn(
                    nprobe=nprobe, nq_pad=nq_pad, rcap=rcap,
                    metric=self.metric, kind=self._kind, nbudget=nbudget,
                    with_sel=with_sel))
            out = fn(self._data, self._norms, self._counts_dev, self._ids,
                     self._ctable, self._cents, self._cnorms,
                     jnp.asarray(qp), thr, sel, self._scales)
            rc = min(rcap, nbudget * _CHUNK)
            return jax.device_get(out) + (rc,)

        return _range_csr(run, nq, self.metric)

    def remove_ids(self, ids) -> int:
        """Remove by insertion id with faiss's stable renumbering (survivors
        keep order, ids shift down — faiss::IndexIVF::remove_ids). Lists
        compact in place via ONE donated device gather over the flat slot
        axis; all bookkeeping is host arithmetic on the id->slot map."""
        ids = np.unique(np.asarray(ids, np.int64).ravel())
        if ids.size == 0:
            return 0
        if ids[0] < 0 or ids[-1] >= self.ntotal:
            raise IndexError(
                f"remove_ids: ids outside [0, {self.ntotal}): "
                f"[{ids[0]}, {ids[-1]}]")
        keep = np.setdiff1d(np.arange(self.ntotal, dtype=np.int64), ids,
                            assume_unique=True)
        if keep.size == 0:
            self.reset()
            return int(ids.size)
        old_slots = self._slot_of[keep]            # survivors, new-id order
        lists = self._chunk_list[old_slots // _CHUNK].astype(np.int64)
        # new slot: compact each list preserving slot order (== insertion
        # order within the list — a list's page-table row is ascending by
        # construction, so pool-slot order IS within-list insertion order)
        order = np.lexsort((old_slots, lists))    # list-major, slot-minor
        sl, so = lists[order], old_slots[order]
        rank = np.arange(keep.size) - np.searchsorted(sl, sl)
        # rebuild the page table compactly: list l owns the consecutive
        # pool chunks [base[l], base[l] + need_c[l]) — pool capacity kept
        newcnt = np.bincount(sl, minlength=self.nlist)
        need_c = -(-newcnt // _CHUNK)
        base = np.cumsum(need_c) - need_c
        new_used = int(need_c.sum())
        new_slots_sorted = ((base[sl] + rank // _CHUNK) * _CHUNK
                            + rank % _CHUNK)
        perm = np.zeros((self.npool * _CHUNK,), np.int64)  # gather index
        perm[new_slots_sorted] = so
        new_ids_flat = np.full((self.npool * _CHUNK,), -1, np.int32)
        # survivor at new slot gets its NEW dense id (= rank in keep)
        new_ids_flat[new_slots_sorted] = np.arange(
            keep.size, dtype=np.int64)[order]
        pj = jnp.asarray(perm.astype(np.int32))
        self._data = _compact_slots(self._data, pj)
        self._norms = _compact_slots(self._norms, pj)
        self._ids = jax.device_put(jnp.asarray(new_ids_flat))
        self._ctable_host[:] = 0
        ll = np.repeat(np.arange(self.nlist, dtype=np.int64), need_c)
        jj = np.arange(new_used) - np.repeat(base, need_c)
        self._ctable_host[ll, jj] = np.arange(new_used)
        self._ctable = jax.device_put(jnp.asarray(self._ctable_host))
        self._chunk_list[:] = -1
        self._chunk_list[:new_used] = ll
        self._list_nchunks = need_c.astype(np.int32)
        self._used_chunks = new_used
        self._counts = newcnt.astype(np.int32)
        self._counts_dev = jax.device_put(self._counts)
        slot_of = np.empty(keep.size, np.int64)
        slot_of[new_ids_flat[new_slots_sorted]] = new_slots_sorted
        self._slot_of = slot_of
        self.ntotal = keep.size
        return int(ids.size)

    def assign(self, x: np.ndarray, k: int = 1) -> np.ndarray:
        return self.search(x, k)[1]

    def merge_from(self, other: "TpuIndexIVFFlat") -> None:
        """faiss::IndexIVF::merge_from semantics: append ``other``'s vectors
        to self (ids continue at self.ntotal, insertion order preserved)
        and empty ``other``. The SAVED coarse assignment transfers — rows
        keep their routing (bit-exact, like io.load_index), never a fp32
        re-route through a possibly-different quantizer. Requires matching
        d/metric/nlist/storage; int8 additionally requires the SAME frozen
        scale grid (the codes transfer bit-exactly)."""
        if other is self:
            raise ValueError("cannot merge an index into itself")
        if (other.d != self.d or other.metric is not self.metric
                or other.nlist != self.nlist
                or other.storage_type is not self.storage_type):
            raise ValueError(
                "merge_from: d/metric/nlist/storage mismatch "
                f"(({self.d}, {self.metric}, {self.nlist}, "
                f"{self.storage_type}) vs ({other.d}, {other.metric}, "
                f"{other.nlist}, {other.storage_type}))")
        if not (self.is_trained and other.is_trained):
            raise RuntimeError("merge_from requires both indexes trained")
        if self.storage_type is StorageType.INT8:
            if not np.array_equal(
                    np.asarray(jax.device_get(self._scales)),
                    np.asarray(jax.device_get(other._scales))):
                raise ValueError(
                    "merge_from: int8 scale grids differ — codes are not "
                    "bit-compatible (re-add through float instead)")
        if other.ntotal:
            vec, nrm = other._rows_by_id()
            assign = other._assignments()
            if vec.dtype == np.uint16:  # bf16 bit patterns -> exact f32
                import ml_dtypes

                vec = np.asarray(vec.view(ml_dtypes.bfloat16), np.float32)
            self._add_preassigned(vec, np.asarray(nrm, np.float32), assign)
        other.reset()

    # -- misc -----------------------------------------------------------------
    def reconstruct(self, key: int) -> np.ndarray:
        """Decode one vector by insertion id (faiss IVF needs an explicit
        direct map — make_direct_map — before reconstruct; the slot map
        here is always maintained). int8 rows decode through the frozen
        scales (the same bits the fine scan ranks)."""
        if not 0 <= key < self.ntotal:
            raise IndexError(f"id {key} out of range [0, {self.ntotal})")
        row = np.asarray(
            jax.device_get(self._data[int(self._slot_of[key])]),
            np.float32)
        if self.storage_type is StorageType.INT8:
            row = row * np.asarray(jax.device_get(self._scales), np.float32)
        return row[: self.d]

    def reset(self) -> None:
        """Drop the vectors, keep the trained quantizer and (int8) the
        frozen scales (faiss reset: is_trained persists)."""
        self.ntotal = 0
        self.npool = 0
        self.maxc = 0
        self._used_chunks = 0
        self._data = self._norms = self._ids = None
        self._ctable_host = np.zeros((self.nlist, 0), np.int32)
        self._ctable = None
        self._chunk_list = np.empty(0, np.int32)
        self._list_nchunks = np.zeros(self.nlist, np.int32)
        self._counts = np.zeros(self.nlist, np.int32)
        self._counts_dev = None
        self._slot_of = np.empty(0, np.int64)
        self._int8_clipped = None
        self._int8_elems = 0
        self._int8_qn = None

    def list_sizes(self) -> np.ndarray:
        """Per-list occupancy (faiss invlists->list_size observability)."""
        return self._counts.copy()

    def describe(self) -> str:
        # load = live rows per OCCUPIED pool slot (HBM the pool actually
        # allocated to lists; ≈ 1 - half-chunk waste per non-empty list)
        load = (self._counts.sum() / (self._used_chunks * _CHUNK)
                if self._used_chunks else 0.0)
        int8_note = ""
        if self.storage_type is StorageType.INT8:
            frac = (float(jax.device_get(self._int8_clipped))
                    / self._int8_elems
                    if self._int8_elems and self._int8_clipped is not None
                    else 0.0)
            int8_note = f", int8_clipped_fraction={frac:.2e}"
        return (
            f"TpuIndexIVFFlat(d={self.d}, nlist={self.nlist}, "
            f"nprobe={self.nprobe}, metric={self.metric.value}, "
            f"storage={self.storage_type.value}, ntotal={self.ntotal}, "
            f"pool={self._used_chunks}/{self.npool}x{_CHUNK}, "
            f"bucket_load={load:.2f}, "
            f"fused_fallbacks={self.fused_fallbacks}, "
            f"trained={self.is_trained}{int8_note})")
