"""ShardedIndexFlat — flat exact search over a database sharded across chips.

Architecture (SURVEY.md §5.8; BASELINE.json config 5):
  * one ``DeviceStore`` per device holds that shard's vectors/norms, plus a
    global-id column. Ids are int32 on device — the same 2^31−1 total-size
    ABI as the reference (src/MetalIndexFlat.mm:323-326) — and widened to
    int64 at the host API boundary (TpuSearchToken.wait);
  * ``add`` splits each batch contiguously across shards (balanced to ±1
    row-block) and appends on each device — no host-side reshuffling;
  * ``search`` is ONE jitted ``shard_map`` program over a 2-D
    ``(replicas, shards)`` mesh: local scan (fused Pallas kernel when
    eligible) + local exact top-k → gid gather → ``jax.lax.all_gather`` of
    the (k dists, k gids) lists over the shards axis → k-merge. The
    merge is O(P·k), so scaling with P is near-linear until nq·k·P rivals
    the local scan. With ``num_replicas=R`` the query batch splits across
    R replica groups for R× throughput at R× memory.

Tested without real multi-chip hardware via XLA host-device emulation
(``--xla_force_host_platform_device_count=8`` — tests/conftest.py), the same
strategy SURVEY.md §4 prescribes.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..dtypes import MetricType, StorageType, worst_distance
from ..ops import distance as dist_ops
from ..ops import pallas_fused
from ..ops import topk as topk_ops
from ..resources import TpuResources, default_resources
from .. import selector as sel_mod
from ..storage import ROW_TILE, DeviceStore, _round_up
from ..index import (NQ_PAD, TpuSearchToken, make_selective_fallback,
                     _masked_scores_block, _range_csr)

AXIS = TpuResources.SHARD_AXIS
REPLICA_AXIS = "replicas"


def _build_sharded_search_fn(
    *,
    mesh: jax.sharding.Mesh,
    nv_eff: int,        # per-shard effective rows (static)
    nq_pad: int,
    k: int,
    metric: MetricType,
    chunk: int,
    use_fused: bool = False,
    use_split: bool = False,
    interpret: bool = False,
    pair_only: bool = False,
    sweep_passes: int = 2,
    int8: bool = False,
    f16bits: bool = False,
    hi_exact: bool = False,
    f16_clean: bool = False,
    with_sel: bool = False,
):
    """One shard_map program: local scan+select, all-gather, k-merge.

    With ``use_fused`` the local scan is the Pallas streaming kernel
    (ops/pallas_fused.py) — each chip sweeps its own shard at HBM speed and
    only the tiny k-lists cross the interconnect. ``with_sel``: a per-shard
    (cap_local,) bool selector stream rides sharded right after ``queries``
    (selector.SearchParams) — honored by the fused AND plain local scans
    (the fused kernels fold it into the pre-masked norm stream)."""
    k_local = min(k, nv_eff)

    def per_device(db, norms, gids, ntotal_local, queries, *split):
        # db: (cap_local, d_pad), norms/gids: (cap_local,), ntotal_local: (1,)
        # queries: (nq_pad, d_pad) replicated; split: fp32 bf16 (hi, lo) pair.
        sel = None
        if with_sel:
            sel, split = split[0], split[1:]
        nt = ntotal_local[0]

        def local_fused():
            # split is (hi, lo, stats) for fp32 — stats is this shard's
            # (1, 2) slice of the exact v-side split maxima — just
            # (stats,) for 2 B/elem f16-bits storage (pair decoded
            # in-kernel), or (scales replicated, (1,) max‖v_q‖) for int8
            vals, ids, cert = pallas_fused.fused_search(
                queries, db, norms, nt,
                k=k_local, metric=metric, nv_eff=nv_eff, interpret=interpret,
                db_split=None if int8 or f16bits or not split
                else split[:2],
                pair_only=pair_only,
                sweep_passes=sweep_passes,
                split_stats=(split[0][0] if f16bits and split else
                             None if int8 or not split else split[2][0]),
                scales=split[0] if int8 else None,
                int_norm_max=split[1][0] if int8 else None,
                hi_exact=hi_exact,
                f16_clean=f16_clean,
                sel=sel,
            )
            if metric is MetricType.L2:
                # restore the rank-invariant −‖q‖² so cross-shard scores share
                # the plain convention (constant per query ⇒ merge unaffected,
                # but final distances need it)
                qn = jnp.sum(queries * queries, axis=-1, dtype=jnp.float32)
                vals = vals - qn[:, None]
            return vals, ids, cert

        def masked_block(start, width):
            ns = jax.lax.dynamic_slice_in_dim(norms, start, width, axis=0)
            if int8:
                dbs = jax.lax.dynamic_slice_in_dim(db, start, width, axis=0)
                s = dist_ops.int8_scores(queries, split[0], dbs, ns, metric)
            elif f16bits:
                dbs = jax.lax.dynamic_slice_in_dim(db, start, width, axis=0)
                s = dist_ops.f16_scores(queries, dbs, ns, metric)
            elif pair_only:
                dh = jax.lax.dynamic_slice_in_dim(split[0], start, width, axis=0)
                dl = jax.lax.dynamic_slice_in_dim(split[1], start, width, axis=0)
                s = dist_ops.pair_scores(queries, dh, dl, ns, metric)
            else:
                dbs = jax.lax.dynamic_slice_in_dim(db, start, width, axis=0)
                s = dist_ops.matmul_scores(queries, dbs, ns, metric)
            col = jax.lax.broadcasted_iota(jnp.int32, (1, width), 1) + start
            valid = col < nt
            if sel is not None:
                valid = valid & jax.lax.dynamic_slice_in_dim(
                    sel, start, width, axis=0)[None, :]
            return jnp.where(valid, s, -jnp.inf)

        cert = jnp.ones((nq_pad,), jnp.bool_)  # plain paths: exact always
        if use_fused:
            vals, ids, cert = local_fused()
        elif nv_eff > chunk:
            nfull = nv_eff // chunk
            prefix = nfull * chunk
            vals, ids = topk_ops.chunked_topk_scores(
                lambda start: masked_block(start, chunk), prefix, chunk, k_local
            )
            tail = nv_eff - prefix
            if tail:
                tv, ti = topk_ops.topk_scores(
                    masked_block(prefix, tail), min(k_local, tail)
                )
                vals, ids = topk_ops.merge_topk(vals, ids, tv, ti + prefix, k_local)
        else:
            vals, ids = topk_ops.topk_scores(masked_block(0, nv_eff), k_local)

        # local int32 ids → global ids (−1 stays −1); device ids are int32
        # (2^31−1 total cap, matching the reference ABI — MetalIndexFlat.mm:323-326)
        # and widened to int64 on host at the API boundary (TpuSearchToken).
        valid = (ids >= 0) & (ids < nt) & (vals > -jnp.inf)
        safe = jnp.clip(ids, 0, db.shape[0] - 1)
        g = jnp.where(valid, jnp.take(gids, safe, axis=0), jnp.int32(-1))

        # merge: all_gather the tiny k-lists, every device merges identically.
        # the exact cross-shard result needs every LOCAL list exact: AND the
        # per-shard certificates per query
        cert = jnp.all(jax.lax.all_gather(cert, AXIS), axis=0)
        av = jax.lax.all_gather(vals, AXIS)   # (P, nq_pad, k_local)
        ag = jax.lax.all_gather(g, AXIS)
        P_ = av.shape[0]
        av = jnp.moveaxis(av, 0, 1).reshape(nq_pad, P_ * k_local)
        ag = jnp.moveaxis(ag, 0, 1).reshape(nq_pad, P_ * k_local)
        k_out = min(k, P_ * k_local)
        # lexicographic (score desc, gid asc) merge: plain top_k resolves
        # ties by list position = shard order, but gids do NOT follow shard
        # order across add batches (the balanced split rotates its start),
        # so equal scores must break by global id to match the oracle /
        # single-device tie order. O(P·k) lanes — negligible.
        order = jnp.lexsort((ag, -av), axis=-1)[..., :k_out]
        top_vals = jnp.take_along_axis(av, order, axis=-1)
        top_gids = jnp.take_along_axis(ag, order, axis=-1)

        ok = (top_gids >= 0) & (top_vals > -jnp.inf)
        dists = dist_ops.scores_to_distances(top_vals, metric)
        dists = jnp.where(ok, dists, worst_distance(metric))
        top_gids = jnp.where(ok, top_gids, jnp.int32(-1))
        if k_out < k:
            pad_d = jnp.full((nq_pad, k - k_out), worst_distance(metric), jnp.float32)
            pad_i = jnp.full((nq_pad, k - k_out), -1, jnp.int32)
            dists = jnp.concatenate([dists, pad_d], axis=-1)
            top_gids = jnp.concatenate([top_gids, pad_i], axis=-1)
        return dists, top_gids, cert

    # db/norms/gids/ntotals (+ optional fp32 hi/lo pair): sharded over
    # `shards`, replicated over `replicas`; queries: split over `replicas`,
    # replicated over shards.
    in_specs = (P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(REPLICA_AXIS))
    if with_sel:
        in_specs = in_specs + (P(AXIS),)  # per-shard selector stream
    if int8:
        # scales replicated everywhere; per-shard max‖v_q‖ sharded
        in_specs = in_specs + (P(None), P(AXIS))
    elif f16bits and use_split:
        in_specs = in_specs + (P(AXIS, None),)  # per-shard split stats
    elif use_split:
        in_specs = in_specs + (P(AXIS), P(AXIS), P(AXIS, None))
    fn = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(REPLICA_AXIS), P(REPLICA_AXIS), P(REPLICA_AXIS)),
        check_vma=False,
    )
    return jax.jit(fn)


def _build_sharded_range_fn(
    *,
    mesh: jax.sharding.Mesh,
    nv_eff: int,        # per-shard effective rows (static)
    chunk: int,
    cap: int,
    metric: MetricType,
    int8: bool = False,
    f16bits: bool = False,
    pair_only: bool = False,
    with_sel: bool = False,
):
    """Sharded range_search scan (see index._build_range_fn): every shard
    scans its own rows in nv_eff/chunk blocks with the SAME
    `_masked_scores_block` hit criterion as the single-chip path, translates
    hit ids to global gids on-device, and the per-shard per-chunk blocks
    stack into one global (num_shards·nchunks, nq_pad, cap) result — the
    host CSR assembly then cannot tell shards from chunks. Counts are exact
    even past cap; queries split over the replicas axis like search."""
    assert nv_eff % chunk == 0 and cap <= chunk, (nv_eff, chunk, cap)
    nchunks = nv_eff // chunk

    def per_device(db, norms, gids, ntotal_local, queries, thr, *split):
        sel = None
        if with_sel:
            sel, split = split[0], split[1:]
        nt = ntotal_local[0]

        def body(c):
            start = c * chunk
            s = _masked_scores_block(
                db, norms, queries, nt, split, start, chunk,
                metric=metric, int8=int8, f16bits=f16bits,
                pair_only=pair_only, use_direct=False, sel=sel)
            hit = s > thr
            counts = jnp.sum(hit, axis=-1, dtype=jnp.int32)
            v, i = topk_ops.topk_scores(jnp.where(hit, s, -jnp.inf), cap)
            i = i + start
            # local row → global id (hits are always valid rows: padding
            # columns score −inf and thr is finite; garbage slots past a
            # block's count are never read by the host assembly)
            g = jnp.take(gids, jnp.clip(i, 0, db.shape[0] - 1), axis=0)
            return counts, v, g

        return jax.lax.map(body, jnp.arange(nchunks, dtype=jnp.int32))

    in_specs = (P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(REPLICA_AXIS), P())
    if with_sel:
        in_specs = in_specs + (P(AXIS),)          # per-shard selector stream
    if int8:
        in_specs = in_specs + (P(None),)          # scales replicated
    elif pair_only:
        in_specs = in_specs + (P(AXIS), P(AXIS))  # bf16 (hi, lo) pair
    fn = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=in_specs,
        # shards stack on the chunk axis, replicas on the query axis
        out_specs=(P(AXIS, REPLICA_AXIS), P(AXIS, REPLICA_AXIS, None),
                   P(AXIS, REPLICA_AXIS, None)),
        check_vma=False,
    )
    return jax.jit(fn)


class _ShardStore:
    """One shard: a DeviceStore pinned to a device + its int32 gid column."""

    def __init__(self, d: int, storage: StorageType, metric: MetricType,
                 device, keep_master: bool = True):
        self.store = DeviceStore(d, storage, metric, device=device,
                                 keep_master=keep_master)
        self.gids: Optional[jax.Array] = None  # (capacity,) int32, −1 padding
        self.device = device

    def add(self, x: np.ndarray, gids: np.ndarray) -> None:
        old_cap = self.store.capacity
        off = self.store.ntotal
        self.store.add(x)
        self._append_gids(gids, off, grew=self.store.capacity != old_cap)

    def _append_gids(self, gids: np.ndarray, off: int, grew: bool) -> None:
        # All intermediates under default_device(shard device): an uncommitted
        # jnp op must never dispatch to the process default backend (the
        # CPU-mesh dry run may share a process with an accelerator backend).
        with jax.default_device(self.device):
            if grew or self.gids is None:
                new_g = jnp.full((self.store.capacity,), -1, jnp.int32)
                if self.gids is not None:
                    new_g = jax.lax.dynamic_update_slice(new_g, self.gids, (0,))
                self.gids = new_g
            self.gids = jax.lax.dynamic_update_slice(
                self.gids, jnp.asarray(gids, jnp.int32), (off,)
            )

    def reset(self):
        self.store.reset()
        self.gids = None


class ShardedIndexFlat:
    """Flat index over a 2-D ``(replicas, shards)`` device mesh.

    Two composable parallelism axes (the reference has neither — SURVEY §2.4):
      * **shards** (model-parallel analog): the database row-shards across
        devices; per-shard top-k lists merge over the interconnect.
      * **replicas** (data-parallel analog, ``num_replicas``): the sharded
        database is replicated ``R`` times and the query batch splits across
        replica groups — R× query throughput for R× memory.
    Default R=1 is plain 1-D DB sharding. API mirrors TpuIndexFlat.
    """

    def __init__(
        self,
        d: int,
        metric=MetricType.L2,
        storage=StorageType.FLOAT32,
        resources: Optional[TpuResources] = None,
        num_shards: Optional[int] = None,
        num_replicas: int = 1,
        tuning=None,
        keep_master: bool = True,
    ):
        self.metric = MetricType.coerce(metric)
        self.storage_type = StorageType.coerce(storage)
        self.res = resources if resources is not None else default_resources()
        self.tuning = tuning if tuning is not None \
            else self.res.capabilities.tuning
        self.keep_master = bool(keep_master)
        r = int(num_replicas)
        navail = len(self.res.devices)
        p = num_shards or navail // r
        if r < 1 or p < 1 or r * p > navail:
            raise ValueError(
                f"num_replicas={r} × num_shards={p} exceeds {navail} devices"
            )
        dev_grid = np.asarray(self.res.devices[: r * p]).reshape(r, p)
        self.mesh = jax.sharding.Mesh(dev_grid, (REPLICA_AXIS, AXIS))
        self.num_replicas = r
        self.devices = list(dev_grid[0])  # replica-0 devices own the shards
        self.shards: List[_ShardStore] = [
            _ShardStore(d, self.storage_type, self.metric, dev,
                        keep_master=keep_master)
            for dev in self.devices
        ]
        self.d = int(d)
        self.ntotal = 0
        self._next_shard = 0  # round-robin start for balanced contiguous splits
        # gid extents (gid_start, gid_end, shard_idx, local_start), sorted by
        # gid_start: every mutation appends CONTIGUOUS gid runs per shard, so
        # reconstruct is one bisect + one device_get instead of an O(ntotal)
        # gid-column scan (VERDICT r2 weak #6)
        self._extents: List[Tuple[int, int, int, int]] = []
        self._assembled = None  # cached (db, norms, gids, ntotals) global arrays
        self._force_xla = False
        self.fused_fallbacks = 0  # searches re-run after a failed certificate
        # per-shape reduced-sweep disable after a certificate failure
        self._no_reduced_sweep: set = set()

    def set_force_xla(self, force: bool) -> None:
        """Force the plain-XLA local scan on every shard (≈ setForceMPS —
        cross-path differential testing, MetalIndexFlat.h:106)."""
        self._force_xla = bool(force)

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def is_trained(self) -> bool:
        return self.shards[0].store.is_trained

    def train(self, x: np.ndarray) -> None:
        """int8 storage: freeze ONE set of per-dim scales shared by every
        shard (identical quantization grid → shard-count-invariant results)."""
        for s in self.shards:
            s.store.train(x)

    # -- mutation ---------------------------------------------------------------
    def add(self, x: np.ndarray) -> None:
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected (n, {self.d}) array, got {x.shape}")
        n = x.shape[0]
        if n == 0:
            return
        if not self.is_trained:
            self.train(x)  # auto-train on the first batch, like TpuIndexFlat
        if self.ntotal + n > np.iinfo(np.int32).max:
            raise ValueError(
                "total index size would exceed 2^31-1 (int32 device ids; "
                "same limit as the reference, MetalIndexFlat.mm:323-326)"
            )
        p = self.num_shards
        # contiguous split, balanced to ±1, rotating the remainder start
        base, rem = divmod(n, p)
        counts = [base + (1 if (i - self._next_shard) % p < rem else 0)
                  for i in range(p)]
        self._next_shard = (self._next_shard + rem) % p
        off = 0
        gid0 = self.ntotal
        for i, c in enumerate(counts):
            if c == 0:
                continue
            self._extents.append(
                (gid0 + off, gid0 + off + c, i, self.shards[i].store.ntotal))
            self.shards[i].add(
                x[off : off + c],
                np.arange(gid0 + off, gid0 + off + c, dtype=np.int32),
            )
            off += c
        self.ntotal += n
        self._assembled = None

    def reset(self) -> None:
        for s in self.shards:
            s.reset()
        self.ntotal = 0
        self._next_shard = 0
        self._assembled = None
        self._no_reduced_sweep.clear()
        self._extents = []

    def remove_ids(self, ids) -> int:
        """Remove global ids with faiss's stable renumbering (survivors keep
        order, ids shift down) — see TpuIndexFlat.remove_ids. Returns the
        number removed.

        All bookkeeping is host-side over the contiguous gid extents (the
        same discipline that makes reconstruct O(log batches)): each shard
        compacts its rows with one donated device gather, and its gid column
        is rewritten with the dense renumbering. Within one old extent the
        survivors stay contiguous in BOTH the new global numbering (extents
        are disjoint global ranges, so no foreign ids interleave) and the new
        local numbering, so every surviving old extent maps to exactly one
        new extent."""
        ids = np.unique(np.asarray(ids, np.int64).ravel())
        if ids.size == 0:
            return 0
        if ids[0] < 0 or ids[-1] >= self.ntotal:
            raise IndexError(
                f"remove_ids: ids outside [0, {self.ntotal}): "
                f"[{ids[0]}, {ids[-1]}]")
        p = self.num_shards
        keep_local = [[] for _ in range(p)]  # surviving OLD local rows
        new_gids = [[] for _ in range(p)]    # their NEW global ids
        new_extents = []
        off = [0] * p                        # next NEW local row per shard
        for g0, g1, si, l0 in self._extents:  # sorted by gid → dense renumber
            gs = np.arange(g0, g1, dtype=np.int64)
            alive = ~np.isin(gs, ids, assume_unique=True)
            gk = gs[alive]
            if gk.size == 0:
                continue
            keep_local[si].append(l0 + (gk - g0))
            ng0 = int(gk[0] - np.searchsorted(ids, gk[0]))
            new_gids[si].append(np.arange(ng0, ng0 + gk.size, dtype=np.int32))
            new_extents.append((ng0, ng0 + int(gk.size), si, off[si]))
            off[si] += int(gk.size)
        for si, s in enumerate(self.shards):
            k = (np.concatenate(keep_local[si]) if keep_local[si]
                 else np.empty(0, np.int64))
            if k.size != s.store.ntotal:
                s.store.remove_rows(k)
            # gid columns renumber even on shards that lost no rows
            if s.store.capacity and s.gids is not None:
                gcol = np.full((s.store.capacity,), -1, np.int32)
                if new_gids[si]:
                    g = np.concatenate(new_gids[si])
                    gcol[: g.size] = g
                s.gids = jax.device_put(gcol, s.device)
            else:
                s.gids = None
        self._extents = new_extents
        self.ntotal -= int(ids.size)
        self._assembled = None
        self._no_reduced_sweep.clear()  # new data, new margins
        return int(ids.size)

    def reconstruct(self, key: int) -> np.ndarray:
        """Decode one vector by global id: O(log batches) host bisect over
        the contiguous gid extents + ONE device_get of d floats (was an
        O(ntotal) gid-column scan — VERDICT r2 weak #6)."""
        if not (0 <= key < self.ntotal):
            raise IndexError(f"key {key} out of range [0, {self.ntotal})")
        pos = bisect.bisect_right(self._extents, (key, self.ntotal + 1)) - 1
        if pos >= 0:
            g0, g1, shard_idx, local0 = self._extents[pos]
            if g0 <= key < g1:
                return self.shards[shard_idx].store.reconstruct(
                    local0 + (key - g0))
        raise KeyError(f"global id {key} not found")

    # -- assembly: per-device buffers → one sharded global array (no copies) -----
    def _assemble(self):
        if self._assembled is not None:
            return self._assembled
        cap = max(s.store.capacity for s in self.shards)
        cap = max(cap, ROW_TILE)
        for s in self.shards:  # equalize capacities so the global array is regular
            # exact=True: amortized doubling would overshoot cap and leave
            # this shard's buffer larger than the others, making
            # make_array_from_single_device_arrays reject the shard shapes
            s.store._ensure_capacity(cap, exact=True)
            if s.gids is None or s.gids.shape[0] < cap:
                with jax.default_device(s.device):
                    g = jnp.full((cap,), -1, jnp.int32)
                    if s.gids is not None:
                        g = jax.lax.dynamic_update_slice(g, s.gids, (0,))
                    s.gids = g
        p = self.num_shards
        d_pad = self.shards[0].store.d_pad
        dev_grid = self.mesh.devices  # (R, P)

        def global_arr(pieces, shape_tail):
            gshape = (p * cap,) + shape_tail
            spec = P(AXIS, *([None] * len(shape_tail)))
            sharding = NamedSharding(self.mesh, spec)
            # replica 0 owns the data; copies are pushed to replicas 1..R-1
            # once per assembly (cached until the next add/reset)
            all_pieces = []
            for r in range(self.num_replicas):
                for i, piece in enumerate(pieces):
                    if r == 0:
                        all_pieces.append(piece)
                    else:
                        all_pieces.append(
                            jax.device_put(piece, dev_grid[r][i])
                        )
            return jax.make_array_from_single_device_arrays(
                gshape, sharding, all_pieces
            )

        norms = global_arr([s.store.norms for s in self.shards], ())
        gids = global_arr([s.gids for s in self.shards], ())
        ntotals = jax.device_put(
            np.asarray([s.store.ntotal for s in self.shards], np.int32),
            NamedSharding(self.mesh, P(AXIS)),
        )
        split = ()
        if self.storage_type is StorageType.INT8:
            # one shared scale vector (replicated); per-shard max‖v_q‖
            scales = jax.device_put(
                np.asarray(jax.device_get(self.shards[0].store.scales),
                           np.float32),
                NamedSharding(self.mesh, P(None)),
            )
            int_norms = jax.device_put(
                np.asarray([
                    float(jax.device_get(s.store.int_norm_max))
                    if s.store.int_norm_max is not None else 0.0
                    for s in self.shards
                ], np.float32),
                NamedSharding(self.mesh, P(AXIS)),
            )
            split = (scales, int_norms)
        elif (self.shards[0].store.db_hi is not None
              or self.storage_type is StorageType.FLOAT16):
            def stats_piece(s):
                # empty shards have no stats yet — zeros are the exact maxima
                with jax.default_device(s.device):
                    st = s.store.split_stats
                    if st is None:
                        st = jnp.zeros((2,), jnp.float32)
                    return st.reshape(1, 2)

            pieces = []
            for r in range(self.num_replicas):
                for i, s in enumerate(self.shards):
                    piece = stats_piece(s)
                    if r != 0:
                        piece = jax.device_put(piece, dev_grid[r][i])
                    pieces.append(piece)
            stats = jax.make_array_from_single_device_arrays(
                (p, 2), NamedSharding(self.mesh, P(AXIS, None)), pieces
            )
            if self.storage_type is StorageType.FLOAT16:
                # 2 B/elem f16-bits: db carries everything, only the
                # certificate stats ride as split
                split = (stats,)
            else:
                split = (
                    global_arr([s.store.db_hi for s in self.shards],
                               (d_pad,)),
                    global_arr([s.store.db_lo for s in self.shards],
                               (d_pad,)),
                    stats,
                )
        if self.shards[0].store.db is not None:
            db = global_arr([s.store.db for s in self.shards], (d_pad,))
        else:
            db = split[0]  # pair-only HBM: hi stands in (see _build fn)
        self._assembled = (db, norms, gids, ntotals, cap, split)
        return self._assembled

    # -- search -------------------------------------------------------------------
    def _prep_queries(self, x: np.ndarray):
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected (n, {self.d}) queries, got {x.shape}")
        nq = x.shape[0]
        # rows must split evenly over replicas AND stay 8-aligned per replica
        unit = NQ_PAD * self.num_replicas
        nq_pad = max(unit, _round_up(nq, unit))
        d_pad = self.shards[0].store.d_pad
        if nq_pad != nq or d_pad != self.d:
            # pad on the host: ONE committed transfer, no uncommitted
            # intermediates on the default backend
            qh = np.zeros((nq_pad, d_pad), np.float32)
            qh[:nq, : self.d] = x
        else:
            qh = x
        q = jax.device_put(
            qh, NamedSharding(self.mesh, P(REPLICA_AXIS, None))
        )
        return q, qh, nq, nq_pad

    def _sel_global(self, params):
        """Evaluate ``params``' selector over GLOBAL ids → one (P·cap,) bool
        stream sharded over the shards axis (each shard sees its local
        (cap,) slice), or None when nothing is filtered. Host-side mapping
        rides the contiguous gid extents — no device round-trip."""
        sel_mod.reject_ivf_params(params)
        if params is None or getattr(params, "sel", None) is None:
            sel_mod.selector_mask(params, np.empty(0, np.int64))  # validate
            return None
        cap = self._assemble()[4]  # post-equalization per-shard capacity
        masks = np.zeros((self.num_shards, cap), dtype=bool)
        any_excluded = False
        for g0, g1, si, l0 in self._extents:
            m = params.sel.is_member(np.arange(g0, g1, dtype=np.int64))
            masks[si, l0: l0 + (g1 - g0)] = m
            any_excluded = any_excluded or not m.all()
        if not any_excluded:
            return None  # all-admitted: keep the fused path (identical)
        return jax.device_put(
            masks.reshape(-1), NamedSharding(self.mesh, P(AXIS)))

    def _run_search_fn(self, q, k: int, nq_pad: int, *, force_plain: bool,
                       full_sweep: bool = False, sel=None):
        """Build (cached) + enqueue one sharded program for the current shape.

        Returns (dists, glabels, cert, use_fused). ``sel``: global selector
        stream from _sel_global — honored by every local-scan path, fused
        included (folded into the pre-masked norm stream like padding)."""
        db, norms, gids, ntotals, cap, split = self._assemble()
        max_local = max(s.store.ntotal for s in self.shards)
        nv_eff = min(cap, _round_up(max(max_local, 1), ROW_TILE))
        chunk = self.tuning.chunk_v
        d_pad = self.shards[0].store.d_pad
        nq_local = nq_pad // self.num_replicas  # per replica group
        # hi_exact needs EVERY shard's exact split statistics to be zero
        # (see index.py — integer-valued data; bit-identical hi-plane sweep,
        # and the cost gate sees the effective 2 B/elem sweep)
        stats_zero = (self.shards[0].store.db_hi is not None
                      and all(s.store.split_stats_host() == (0.0, 0.0)
                              for s in self.shards if s.store.ntotal))
        use_fused = (
            not force_plain
            and not self._force_xla
            and pallas_fused.fused_path_eligible(
                metric=self.metric, k=int(k), nv_eff=nv_eff, d_pad=d_pad,
                nq_pad=nq_local,
                itemsize=2 if stats_zero
                else jnp.dtype(self.shards[0].store.dtype).itemsize,
                dtype=self.shards[0].store.dtype,
            )
        )
        pair_storage = self.shards[0].store.dtype != jnp.bfloat16
        hi_exact = use_fused and stats_zero
        f16_clean = (self.storage_type is StorageType.FLOAT16
                     and any(s.store.ntotal for s in self.shards)
                     and all(s.store.f16_clean()
                             for s in self.shards if s.store.ntotal))
        sweep_passes = 2 if (full_sweep
                             or nq_local in self._no_reduced_sweep) \
            else pallas_fused.pick_sweep_passes(
                nq_local, pair_storage and not hi_exact)
        interpret = self.res.capabilities.interpret
        pair_only = self.shards[0].store.pair_only
        is_int8 = self.storage_type is StorageType.INT8
        use_split = bool(split) and (is_int8 or use_fused or pair_only)
        with_sel = sel is not None
        key = ("sharded_search", self.num_shards, self.num_replicas, nv_eff,
               cap, d_pad, nq_pad, int(k), self.metric,
               self.storage_type, chunk, use_fused, use_split, pair_only,
               sweep_passes, hi_exact, f16_clean, with_sel)
        fn = self.res.cached(
            key,
            lambda: _build_sharded_search_fn(
                mesh=self.mesh, nv_eff=nv_eff, nq_pad=nq_local, k=int(k),
                metric=self.metric, chunk=chunk,
                use_fused=use_fused, use_split=use_split, interpret=interpret,
                pair_only=pair_only, sweep_passes=sweep_passes,
                int8=is_int8,
                f16bits=self.storage_type is StorageType.FLOAT16,
                hi_exact=hi_exact,
                f16_clean=f16_clean,
                with_sel=with_sel,
            ),
        )
        args = (db, norms, gids, ntotals, q) \
            + ((sel,) if with_sel else ()) \
            + (split if use_split else ())
        # last element: did THIS search run the reduced single-pass sweep
        # (tier-1 fallback + shape pinning apply)? Returned rather than
        # re-derived at the call site — the index.py mirror drifted once
        return fn(*args) + (use_fused, use_fused and sweep_passes == 1)

    def _search_device(self, x: np.ndarray, k: int, params=None):
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        q, qh, nq, nq_pad = self._prep_queries(x)
        if self.ntotal == 0:
            sel_mod.selector_mask(params, np.empty(0, np.int64))  # validate
            return None, nq, nq_pad
        sel = self._sel_global(params)
        dists, glabels, cert, use_fused, reduced = self._run_search_fn(
            q, k, nq_pad, force_plain=False, sel=sel)
        fallback = None
        if use_fused:
            fallback = make_selective_fallback(
                self, qh, nq, k,
                pad_unit=NQ_PAD * self.num_replicas,
                pin_key=nq_pad // self.num_replicas,  # per-replica shape key
                reduced=reduced,
                to_device=lambda qb: jax.device_put(
                    qb, NamedSharding(self.mesh, P(REPLICA_AXIS, None))),
                sel=sel,
            )
        return (dists, glabels, cert, fallback), nq, nq_pad

    def search(self, x: np.ndarray, k: int,
               params=None) -> Tuple[np.ndarray, np.ndarray]:
        out, nq, _ = self._search_device(x, k, params)
        if out is None:
            d = np.full((nq, k), worst_distance(self.metric), np.float32)
            return d, np.full((nq, k), -1, np.int64)
        return TpuSearchToken(out[0], out[1], nq, out[2], out[3]).wait()

    def search_async(self, x: np.ndarray, k: int,
                     params=None) -> TpuSearchToken:
        out, nq, _ = self._search_device(x, k, params)
        if out is None:
            tok = TpuSearchToken(None, None, nq)
            d = np.full((nq, k), worst_distance(self.metric), np.float32)
            tok._result = (d, np.full((nq, k), -1, np.int64))
            return tok
        return TpuSearchToken(out[0], out[1], nq, out[2], out[3])

    def assign(self, x: np.ndarray, k: int = 1) -> np.ndarray:
        """Labels-only search (faiss::Index::assign)."""
        return self.search(x, k)[1]

    # -- range search ---------------------------------------------------------
    def _run_range_fn(self, q, nq_pad: int, thr: np.float32, cap: int,
                      sel=None):
        """Sharded analog of TpuIndexFlat._run_range_fn: one shard_map scan,
        per-shard chunk blocks stacked on the host chunk axis, global ids."""
        db, norms, gids, ntotals, cap_rows, split = self._assemble()
        max_local = max(s.store.ntotal for s in self.shards)
        nv_eff = min(cap_rows, _round_up(max(max_local, 1), ROW_TILE))
        chunk = min(self.tuning.chunk_v, nv_eff)
        while nv_eff % chunk:
            chunk -= ROW_TILE
        cap = min(cap, chunk)
        is_int8 = self.storage_type is StorageType.INT8
        is_f16 = self.storage_type is StorageType.FLOAT16
        pair_only = self.shards[0].store.pair_only
        nblocks = self.num_shards * (nv_eff // chunk)
        if nblocks * nq_pad * cap * 8 > (2 << 30):
            raise ValueError(
                "range_search result buffers would exceed 2 GB "
                f"(~{nblocks * nq_pad * cap} candidate slots); "
                "split the query batch or tighten the radius")
        with_sel = sel is not None
        key = ("sharded_range", self.num_shards, self.num_replicas, nv_eff,
               cap_rows, self.shards[0].store.d_pad, nq_pad, self.metric,
               self.storage_type, chunk, cap, pair_only, with_sel)
        fn = self.res.cached(
            key,
            lambda: _build_sharded_range_fn(
                mesh=self.mesh, nv_eff=nv_eff, chunk=chunk, cap=cap,
                metric=self.metric, int8=is_int8, f16bits=is_f16,
                pair_only=pair_only, with_sel=with_sel,
            ),
        )
        if is_int8:
            rsplit = (split[0],)            # scales (replicated)
        elif pair_only:
            rsplit = (split[0], split[1])   # (hi, lo)
        else:
            rsplit = ()
        if with_sel:
            rsplit = (sel,) + rsplit
        counts, vals, ids = fn(db, norms, gids, ntotals, q, thr, *rsplit)
        return jax.device_get((counts, vals, ids)) + (cap,)

    def range_search(
        self, x: np.ndarray, radius: float, params=None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sharded range search, faiss CSR contract — see
        TpuIndexFlat.range_search. Every shard contributes ALL its in-radius
        rows (no k truncation anywhere), so the union is complete; ids are
        global, per-query segments sorted best-first with id tiebreak."""
        q, _qh, nq, nq_pad = self._prep_queries(x)
        if self.ntotal == 0:
            sel_mod.selector_mask(params, np.empty(0, np.int64))  # validate
            return (np.zeros(nq + 1, np.int64), np.empty(0, np.float32),
                    np.empty(0, np.int64))
        sel = self._sel_global(params)
        thr = np.float32(-radius if self.metric is MetricType.L2 else radius)
        return _range_csr(
            lambda cap: self._run_range_fn(q, nq_pad, thr, cap, sel=sel),
            nq, self.metric)

    def describe(self) -> str:
        per = [s.store.ntotal for s in self.shards]
        hbm = sum(s.store.hbm_bytes() for s in self.shards)
        return (
            f"ShardedIndexFlat(d={self.d}, metric={self.metric.value}, "
            f"storage={self.storage_type.value}, ntotal={self.ntotal}, "
            f"shards={self.num_shards}, per_shard={per}, "
            f"hbm={hbm / 1e6:.1f} MB, "
            f"pair_only={self.shards[0].store.pair_only}, "
            f"fused_fallbacks={self.fused_fallbacks})\n" + self.res.describe()
        )
