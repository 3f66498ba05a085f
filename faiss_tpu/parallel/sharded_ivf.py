"""ShardedIndexIVFFlat — IVF-Flat over a device mesh (VERDICT r3 #5).

Architecture (the IVF analog of parallel/sharded.py):
  * the coarse quantizer's CENTROIDS are replicated on every chip; the
    VECTORS are distributed — each shard is a full TpuIndexIVFFlat
    chunk-paged pool + page table (all nlist lists; shapes equalized at
    assembly) holding its ~1/P of the rows, with GLOBAL insertion ids in
    the device id column;
  * ``add`` splits each batch contiguously across shards (balanced ±1) and
    routes ONCE through the shared quantizer — every shard keeps the same
    list semantics, so the union of per-shard probes of the same nprobe
    lists is exactly the single-chip probe set (recall is shard-count
    invariant by construction);
  * ``search`` is ONE jitted ``shard_map`` program over a 1-D shards mesh:
    replicated coarse GEMM probe → local bucket gather/score (the SAME
    ``ivf._probed_scores`` block as the single-device index, so criteria
    cannot drift) → local top-k → ``all_gather`` of the (k, gid) lists over
    the interconnect → lexicographic merge (score desc, gid asc —
    tie-exact vs the single-device index).

Storage kinds mirror TpuIndexIVFFlat: f32 / bf16 / int8 (1 B/elem lists,
one frozen scale grid shared by every shard — shard-count-invariant
quantization). Surface: add/train/search/search_async/reconstruct/
describe/reset + selectors, the per-query nprobe override, and exact-bits
save/load (io.py:72-95, tests/test_io.py); remove_ids / merge_from /
range_search remain single-chip features (TpuIndexIVFFlat).

Tested on the emulated 8-device CPU mesh (tests/conftest.py), like every
multi-chip path here (SURVEY.md §4).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..dtypes import MetricType, StorageType, worst_distance
from ..ops import distance as dist_ops
from ..resources import TpuResources, default_resources
from .. import selector as sel_mod
from ..storage import LANE, _round_up
from ..ivf import (TpuIndexIVFFlat, _kernel_scan, _GATHER_BUDGET, _QB,
                   _CHUNK, _chunk_budget)
from ..index import TpuSearchToken

AXIS = TpuResources.SHARD_AXIS


def _build_sharded_ivf_search_fn(*, mesh, nlist: int, nprobe: int,
                                 nq_pad: int, k: int, d_pad: int,
                                 metric: MetricType, kind: str, nbudget: int,
                                 with_sel: bool = False,
                                 interpret: bool = False):
    """One shard_map program: replicated probe, local fine scan, merge.

    fn(data (P·npool·128, d_pad), norms, ids (P·npool·128,) i32 GLOBAL,
    counts (P·nlist,) i32, ctable (P·nlist, maxc) i32 — per-shard page
    tables, cents (nlist_pad, d_pad) replicated, cnorms, q (nq_pad, d_pad)
    replicated [, sel (P·npool·128,)] [, scales (d_pad,)])
    -> (dists (nq_pad, k) f32, glabels (nq_pad, k) i32) replicated."""
    k_loc = min(k, nbudget * _CHUNK)

    def per_device(data, norms, ids, counts, ctable, cents, cnorms, q,
                   *extra):
        sel = extra[0] if with_sel else None
        scales = extra[-1] if kind == "int8" else None
        # coarse probe: identical on every shard (replicated centroids) —
        # the probed LISTS are global; each shard scans its own members
        cs = dist_ops.matmul_scores(q, cents, cnorms, metric)
        _, probe = jax.lax.top_k(cs, nprobe)
        qn = jnp.sum(q * q, axis=-1, dtype=jnp.float32)
        qeff = q * scales[None, :] if kind == "int8" else q

        # local fine scan: the same chunk-scan kernel as the single-device
        # index (ivf._kernel_scan), over this shard's pool
        v, g = _kernel_scan(data, norms, counts, ids, ctable, sel, qeff, qn,
                            probe, nbudget=nbudget, nprobe=nprobe, k=k_loc,
                            metric=metric, interpret=interpret)
        g = jnp.where(v > -jnp.inf, g, jnp.int32(-1))

        # merge: gather the tiny k-lists; every device merges identically.
        av = jax.lax.all_gather(v, AXIS)      # (P, nq_pad, k_loc)
        ag = jax.lax.all_gather(g, AXIS)
        P_ = av.shape[0]
        av = jnp.moveaxis(av, 0, 1).reshape(nq_pad, P_ * k_loc)
        ag = jnp.moveaxis(ag, 0, 1).reshape(nq_pad, P_ * k_loc)
        k_out = min(k, P_ * k_loc)
        # lexicographic (score desc, gid asc): tie-exact vs single-chip
        order = jnp.lexsort((ag, -av), axis=-1)[..., :k_out]
        tv = jnp.take_along_axis(av, order, axis=-1)
        tg = jnp.take_along_axis(ag, order, axis=-1)
        ok = (tg >= 0) & (tv > -jnp.inf)
        dists = dist_ops.scores_to_distances(tv, metric)
        dists = jnp.where(ok, dists, worst_distance(metric))
        tg = jnp.where(ok, tg, jnp.int32(-1))
        if k_out < k:
            dists = jnp.concatenate([
                dists, jnp.full((nq_pad, k - k_out), worst_distance(metric),
                                jnp.float32)], axis=-1)
            tg = jnp.concatenate([
                tg, jnp.full((nq_pad, k - k_out), -1, jnp.int32)], axis=-1)
        return dists, tg

    in_specs = [P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(None),
                P(None), P(None)]
    if with_sel:
        in_specs.append(P(AXIS))
    if kind == "int8":
        in_specs.append(P(None))
    fn = jax.shard_map(
        per_device, mesh=mesh, in_specs=tuple(in_specs),
        out_specs=(P(None), P(None)), check_vma=False)
    return jax.jit(fn)


class ShardedIndexIVFFlat:
    """IVF-Flat sharded over the mesh — see the module docstring."""

    def __init__(self, d: int, nlist: int, metric=MetricType.L2,
                 storage=StorageType.FLOAT32, nprobe: int = 1,
                 resources: Optional[TpuResources] = None,
                 num_shards: Optional[int] = None,
                 train_niter: int = 10, seed: int = 1234):
        self.d, self.nlist = int(d), int(nlist)
        self.metric = MetricType.coerce(metric)
        self.storage_type = StorageType.coerce(storage)
        self.res = resources if resources is not None else default_resources()
        p = num_shards or len(self.res.devices)
        if p < 1 or p > len(self.res.devices):
            raise ValueError(f"num_shards={p} exceeds available devices")
        self.devices = list(self.res.devices[:p])
        self.mesh = jax.sharding.Mesh(np.asarray(self.devices), (AXIS,))
        self.nprobe = int(nprobe)
        self.d_pad = _round_up(self.d, LANE)
        # one sub-index per shard; quantizer/centroids/scales are SHARED
        # (installed into every shard by train())
        self.shards: List[TpuIndexIVFFlat] = [
            TpuIndexIVFFlat(d, nlist, metric=self.metric,
                            storage=self.storage_type, nprobe=nprobe,
                            resources=self.res, train_niter=train_niter,
                            seed=seed)
            for _ in range(p)]
        self.ntotal = 0
        self._next_shard = 0
        # global id -> (shard, local insertion id): reconstruct + selectors
        self._id_shard = np.empty(0, np.int16)
        self._id_local = np.empty(0, np.int64)
        self._assembled = None

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def is_trained(self) -> bool:
        return self.shards[0].is_trained

    @property
    def quantizer(self):
        return self.shards[0].quantizer

    def train(self, x: np.ndarray) -> None:
        """Train ONE quantizer (+ int8 scale grid) and install it into every
        shard — identical routing and quantization per shard is what makes
        results shard-count invariant."""
        if self.is_trained:
            return
        s0 = self.shards[0]
        s0.train(np.ascontiguousarray(x, np.float32))
        for s in self.shards[1:]:
            if self.storage_type is StorageType.INT8:
                s._scales = s0._scales
            s._set_centroids(
                np.stack([s0.quantizer.reconstruct(j)
                          for j in range(self.nlist)]),
                quantizer=s0.quantizer)

    # -- mutation ---------------------------------------------------------------
    def add(self, x: np.ndarray) -> None:
        if not self.is_trained:
            raise RuntimeError("IndexIVFFlat requires train() before add")
        x = np.ascontiguousarray(x, np.float32)
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected (n, {self.d}) vectors, got {x.shape}")
        n = x.shape[0]
        if n == 0:
            return
        # ONE coarse routing for the whole batch, then a balanced
        # contiguous split (rotating remainder like ShardedIndexFlat.add)
        assign = self.quantizer.assign(x).ravel().astype(np.int64)
        p = self.num_shards
        base, rem = divmod(n, p)
        counts = [base + (1 if (i - self._next_shard) % p < rem else 0)
                  for i in range(p)]
        self._next_shard = (self._next_shard + rem) % p
        off = 0
        gid0 = self.ntotal
        id_shard = np.empty(n, np.int16)
        id_local = np.empty(n, np.int64)
        for i, c in enumerate(counts):
            if c == 0:
                continue
            sh = self.shards[i]
            gids = np.arange(gid0 + off, gid0 + off + c, dtype=np.int32)
            sub = x[off: off + c]
            if self.storage_type is StorageType.INT8:
                from ..storage import _quantize_int8_fn

                xp = np.zeros((c, self.d_pad), np.float32)
                xp[:, : self.d] = sub
                vq, nrm, _qn, clip = _quantize_int8_fn(jnp.asarray(xp),
                                                       sh._scales)
                sh._int8_elems += c * self.d
                sh._int8_clipped = (clip if sh._int8_clipped is None
                                    else sh._int8_clipped + clip)
                sh._add_preassigned(vq, nrm, assign[off: off + c],
                                    global_ids=gids)
            else:
                nrm = (sub.astype(np.float64) ** 2).sum(1).astype(np.float32)
                sh._add_preassigned(sub, nrm, assign[off: off + c],
                                    global_ids=gids)
            id_shard[off: off + c] = i
            id_local[off: off + c] = np.arange(sh.ntotal - c, sh.ntotal)
            off += c
        self._id_shard = np.concatenate([self._id_shard, id_shard])
        self._id_local = np.concatenate([self._id_local, id_local])
        self.ntotal += n
        self._assembled = None

    def reset(self) -> None:
        for s in self.shards:
            s.reset()
        self.ntotal = 0
        self._next_shard = 0
        self._id_shard = np.empty(0, np.int16)
        self._id_local = np.empty(0, np.int64)
        self._assembled = None

    def reconstruct(self, key: int) -> np.ndarray:
        if not 0 <= key < self.ntotal:
            raise IndexError(f"id {key} out of range [0, {self.ntotal})")
        return self.shards[int(self._id_shard[key])].reconstruct(
            int(self._id_local[key]))

    # -- assembly ---------------------------------------------------------------
    def _assemble(self):
        """Equalize per-shard pool/page-table shapes, then stack the
        per-shard tensors into global arrays sharded over the mesh
        (cached until mutation)."""
        if self._assembled is not None:
            return self._assembled
        # pools are _POOL0·2^k and table widths 2^j, so the per-shard
        # doubling in _ensure_pool lands exactly on the max
        npool = max(max((s.npool for s in self.shards), default=0), 1)
        maxc = max(max((s.maxc for s in self.shards), default=0), 1)
        for s in self.shards:
            s._ensure_pool(npool, maxc)
            s._ctable = jax.device_put(jnp.asarray(s._ctable_host))
            if s._counts_dev is None:
                s._counts_dev = jax.device_put(s._counts)

        def global_arr(pieces, tail):
            gshape = (self.num_shards * pieces[0].shape[0],) + tail
            sharding = NamedSharding(self.mesh, P(AXIS, *([None] * len(tail))))
            parts = [jax.device_put(pc, dev)
                     for pc, dev in zip(pieces, self.devices)]
            return jax.make_array_from_single_device_arrays(
                gshape, sharding, parts)

        data = global_arr([s._data for s in self.shards], (self.d_pad,))
        norms = global_arr([s._norms for s in self.shards], ())
        ids = global_arr([s._ids for s in self.shards], ())
        counts = global_arr([jnp.asarray(s._counts) for s in self.shards], ())
        ctable = global_arr([s._ctable for s in self.shards], (maxc,))
        cents = jax.device_put(
            self.shards[0]._cents, NamedSharding(self.mesh, P(None, None)))
        cnorms = jax.device_put(
            self.shards[0]._cnorms, NamedSharding(self.mesh, P(None)))
        scales = None
        if self.storage_type is StorageType.INT8:
            scales = jax.device_put(
                self.shards[0]._scales, NamedSharding(self.mesh, P(None)))
        self._assembled = (data, norms, ids, counts, ctable, cents, cnorms,
                           scales, npool, maxc)
        return self._assembled

    # -- search -----------------------------------------------------------------
    def _prep(self, x, params):
        if not self.is_trained:
            raise RuntimeError("IndexIVFFlat requires train() before search")
        x = np.ascontiguousarray(x, np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected (n, {self.d}) queries, got {x.shape}")
        nq = x.shape[0]
        req = getattr(params, "nprobe", None) if params is not None else None
        nprobe = min(req if req is not None else self.nprobe, self.nlist)
        if params is None or getattr(params, "sel", None) is None:
            sel_mod.selector_mask(params, np.empty(0, np.int64))  # validate
            mask = None
        else:
            mask = sel_mod.selector_mask(
                params, np.arange(self.ntotal, dtype=np.int64))
        nq_pad = max(_QB, _round_up(nq, _QB))
        qp = np.zeros((nq_pad, self.d_pad), np.float32)
        qp[:nq, : self.d] = x
        return qp, nq, nq_pad, nprobe, mask

    def _sel_stream(self, mask, npool):
        """Global admit mask -> per-shard SLOT-indexed bool stream, stacked
        over shards (each shard sees its local (npool·128,) slice)."""
        if mask is None or mask.all():
            return None
        s = np.zeros((self.num_shards, npool * _CHUNK), bool)
        gids = np.nonzero(mask)[0]
        for i, sh in enumerate(self.shards):
            loc = self._id_local[gids[self._id_shard[gids] == i]]
            s[i, sh._slot_of[loc]] = True
        return jax.device_put(
            s.reshape(-1), NamedSharding(self.mesh, P(AXIS)))

    def _search_device(self, x, k: int, params=None):
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        qp, nq, nq_pad, nprobe, mask = self._prep(x, params)
        if self.ntotal == 0:
            return None, nq
        data, norms, ids, counts, ctable, cents, cnorms, scales, npool, \
            maxc = self._assemble()
        # one static budget for the shard_map program: the worst shard's
        # exact chunk budget (per-shard counts differ); the per-shard
        # working set is bounded like the single-device index's
        nbudget = max(_chunk_budget(s._counts, nprobe, _CHUNK)
                      for s in self.shards)
        footprint = nq_pad * nbudget * _CHUNK * 4
        if footprint > _GATHER_BUDGET:
            raise ValueError(
                f"IVF fine scan working set would be {footprint >> 20} MB "
                f"per shard (nprobe={nprobe}, chunk budget={nbudget}); "
                "lower nprobe (oversized query batches are split "
                "automatically — hitting this means even one query block "
                "exceeds the budget)")
        sel = self._sel_stream(mask, npool)
        with_sel = sel is not None
        key = ("sharded_ivf", self.num_shards, self.nlist, npool, maxc,
               nprobe, nbudget, nq_pad, int(k), self.d_pad, self.metric,
               self.storage_type, with_sel)
        fn = self.res.cached(
            key,
            lambda: _build_sharded_ivf_search_fn(
                mesh=self.mesh, nlist=self.nlist, nprobe=nprobe,
                nq_pad=nq_pad, k=int(k), d_pad=self.d_pad,
                metric=self.metric, nbudget=nbudget,
                kind=self.shards[0]._kind, with_sel=with_sel,
                interpret=self.res.capabilities.interpret))
        q = jax.device_put(qp, NamedSharding(self.mesh, P(None, None)))
        args = (data, norms, ids, counts, ctable, cents, cnorms, q)
        if with_sel:
            args = args + (sel,)
        if self.storage_type is StorageType.INT8:
            args = args + (scales,)
        return fn(*args), nq

    def search(self, x, k: int, params=None) -> Tuple[np.ndarray, np.ndarray]:
        return self.search_async(x, k, params=params).wait()

    def _nq_cap(self, nprobe: int) -> Optional[int]:
        """Per-dispatch query-row cap (see TpuIndexIVFFlat._nq_cap): the
        per-shard fine scan materializes (nq_pad, nbudget·CHUNK) f32."""
        if not any(s.npool for s in self.shards) or nprobe >= self.nlist:
            return None
        nbudget = max(_chunk_budget(s._counts, nprobe, _CHUNK)
                      for s in self.shards)
        cap = _GATHER_BUDGET // max(nbudget * _CHUNK * 4, 1)
        return max(_QB, cap // _QB * _QB)

    def search_async(self, x, k: int, params=None):
        from ..index import ConcatSearchToken

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
        return TpuSearchToken(out[0], out[1], nq)

    def assign(self, x, k: int = 1) -> np.ndarray:
        return self.search(x, k)[1]

    def list_sizes(self) -> np.ndarray:
        """Per-list occupancy summed over shards (== the single-chip
        index's list_sizes for the same adds)."""
        out = np.zeros(self.nlist, np.int64)
        for s in self.shards:
            out += s._counts
        return out

    def describe(self) -> str:
        per = [s.ntotal for s in self.shards]
        pools = [f"{s._used_chunks}/{s.npool}" for s in self.shards]
        return (
            f"ShardedIndexIVFFlat(d={self.d}, nlist={self.nlist}, "
            f"nprobe={self.nprobe}, metric={self.metric.value}, "
            f"storage={self.storage_type.value}, ntotal={self.ntotal}, "
            f"shards={self.num_shards}, per_shard={per}, pool={pools}, "
            f"trained={self.is_trained})")
