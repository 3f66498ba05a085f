"""Device-side vector storage with amortized growth.

≈ MetalTensor<T,Dim> (src/MetalTensor.h) + MetalIndexFlat's add()/grow logic
(src/MetalIndexFlat.mm:185-311):
  * capacity grows by doubling with a 1024-row floor, copying old data
    (reference mm:194-219) — here the copy is a donated, jitted
    ``dynamic_update_slice`` so XLA reuses the HBM allocation when it can;
  * vectors are stored in the chosen precision (f32/bf16/f16) while database
    L2 norms are computed in fp32 *before* quantization for accuracy
    (reference mm:258-267, README.md:170); unlike the reference they are
    kept for BOTH metrics — the fused path's exactness certificate bounds
    its sweep error with max‖v‖ (ops/pallas_fused._sweep_eps);
  * dtype conversion is round-to-nearest-even on device (the reference does an
    RNE bit-trick on host CPU, mm:226-243; XLA's convert_element_type is RNE);
  * layout: rows are padded to a row-tile multiple and the feature dim is
    padded to a multiple of 128 so the sweep kernel always sees whole
    d steps. Padding rows are zero and masked out by id at select time.

The reference's MTLResidencySet pre-paging (StandardMetalResources.mm:83-91)
has no analog: jax.Arrays are HBM-resident by construction.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .dtypes import MetricType, StorageType
from . import native

MIN_CAPACITY = 1024     # reference: MetalIndexFlat.mm:199 (max(1024, 2*cap))
# Above this many elements, reduced-precision adds convert on the host with
# the threaded C++ kernels (native/) so host→device transfer is 2 bytes/elem
# instead of 4 (≈ the reference's GCD-parallel host conversion gate >100K,
# src/MetalIndexFlat.mm:228-256).
NATIVE_CONVERT_MIN_ELEMS = 1 << 20
ROW_TILE = 1024         # capacity granularity; keeps nv aligned for chunked/Pallas paths
LANE = 128              # d padded to a multiple of this (the sweep's d step)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


_JNP_DTYPE = {
    StorageType.FLOAT32: jnp.float32,
    StorageType.FLOAT16: jnp.float16,
    StorageType.BFLOAT16: jnp.bfloat16,
    StorageType.INT8: jnp.int8,
}


@jax.jit
def _norms_f32(x: jax.Array) -> jax.Array:
    return jnp.sum(x * x, axis=-1, dtype=jnp.float32)


@jax.jit
def split_f32_bf16(x: jax.Array):
    """Split fp32 into (hi, lo) bf16 so hi+lo ≈ x to ~2^-16 relative.

    `hi` is x TRUNCATED to bf16 via bit masking — an arithmetic
    `x - x.astype(bf16)` gets elided by XLA's excess-precision
    simplifier (lo would be all zeros); the bitcast form cannot be.
    Used by the fused kernel's fp32 sweep: three bf16 passes
    (hi·hi + hi·lo + lo·hi) give fp32-grade ranking at bf16 compile cost.
    """
    u = jax.lax.bitcast_convert_type(x, jnp.uint32)
    hi_f32 = jax.lax.bitcast_convert_type(
        u & jnp.uint32(0xFFFF0000), jnp.float32
    )
    hi = hi_f32.astype(jnp.bfloat16)  # exact: already bf16-representable
    lo = (x - hi_f32).astype(jnp.bfloat16)
    return hi, lo


def decode_f16_bits(bits: jax.Array) -> jax.Array:
    """int16 f16 bit patterns → EXACT f32 values. Branchless, and every
    intermediate is a NORMAL f32, so the decode stays exact on hardware that
    flushes f32 denormals:
    f16 subnormals go through the magic-exponent add trick
    (bitcast(0x38800000 | m<<13) − 2^-14 = m·2^-24 exactly, min 2^-24 ≫
    2^-126). This is how 2 B/elem f16 storage decodes inside Pallas sweep/
    kernel AND in the plain-XLA path (one bit-exact decode everywhere;
    the reference reads f16 directly in its GEMM, simdgroup_gemm.metal:303
    — the same 2 B/elem footprint).
    e=31 patterns (±inf, NaN) map to ±inf."""
    h = bits.astype(jnp.int32) & 0xFFFF
    m = h & 0x7FFF
    o = m << 13
    f_norm = jax.lax.bitcast_convert_type(o, jnp.float32) * jnp.float32(
        2.0 ** 112)
    f_sub = (jax.lax.bitcast_convert_type(o + (113 << 23), jnp.float32)
             - jnp.float32(2.0 ** -14))
    f = jnp.where(m < (1 << 10), f_sub, f_norm)
    f = jnp.where(m >= 0x7C00, jnp.float32(jnp.inf), f)
    u = jax.lax.bitcast_convert_type(f, jnp.int32) | ((h & 0x8000) << 16)
    return jax.lax.bitcast_convert_type(u, jnp.float32)


def split_f16_bits(bits: jax.Array):
    """int16 f16 bit patterns → EXACT (hi, lo) bf16 pair: hi+lo == the f16
    value bit-for-bit (11 significand bits = bf16 hi 8 + lo ≤ 3, and the
    hi truncation leaves a residual exactly representable in bf16). The
    in-kernel analog of the derived pair the 4 B/elem mode used to store."""
    f = decode_f16_bits(bits)
    uf = jax.lax.bitcast_convert_type(f, jnp.uint32)
    hi_f32 = jax.lax.bitcast_convert_type(uf & jnp.uint32(0xFFFF0000),
                                          jnp.float32)
    hi = hi_f32.astype(jnp.bfloat16)  # exact: already bf16-representable
    lo = jnp.where(jnp.isfinite(f), f - hi_f32, 0.0).astype(jnp.bfloat16)
    return hi, lo


def split_f16_bits_clean(bits: jax.Array):
    """split_f16_bits for CLEAN bit patterns — caller has proven (exact
    encode-time counter, DeviceStore.f16_clean) that no stored element is
    an f16 subnormal, inf, or NaN. Drops the magic-add subnormal path, the
    two range selects, and the f32 round trip of the generic decode: ~15
    VPU ops/element vs ~25 (the f16 sweep is VPU-decode-bound — r3e
    measured 0.995 ms of a 1.2 ms e2e in the decode-heavy sweep). Bit-
    identical to split_f16_bits on every clean pattern (normals and ±0;
    the sign bit rides the pre-scale bits so −0 round-trips), enforced by
    tests/test_storage_modes.py."""
    h = bits.astype(jnp.int32) & 0xFFFF
    o = ((h & 0x7FFF) << 13) | ((h & 0x8000) << 16)
    # e5 ≥ 1 for clean nonzero patterns → the pre-scale f32 is NORMAL
    # (exp field = e5 ∈ [1, 30]) — no denormal flush; ×2^112 exact
    f = jax.lax.bitcast_convert_type(o, jnp.float32) * jnp.float32(2.0 ** 112)
    uf = jax.lax.bitcast_convert_type(f, jnp.uint32)
    hi_f32 = jax.lax.bitcast_convert_type(uf & jnp.uint32(0xFFFF0000),
                                          jnp.float32)
    hi = hi_f32.astype(jnp.bfloat16)  # exact: already bf16-representable
    lo = (f - hi_f32).astype(jnp.bfloat16)  # exact ≤3-bit residual
    return hi, lo


@jax.jit
def encode_f16_bits(x: jax.Array) -> jax.Array:
    """fp32 → f16 (RNE, XLA convert) → int16 bit patterns for HBM."""
    return jax.lax.bitcast_convert_type(x.astype(jnp.float16), jnp.int16)


@jax.jit
def split3_f32_bf16(x: jax.Array):
    """EXACT 3-way split: x == hi + mid + lo (each bf16, as fp32 values).

    fp32 has 24 mantissa bits = 3 × bf16's 8; truncating twice leaves a
    residual with ≤ 8 significant bits, so the last term is exact. Used for
    fp32-true rescoring against bf16-stored rows in three bf16 passes.
    """
    def trunc(v):
        u = jax.lax.bitcast_convert_type(v, jnp.uint32)
        return jax.lax.bitcast_convert_type(
            u & jnp.uint32(0xFFFF0000), jnp.float32
        )

    hi_f32 = trunc(x)
    r1 = x - hi_f32
    mid_f32 = trunc(r1)
    lo = (r1 - mid_f32).astype(jnp.bfloat16)
    return hi_f32.astype(jnp.bfloat16), mid_f32.astype(jnp.bfloat16), lo


def _append_fn(db, norms, vecs, new_norms, offset):
    """Donated in-place append of n rows at `offset` (traced as dynamic)."""
    db = jax.lax.dynamic_update_slice(db, vecs, (offset, 0))
    norms = jax.lax.dynamic_update_slice(norms, new_norms, (offset,))
    return db, norms


_append_jit = jax.jit(_append_fn, donate_argnums=(0, 1))


def _append1_fn(buf, rows, offset):
    return jax.lax.dynamic_update_slice(buf, rows, (offset, 0))


_append1_jit = jax.jit(_append1_fn, donate_argnums=(0,))


def _append_norms_fn(norms, new_norms, offset):
    return jax.lax.dynamic_update_slice(norms, new_norms, (offset,))


_append_norms_jit = jax.jit(_append_norms_fn, donate_argnums=(0,))


def _compact_fn(arr, idx):
    # out-of-range indices (the compacted tail) fill with 0, restoring the
    # freshly-allocated padding state search paths rely on
    # idx is non-decreasing (survivors ascending, then the repeated sentinel)
    return jnp.take(arr, idx, axis=0, mode="fill", fill_value=0,
                    indices_are_sorted=True)


_compact_jit = jax.jit(_compact_fn, donate_argnums=(0,))


@jax.jit
def _quantize_int8_fn(xd, scales):
    """Per-dim symmetric int8 quantization (scales from train()).

    Returns (vq int8, norms f32 of the DECODED vectors, batch max ‖vq‖,
    count of clipped elements). The decoded norms make the int8 ranking
    contract self-consistent: both the sweep epilogue and the rescore
    subtract the same stored ‖v̂‖², so results are the exact top-k of the
    decoded database. The clipped count feeds DeviceStore's observability
    counter: scales freeze on train() (first add batch under auto-train),
    so a later batch whose range outgrew the trained range clips silently —
    the search stays certified-exact vs the DECODED database, but recall vs
    the original data degrades (ADVICE r2)."""
    raw = jnp.round(xd / scales[None, :])
    # f32 count (x64 is disabled; a fraction is what observability needs)
    clipped = jnp.sum((jnp.abs(raw) > 127.0).astype(jnp.float32))
    q = jnp.clip(raw, -127.0, 127.0)
    vq = q.astype(jnp.int8)
    dec = q * scales[None, :]
    norms = jnp.sum(dec * dec, axis=-1, dtype=jnp.float32)
    vq_norm = jnp.sqrt(jnp.max(jnp.sum(q * q, axis=-1)))
    return vq, norms, vq_norm, clipped


@jax.jit
def _split_stats_fn(old, vecs32, hi, lo):
    """Running (2,) f32 [max‖v_lo‖, max‖v − hi − lo‖] over all stored rows.

    These are the EXACT data-dependent bounds the fused path's certificate
    uses for the pair sweep's dropped lo·lo term and the v-pair residual
    (pallas_fused._sweep_eps) — the generic 2^-7/2^-15·max‖v‖ envelopes are
    wildly loose on integer-valued data (e.g. SIFT descriptors split
    exactly: both maxima are 0), where they made every large-k certificate
    fail and forced plain-path reruns."""
    lo32 = lo.astype(jnp.float32)
    resid = vecs32 - hi.astype(jnp.float32) - lo32
    batch = jnp.stack([
        jnp.max(jnp.sqrt(jnp.sum(lo32 * lo32, axis=-1))),
        jnp.max(jnp.sqrt(jnp.sum(resid * resid, axis=-1))),
    ])
    return jnp.maximum(old, batch)


@jax.jit
def _f16_stats_fn(old, bits):
    """f16 bit-pattern rows → (running split statistics, count of inf/NaN
    patterns), in one program so the decoded f32 rows are never
    materialized. The stats are over the decoded pair (exact for f16
    values, ≤11 significand bits). The dirty-pattern counter keeps the
    kernels on the generic decode when nonzero (split_f16_bits_clean needs
    clean bits); subnormals were flushed to ±0 at ingest (_append), so any
    well-formed finite data is clean. Padding columns are +0."""
    v32 = decode_f16_bits(bits)
    hi, lo = split_f32_bf16(v32)
    h = bits.astype(jnp.int32) & 0xFFFF
    dirty = jnp.sum(((h & 0x7C00) == 0x7C00).astype(jnp.float32))
    return _split_stats_fn(old, v32, hi, lo), dirty


def _grow_fn(old_db, old_norms, new_capacity: int):
    db = jnp.zeros((new_capacity, old_db.shape[1]), old_db.dtype)
    norms = jnp.zeros((new_capacity,), jnp.float32)
    db = jax.lax.dynamic_update_slice(db, old_db, (0, 0))
    norms = jax.lax.dynamic_update_slice(norms, old_norms, (0,))
    return db, norms


# no donation: the grown shape differs so XLA can never alias (donating only
# produces "donated buffers were not usable" warnings)
_grow_jit = jax.jit(_grow_fn, static_argnums=(2,))


class DeviceStore:
    """Grow-able (capacity, d_pad) device matrix + fp32 norms.

    ``db``/``norms`` are plain jax.Arrays; ``ntotal`` is a host int (the
    authoritative count, like faiss::Index::ntotal). Capacity is static per
    allocation so searches recompile only when capacity doubles.

    HBM layout by storage mode (bytes per vector element):
      bf16                 db bf16                                   2 B
      f16                  db int16 = the f16 BIT PATTERNS; kernels
                           decode to the exact bf16 (hi, lo) pair
                           in-register (split_f16_bits)              2 B
      f32, keep_master     db f32 master + (hi, lo) pair             8 B
      f32, ~keep_master    (hi, lo) pair ONLY; the exact f32 master
                           lives in host RAM for reconstruct/IO      4 B
    The reference stores exactly one copy (MetalIndexFlat.mm:270-307) and
    reads f16 at 2 B/elem directly in its GEMM (simdgroup_gemm.metal:303);
    f16-bits storage matches that footprint exactly (an earlier mode stored
    the derived pair at 4 B/elem), while the f32 pair is what lets
    fp32-grade ranking ride bf16 tensor-core passes. Pair-ranked
    modes score by the hi+lo value: exact for f16, ≈2^-16 relative for
    f32 (a 16-bit-mantissa quantization — far above bf16).
    """

    def __init__(
        self,
        d: int,
        storage: StorageType = StorageType.FLOAT32,
        metric: MetricType = MetricType.L2,
        device: Optional[jax.Device] = None,
        keep_master: bool = True,
    ):
        if d <= 0:
            raise ValueError(f"d must be positive, got {d}")
        self.d = int(d)
        self.d_pad = _round_up(self.d, LANE)
        self.storage = storage
        self.metric = metric
        self.dtype = _JNP_DTYPE[storage]
        # device dtype: f16 stores the bit patterns (the sweep kernel
        # decodes them in-register — split_f16_bits)
        self._db_dtype = (jnp.int16 if storage is StorageType.FLOAT16
                          else self.dtype)
        self.device = device
        self.keep_master = bool(keep_master)
        self._ntotal = 0
        self.capacity = 0
        self.db: Optional[jax.Array] = None       # (capacity, d_pad) self.dtype
        self.norms: Optional[jax.Array] = None    # (capacity,) f32 ‖v‖²
        self.db_hi: Optional[jax.Array] = None    # bf16 pair (see class doc)
        self.db_lo: Optional[jax.Array] = None
        # f32 pair-only mode: exact master rows in host RAM (unpadded)
        self._host_rows: list = []
        self._ntotal_dev: Optional[jax.Array] = None  # cached device scalar
        # (2,) f32 [max‖v_lo‖, max‖v−hi−lo‖] over stored rows (split modes
        # only) — exact certificate bounds, see _split_stats_fn
        self.split_stats: Optional[jax.Array] = None
        self._split_stats_host: Optional[tuple] = None  # lazy host mirror
        # f16 storage: running count of subnormal/inf/NaN bit patterns —
        # 0 lets kernels run the lean clean-bits decode (split_f16_bits_clean)
        self._f16_dirty: Optional[jax.Array] = None  # () f32 device counter
        self._f16_clean_host: Optional[bool] = None
        # int8 storage: per-dim quantization scales (d_pad,) f32 from
        # train(), and the running max ‖v_q‖ (certificate bound)
        self.scales: Optional[jax.Array] = None
        self.int_norm_max: Optional[jax.Array] = None  # () f32 device scalar
        # int8 observability: elements clipped to ±127 because their batch
        # outgrew the frozen training range (lazy device scalar — read via
        # the int8_clipped_fraction property)
        self._int8_clipped: Optional[jax.Array] = None  # () f32
        self._int8_elems = 0
        self._trained = storage is not StorageType.INT8

    @property
    def ntotal(self) -> int:
        return self._ntotal

    @ntotal.setter
    def ntotal(self, value: int) -> None:
        # every mutation path (add/_add_device/reset/io._add_raw) lands here —
        # drop the cached device scalar so searches never see a stale count
        self._ntotal = int(value)
        self._ntotal_dev = None

    @property
    def ntotal_dev(self) -> jax.Array:
        """ntotal as a cached device scalar: searches pass it to the jitted
        pipeline without re-uploading an int32 every call (on a
        remote-attached device each host→device transfer is a full RPC)."""
        if self._ntotal_dev is None:
            with self._ctx():
                self._ntotal_dev = self._put(jnp.int32(self._ntotal))
        return self._ntotal_dev

    @property
    def is_trained(self) -> bool:
        return self._trained

    def train(self, x: np.ndarray) -> None:
        """int8 storage: freeze per-dimension symmetric scales from a
        training sample (faiss ScalarQuantizer::train analog). Other
        storage modes need no training (no-op, like faiss IndexFlat)."""
        if self.storage is not StorageType.INT8:
            return
        if self._trained:
            raise RuntimeError(
                "int8 scales are frozen once trained (reset() does not "
                "clear them; build a new index to retrain)")
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected (n, {self.d}) fp32 array, got {x.shape}")
        amax = np.abs(x).max(axis=0)
        s = np.maximum(amax / 127.0, 1e-12).astype(np.float32)
        sp = np.ones((self.d_pad,), np.float32)  # pad dims: q is 0 there
        sp[: self.d] = s
        with self._ctx():
            self.scales = self._put(jnp.asarray(sp))
        self._trained = True

    @property
    def pair_only(self) -> bool:
        """True when HBM holds only the bf16 (hi, lo) pair (f32 with
        keep_master=False; f16 now stores 2 B/elem bit patterns instead)."""
        return self.storage is StorageType.FLOAT32 and not self.keep_master

    # -- helpers --------------------------------------------------------------
    def _put(self, x):
        if self.device is not None:
            return jax.device_put(x, self.device)
        return jax.device_put(x)

    def _ctx(self):
        """Creation context: every uncommitted intermediate (jnp.zeros,
        eager converts, pads) lands on the pinned device, never on the
        process default backend. Critical when the default backend is a
        different backend than the mesh this store shards over (a CPU-mesh
        dry run in a process that also holds an accelerator backend)."""
        if self.device is not None:
            return jax.default_device(self.device)
        return contextlib.nullcontext()

    @property
    def _has_split(self) -> bool:
        # fp32 only: three bf16 passes ≈ fp32 ranking. f16 needs no stored
        # pair — an f16 value (11 significand bits) splits EXACTLY into
        # bf16 hi (8) + lo (≤ 3 remaining), so kernels decode the 2 B bit
        # patterns in-register (split_f16_bits).
        return self.storage is StorageType.FLOAT32

    def _alloc(self, capacity: int) -> None:
        if not self.pair_only:
            self.db = self._put(
                jnp.zeros((capacity, self.d_pad), self._db_dtype))
        self.norms = self._put(jnp.zeros((capacity,), jnp.float32))
        if self._has_split:
            self.db_hi = self._put(
                jnp.zeros((capacity, self.d_pad), jnp.bfloat16))
            self.db_lo = self._put(
                jnp.zeros((capacity, self.d_pad), jnp.bfloat16))
        self.capacity = capacity

    def _ensure_capacity(self, needed: int, exact: bool = False) -> None:
        """Grow to hold `needed` rows. Default growth is amortized doubling;
        ``exact=True`` grows to exactly round_up(needed, ROW_TILE) — used when
        equalizing shard capacities (ShardedIndexFlat._assemble / io._add_raw),
        where overshooting the target makes the global array irregular and
        make_array_from_single_device_arrays rejects the shards."""
        if needed <= self.capacity:
            return
        new_cap = max(MIN_CAPACITY, _round_up(needed, ROW_TILE))
        with self._ctx():
            if self.capacity > 0:
                if not exact:
                    new_cap = max(new_cap, 2 * self.capacity)  # amortized doubling
                if self.db is not None:
                    self.db, self.norms = _grow_jit(self.db, self.norms, new_cap)
                else:
                    self.norms = self._grow_one(self.norms, new_cap)
                if self._has_split:
                    self.db_hi = self._grow_one(self.db_hi, new_cap)
                    self.db_lo = self._grow_one(self.db_lo, new_cap)
                self.capacity = new_cap
            else:
                self._alloc(new_cap)

    def _grow_one(self, buf: jax.Array, new_cap: int) -> jax.Array:
        out = jnp.zeros((new_cap,) + buf.shape[1:], buf.dtype)
        return jax.lax.dynamic_update_slice(out, buf, (0,) * buf.ndim)

    def _update_split(self, vecs: jax.Array, offset: int) -> None:
        """Maintain the derived bf16 hi/lo pair (fp32 storage) and/or the
        exact certificate split statistics (fp32 AND f16 storage).

        ``vecs`` are STORED-dtype rows; the pair splits the quantized value
        decoded to fp32 (exact for f32, and f16 bits decode + split exactly
        — split_f16_bits — so stats over the decoded pair are exact even
        though f16 stores only the 2 B bit patterns)."""
        if self.storage is StorageType.FLOAT16:
            bits = vecs if vecs.dtype == jnp.int16 else \
                jax.lax.bitcast_convert_type(
                    vecs.astype(jnp.float16), jnp.int16)
            if self.split_stats is None:
                self.split_stats = self._put(jnp.zeros((2,), jnp.float32))
            self.split_stats, dirty = _f16_stats_fn(self.split_stats, bits)
            self._f16_dirty = dirty if self._f16_dirty is None \
                else self._f16_dirty + dirty
            self._f16_clean_host = None
            self._split_stats_host = None
            return
        elif self._has_split:
            v32 = vecs.astype(jnp.float32)
            hi, lo = split_f32_bf16(v32)
            self.db_hi = _append1_jit(self.db_hi, hi, offset)
            self.db_lo = _append1_jit(self.db_lo, lo, offset)
        else:
            return
        if self.split_stats is None:
            self.split_stats = self._put(jnp.zeros((2,), jnp.float32))
        self.split_stats = _split_stats_fn(self.split_stats, v32, hi, lo)
        self._split_stats_host = None  # new rows → refresh the mirror

    def split_stats_host(self) -> tuple:
        """Host copy of the exact (max‖v_lo‖, max‖v−hi−lo‖) statistics
        (one device_get per add batch, cached). (0.0, 0.0) proves the lo /
        residual planes are all-zero — integer-valued data — which lets the
        fused dispatch sweep the hi plane alone (pallas_fused hi_exact) with
        bit-identical results at half the sweep HBM traffic."""
        if self.split_stats is None:
            return (float("inf"), float("inf"))
        if self._split_stats_host is None:
            s = jax.device_get(self.split_stats)
            self._split_stats_host = (float(s[0]), float(s[1]))
        return self._split_stats_host

    def f16_clean(self) -> bool:
        """True when every stored f16 bit pattern is a normal or ±0 (exact
        encode-time counter, lazily mirrored to host): kernels then run the
        lean split_f16_bits_clean decode, bit-identically."""
        if self.storage is not StorageType.FLOAT16 or self._f16_dirty is None:
            return False
        if self._f16_clean_host is None:
            self._f16_clean_host = (
                float(jax.device_get(self._f16_dirty)) == 0.0)
        return self._f16_clean_host

    def pad_queries(self, q: jax.Array) -> jax.Array:
        """Pad (nq, d) fp32 queries to (nq, d_pad)."""
        if self.d_pad == self.d:
            return q
        return jnp.pad(q, ((0, 0), (0, self.d_pad - self.d)))

    # -- mutation -------------------------------------------------------------
    def add(self, x) -> None:
        """Append n fp32 vectors. Norms computed pre-quantization (fp32).

        Accepts numpy or jax arrays; device arrays (e.g. embeddings produced
        on the accelerator) stay on device — no host round trip."""
        if isinstance(x, jax.Array):
            if x.ndim != 2 or x.shape[1] != self.d:
                raise ValueError(
                    f"expected (n, {self.d}) array, got {x.shape}")
            self._add_device(x.astype(jnp.float32))
            return
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected (n, {self.d}) fp32 array, got {x.shape}")
        n = x.shape[0]
        if n == 0:
            return
        if self.ntotal + n > np.iinfo(np.int32).max:
            # int32 id ABI, like the reference (MetalIndexFlat.mm:323-326).
            # Shard across devices (ShardedIndexFlat) for larger totals.
            raise ValueError("index size would exceed 2^31-1 vectors (int32 ids)")
        if self.storage is StorageType.INT8 and not self._trained:
            self.train(x)  # auto-train on the first batch (documented)
        self._ensure_capacity(self.ntotal + n)
        with self._ctx():
            if (self.storage in (StorageType.FLOAT16, StorageType.BFLOAT16)
                    and x.size >= NATIVE_CONVERT_MIN_ELEMS
                    and native.available()):
                vecs, new_norms = self._convert_host(x)
            elif self.storage is StorageType.INT8:
                xd = self._put(x)
                if self.d_pad != self.d:
                    xd = jnp.pad(xd, ((0, 0), (0, self.d_pad - self.d)))
                vecs, new_norms, batch_qn, clip = _quantize_int8_fn(
                    xd, self.scales)
                self._bump_int_norm(batch_qn, clip, n * self.d)
            else:
                xd = self._put(x)
                # fp32, BEFORE quantization; computed for IP too — the fused
                # path's exactness certificate needs max‖v‖ (pallas_fused.
                # _sweep_eps), and IP scoring itself ignores them
                new_norms = _norms_f32(xd)
                if self.d_pad != self.d:
                    xd = jnp.pad(xd, ((0, 0), (0, self.d_pad - self.d)))
                vecs = xd.astype(self.dtype)  # RNE, on device (no-op for f32)
            self._append(vecs, new_norms)
        if self.storage is StorageType.FLOAT32 and self.pair_only:
            self._host_rows.append(np.array(x, copy=True))  # exact master
        self.ntotal += n

    def _bump_int_norm(self, batch_qn: jax.Array,
                       clipped: Optional[jax.Array] = None,
                       nelems: int = 0) -> None:
        """Running max ‖v_q‖ over stored int8 rows (certificate bound) +
        the clipped-element counter (observability, ADVICE r2)."""
        if self.int_norm_max is None:
            self.int_norm_max = batch_qn
        else:
            self.int_norm_max = jnp.maximum(self.int_norm_max, batch_qn)
        if clipped is not None:
            self._int8_elems += nelems
            self._int8_clipped = (clipped if self._int8_clipped is None
                                  else self._int8_clipped + clipped)

    @property
    def int8_clipped_fraction(self) -> float:
        """Fraction of stored int8 elements that clipped to ±127 — nonzero
        means later add() batches outgrew the frozen training range, so
        recall vs the ORIGINAL data degrades even though search stays
        certified-exact vs the decoded database (ADVICE r2). Reads the lazy
        device counter (one transfer)."""
        if not self._int8_elems or self._int8_clipped is None:
            return 0.0
        return float(jax.device_get(self._int8_clipped)) / self._int8_elems

    def _append(self, vecs: jax.Array, new_norms: jax.Array) -> None:
        """Append stored-dtype rows + norms at self.ntotal (pair-aware).
        f16 rows arriving as float16 values (io restore path) are
        bitcast to the int16 HBM representation."""
        if self.storage is StorageType.FLOAT16:
            if vecs.dtype != jnp.int16:
                vecs = jax.lax.bitcast_convert_type(
                    vecs.astype(jnp.float16), jnp.int16)
            # flush f16 subnormals to ±0 at ingest (values < 2^-14 ≈ 6.1e-5;
            # accelerators may flush f32 denormals in on-device ops, so this
            # keeps storage consistent with the arithmetic) — the lean
            # clean-bits kernel decode then applies to ALL well-formed data,
            # not just data without near-zeros. Search exactness is always
            # w.r.t. the STORED database; norms are computed from fp32
            # pre-quantization either way (see add()).
            sub = ((vecs & jnp.int16(0x7C00)) == 0) \
                & ((vecs & jnp.int16(0x3FF)) != 0)
            vecs = jnp.where(sub, vecs & jnp.int16(-0x8000), vecs)
        self._update_split(vecs, self.ntotal)
        if self.pair_only:
            self.norms = _append_norms_jit(self.norms, new_norms, self.ntotal)
        else:
            self.db, self.norms = _append_jit(
                self.db, self.norms, vecs, new_norms, self.ntotal
            )

    def _add_device(self, xd: jax.Array) -> None:
        """Device-resident append (no host staging)."""
        n = xd.shape[0]
        if n == 0:
            return
        if self.ntotal + n > np.iinfo(np.int32).max:
            raise ValueError("index size would exceed 2^31-1 vectors (int32 ids)")
        if self.storage is StorageType.INT8 and not self._trained:
            self.train(np.asarray(jax.device_get(xd), np.float32))
        self._ensure_capacity(self.ntotal + n)
        with self._ctx():
            xd = self._put(xd)
            if self.storage is StorageType.INT8:
                if self.d_pad != self.d:
                    xd = jnp.pad(xd, ((0, 0), (0, self.d_pad - self.d)))
                vecs, new_norms, batch_qn, clip = _quantize_int8_fn(
                    xd, self.scales)
                self._bump_int_norm(batch_qn, clip, n * self.d)
            else:
                new_norms = _norms_f32(xd)  # all metrics — see add()
                if self.d_pad != self.d:
                    xd = jnp.pad(xd, ((0, 0), (0, self.d_pad - self.d)))
                vecs = xd.astype(self.dtype)
            self._append(vecs, new_norms)
        if self.storage is StorageType.FLOAT32 and self.pair_only:
            # the exact master lives on host: one transfer (documented cost
            # of keep_master=False for device-resident adds)
            self._host_rows.append(
                np.asarray(jax.device_get(xd[:, : self.d]), np.float32))
        self.ntotal += n

    def _convert_host(self, x: np.ndarray):
        """Threaded host RNE conversion + fp32 norms (native C++ path):
        device_put moves 2 bytes/element instead of 4."""
        norms = native.l2_norms(x)  # all metrics — see add()
        if self.d_pad != self.d:
            xp = np.zeros((x.shape[0], self.d_pad), np.float32)
            xp[:, : self.d] = x
            x = xp
        if self.storage is StorageType.BFLOAT16:
            import ml_dtypes

            bits = native.f32_to_bf16(x)
            host = bits.view(ml_dtypes.bfloat16)
        else:
            host = native.f32_to_f16(x)
        return self._put(jnp.asarray(host)), self._put(jnp.asarray(norms))

    def reset(self) -> None:
        """Drop all vectors and release device memory (≈ MetalIndexFlat::reset,
        src/MetalIndexFlat.mm:492-506)."""
        self.db = None
        self.norms = None
        self.db_hi = None
        self.db_lo = None
        self._host_rows = []
        self.split_stats = None
        self._split_stats_host = None
        self._f16_dirty = None
        self._f16_clean_host = None
        self.int_norm_max = None
        self._int8_clipped = None
        self._int8_elems = 0
        # int8 scales survive reset (faiss: is_trained persists)
        self.ntotal = 0
        self.capacity = 0

    def merge_storage(self, other: "DeviceStore") -> None:
        """Append ``other``'s stored rows to self BIT-EXACTLY (the device
        half of faiss::IndexFlat::merge_from): raw storage planes, the
        PRE-quantization fp32 norms, and the certificate statistics all
        transfer. (A reconstruct + re-add merge would silently re-derive
        norms from the DECODED vectors, changing reported distances for
        reduced-precision storage — storage.py:9-12.) Stats union exactly:
        split_stats / int_norm_max are running maxima, the f16 dirty and
        int8 clip counters are sums. Layouts must match (same storage dtype
        and pair_only); int8 additionally requires the same frozen scale
        grid (an empty untrained self adopts other's)."""
        if other is self:
            raise ValueError("cannot merge a store into itself")
        if (other.storage is not self.storage
                or other.d != self.d
                or other.pair_only != self.pair_only):
            raise ValueError("merge: storage layouts differ")
        if self.storage is StorageType.INT8 and other._trained:
            if not self._trained and self.ntotal == 0:
                self.scales = self._put(other.scales)  # adopt the grid
                self._trained = True
            elif not np.array_equal(jax.device_get(self.scales),
                                    jax.device_get(other.scales)):
                raise ValueError(
                    "merge: int8 indexes must share the trained scale grid "
                    "(requantization would not be exact)")
        n = other.ntotal
        if n == 0:
            return
        if self.ntotal + n > np.iinfo(np.int32).max:
            raise ValueError("index size would exceed 2^31-1 vectors")
        self._ensure_capacity(self.ntotal + n)
        off = self.ntotal
        with self._ctx():
            if self.db is not None:
                self.db = _append1_jit(self.db, self._put(other.db[:n]), off)
            self.norms = _append_norms_jit(
                self.norms, self._put(other.norms[:n]), off)
            if self._has_split:
                self.db_hi = _append1_jit(
                    self.db_hi, self._put(other.db_hi[:n]), off)
                self.db_lo = _append1_jit(
                    self.db_lo, self._put(other.db_lo[:n]), off)
            if other.split_stats is not None:
                os_ = self._put(other.split_stats)
                self.split_stats = (os_ if self.split_stats is None
                                    else jnp.maximum(self.split_stats, os_))
                self._split_stats_host = None
            if other._f16_dirty is not None:
                od = self._put(other._f16_dirty)
                self._f16_dirty = (od if self._f16_dirty is None
                                   else self._f16_dirty + od)
                self._f16_clean_host = None
            if other.int_norm_max is not None:
                om = self._put(other.int_norm_max)
                self.int_norm_max = (om if self.int_norm_max is None
                                     else jnp.maximum(self.int_norm_max, om))
            if other._int8_clipped is not None:
                oc = self._put(other._int8_clipped)
                self._int8_clipped = (oc if self._int8_clipped is None
                                      else self._int8_clipped + oc)
                self._int8_elems += other._int8_elems
        if self.pair_only:
            self._host_rows.append(
                np.array(other._master_rows(0, n), copy=True))
        self.ntotal += n

    def remove_rows(self, keep: np.ndarray) -> None:
        """Compact storage to the surviving local rows ``keep`` (sorted
        ascending, unique), preserving their order — the device half of faiss
        remove_ids' stable renumbering (the reference never implements
        removal: its faiss::Index base throws). One jitted, donated gather
        per stored array; capacity is kept so shape-keyed compiled search
        programs stay cached.

        Certificate statistics are intentionally left unchanged: removal can
        only shrink the true maxima behind split_stats, the f16 dirty
        counter, int_norm_max, and the int8 clip counter, so the stored
        values remain SOUND (at worst marginally conservative) upper bounds
        for the exactness certificate."""
        keep = np.asarray(keep, np.int32)
        n_new = int(keep.size)
        if n_new == self.ntotal:
            return
        assert n_new < self.ntotal
        if n_new == 0:
            self.reset()  # preserves int8 scales / is_trained
            return
        # capacity-length gather index: survivors first, then out-of-range
        # sentinels that _compact_fn fills with zeros
        idx = np.full((self.capacity,), self.capacity, np.int32)
        idx[:n_new] = keep
        with self._ctx():
            idxd = self._put(jnp.asarray(idx))
            if self.db is not None:
                self.db = _compact_jit(self.db, idxd)
            self.norms = _compact_jit(self.norms, idxd)
            if self._has_split:
                self.db_hi = _compact_jit(self.db_hi, idxd)
                self.db_lo = _compact_jit(self.db_lo, idxd)
        if self.pair_only and self._host_rows:
            if len(self._host_rows) > 1:
                self._host_rows = [np.concatenate(self._host_rows)]
            self._host_rows = [self._host_rows[0][keep]]
        self.ntotal = n_new

    # -- access ---------------------------------------------------------------
    def _master_rows(self, i0: int, n: int) -> np.ndarray:
        """(n, d) fp32 decode of rows [i0, i0+n) for any storage mode."""
        if self.storage is StorageType.FLOAT32 and self.pair_only:
            if len(self._host_rows) > 1:  # consolidate lazily
                self._host_rows = [np.concatenate(self._host_rows)]
            return self._host_rows[0][i0 : i0 + n]
        if self.db is not None:
            if self.storage is StorageType.INT8:
                rows = jax.device_get(
                    self.db[i0 : i0 + n, : self.d].astype(jnp.float32)
                    * self.scales[None, : self.d])
                return np.asarray(rows, dtype=np.float32)
            if self.storage is StorageType.FLOAT16:
                # db holds the f16 BIT PATTERNS: reinterpret on host (exact)
                bits = np.asarray(jax.device_get(
                    self.db[i0 : i0 + n, : self.d]))
                return bits.view(np.float16).astype(np.float32)
            rows = jax.device_get(
                self.db[i0 : i0 + n, : self.d].astype(jnp.float32))
            return np.asarray(rows, dtype=np.float32)
        raise RuntimeError("no master representation for this storage mode")

    def reconstruct(self, key: int) -> np.ndarray:
        """Fetch one stored vector, decoded to fp32 (≈ mm:508-527)."""
        if not (0 <= key < self.ntotal):
            raise IndexError(f"key {key} out of range [0, {self.ntotal})")
        return self._master_rows(key, 1)[0]

    def reconstruct_n(self, i0: int, n: int) -> np.ndarray:
        if not (0 <= i0 and i0 + n <= self.ntotal):
            raise IndexError(f"range [{i0}, {i0 + n}) out of [0, {self.ntotal})")
        return self._master_rows(i0, n)

    def reconstruct_batch(self, keys) -> np.ndarray:
        """(len(keys), d) fp32 decode of ARBITRARY stored ids: one device
        gather + one transfer (search_and_reconstruct's old per-element host
        loop was hostile at large k). Same bits as reconstruct() per key."""
        keys = np.asarray(keys, np.int64).ravel()
        if keys.size == 0:
            return np.zeros((0, self.d), np.float32)
        if keys.min() < 0 or keys.max() >= self.ntotal:
            raise IndexError(
                f"reconstruct_batch: ids outside [0, {self.ntotal})")
        if self.storage is StorageType.FLOAT32 and self.pair_only:
            if len(self._host_rows) > 1:  # consolidate lazily
                self._host_rows = [np.concatenate(self._host_rows)]
            return np.ascontiguousarray(self._host_rows[0][keys])
        with self._ctx():
            idx = self._put(jnp.asarray(keys.astype(np.int32)))
            rows = np.asarray(jax.device_get(
                jnp.take(self.db, idx, axis=0)[:, : self.d]))
        if self.storage is StorageType.INT8:
            sc = np.asarray(jax.device_get(self.scales))[: self.d]
            return rows.astype(np.float32) * sc[None, :]
        if self.storage is StorageType.FLOAT16:
            return rows.view(np.float16).astype(np.float32)
        return rows.astype(np.float32, copy=False)

    def vectors_numpy(self) -> Optional[np.ndarray]:
        """fp32 storage only: the raw vectors (≈ getVectorsData, which returns
        nullptr for reduced precision — MetalIndexFlat.h:96-98)."""
        if self.storage is not StorageType.FLOAT32:
            return None
        if self.ntotal == 0:
            return np.zeros((0, self.d), np.float32)
        return self._master_rows(0, self.ntotal)

    def hbm_bytes(self) -> int:
        """Device-resident bytes (SURVEY §5.5 observability; VERDICT r1:
        describe() must report the pair overhead)."""
        total = 0
        for a in (self.db, self.norms, self.db_hi, self.db_lo):
            if a is not None:
                total += a.size * a.dtype.itemsize
        return total
