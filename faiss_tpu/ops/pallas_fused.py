"""Fused group-max sweep: distance GEMM + group-max epilogue, no nq×nv.

The north-star kernel (SURVEY.md §7 / BASELINE.json): the equivalent of
the reference's fully fused ``fused_l2_topk`` shader
(shaders/fused_l2_topk.metal:19-131) and of its fused-epilogue GEMMs
(``simdgroup_gemm_l2_fused*``, simdgroup_gemm.metal:143-253) — the score
matrix is never written to device memory, so a database sweep costs one
read of the db tiles instead of read + 8·nq·nv bytes of score traffic.

Exact selection via *grouped* top-k (ops/grouped refactor of MetalSelect):

  phase 1 (this kernel)  per contiguous id-group of G columns, emit
                         max score; L2 uses s' = 2·q·v − ‖v‖² (the per-row
                         −‖q‖² term is rank-invariant and re-added outside)
  phase 2 (XLA)          top-(k+pad) groups per query from the (nq, nv/G)
                         group-max array — all true top-k elements provably
                         live in the top-k groups (a group's max bounds every
                         member, so k better group-maxes ⇒ k better elements)
  phase 3 (XLA)          gather those groups' db rows, rescore fp32-true,
                         exact top-k over ≤ (k+pad)·G candidates per query

EXACTNESS IS CERTIFIED, NOT ASSUMED. The sweep's nomination arithmetic
differs from the rescore by a bounded amount (bf16 operand splits; fp32
accumulation order), so ``fused_search`` also returns a per-query
certificate: ``k-th rescored score ≥ (max group-max among NON-nominated
groups) + ε`` where ε is a rigorous upper bound on |sweep − true| + |rescore
− true| (derived below from the split residual norms). When the certificate
holds, no true top-k element can hide in an un-nominated group and the
result is provably the exact (quantized-db) top-k, ties resolved to lowest
id. When it fails (near-ties at the nomination boundary — e.g. duplicated
vectors), the caller falls back to the plain XLA path, which is exact by
construction. GROUP_PAD extra groups keep the failure rate at measured-zero
on non-adversarial data.

Sweep arithmetic (all storage types nominate with fp32-grade precision):
  * bf16 storage: two bf16 tensor-core passes q_hi·v + q_lo·v over the
    exact-bf16 query pair — only the query's double-truncation residual
    (≲2^-16‖q‖) is dropped.
  * fp32/f16 storage: three bf16 passes over bit-mask (hi, lo) splits of
    BOTH operands (storage.split_f32_bf16) — drops only lo_q·lo_v
    (≲2^-14‖q‖‖v‖). f16 rows are stored as 2 B/elem bit patterns and
    decoded to the exact pair inside the kernel.
  * int8 storage: two exact int8×int8→int32 passes over a residual
    expansion of the query.

The sweep is ONE Pallas kernel on the Triton route (``_sweep_kernel``):
independent programs over (query block, database block), a loop over d
inside each program, one body for every storage. ``_sweep_xla`` is the
plain XLA form of the same arithmetic (dot → reshape-max): the reference
the kernel is tested against, and the A/B baseline it is timed against.

Related work: this is an EXACT member of the two-stage top-k family
("A Faster Generalized Two-Stage Approximate Top-K", arXiv 2506.04165) —
exactness comes from the group-max bound, the full gather/rescore of the
nominated groups, and the runtime certificate.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..dtypes import MetricType
from . import topk as topk_ops

GROUP = 128           # columns per candidate group
GROUP_PAD = 4         # extra groups gathered beyond k (certificate margin)
NEG_INF = float("-inf")

# fused-path eligibility (dispatch heuristics, named like the reference's
# MetalDistance.mm:344-353 gate constants), fitted to index-level
# fused/plain pairs on an H100 (PERF.md): at 32K rows the two paths trade
# places within the per-call host overhead, from 128K rows on the fused
# path wins; the threshold sits between the two measured sizes.
FUSED_MIN_NV = 65536
# Reduced sweep (sweep_passes=1, RNE-rounded queries: bf16 2→1 passes) at
# nq_pad ≥ this: on an H100 at 10M×128 it was 4% faster end to end at
# nq=32 and 21% at nq=128, certifying every query; at nq=8 the sweep is
# memory-bound and both take the same time. Exactness of the reduced sweep
# is covered by the runtime certificate + the two-tier fallback
# (exact-pair fused, then plain) in index.py/sharded.py. Pair storage
# (fp32/f16) always runs the exact split.
REDUCED_SWEEP_MIN_NQ = 32


def pick_sweep_passes(nq_pad: int, pair_storage: bool = False) -> int:
    """Dispatch: 1 (reduced, certified) for large-nq bf16 sweeps, else the
    exact pair (2). Pair storage (fp32/f16) never reduces."""
    return 1 if (nq_pad >= REDUCED_SWEEP_MIN_NQ and not pair_storage) else 2


FUSED_GATHER_BUDGET = 1 << 30    # hard cap on phase-3 gather materialization
# Cost model, in bytes of device-memory traffic: plain writes and re-reads
# the nq×nv fp32 score matrix (8 B/score) and its top_k grows with k (k/16
# B/score); fused pays the candidate gather, weighted by how much cheaper a
# gathered byte proved than a plain-path score byte on the H100 (the
# weight that separates every measured fused/plain pair above
# FUSED_MIN_NV — PERF.md).
PLAIN_SCORE_BYTES = 8.0
PLAIN_TOPK_BYTES_PER_K16 = 1.0
FUSED_GATHER_WEIGHT = 0.15

# Certificate error-bound constants (derivation in _sweep_eps):
# bit-mask truncation to bf16 (8 significand bits) loses < 2^-7 relative;
# the RNE-rounded lo term's own residual is < 2^-15 relative.
_LO_REL = 2.0 ** -7
_RESID_REL = 2.0 ** -15
_U32 = 2.0 ** -24      # f32 unit roundoff (RNE)
# max ‖v_stored‖ / ‖v_original‖ for RNE-quantized storage (bf16: each
# element grows ≤ 2^-9 relative under RNE, f16/int8-decode even less);
# stored norms are PRE-quantization, so error terms that multiply by the
# stored vector's norm carry this envelope. Harmless slack for fp32.
_QUANT_V = 1.0 + 2.0 ** -8
# Strictness + computation slack: the certificate comparison must be
# STRICT against the true error bound B (a non-nominated row tied exactly
# at the k-th score must still be excludable — see _sweep_eps notes), and
# eps itself is computed in f32 (~20 ops, each ≤ 2^-24 relative, plus the
# norm inputs' own ≤(d+2)·2^-24 downward rounding ≤ 2^-17). 2^-10 dominates
# every such term plus all second-order u·E cross terms by >100×.
_EPS_SLACK = 1.0 + 2.0 ** -10

# Sweep kernel tiles. A program owns one (block_q, SWEEP_GROUPS·GROUP)
# tile of the score plane and writes its (block_q, SWEEP_GROUPS) group-max
# slice; nothing carries between programs. d is walked in SWEEP_BD-wide
# steps inside the program. Groups, stages and warps come from a tile sweep
# at 10M×128 bf16 on an H100 (PERF.md).
SWEEP_GROUPS = 16
SWEEP_BD = 128
SWEEP_BQ_MIN = 16      # the tensor cores' smallest row tile
SWEEP_BQ_MAX = 128
SWEEP_STAGES = 3       # software-pipeline depth of the tile loads, at most
SWEEP_WARPS = 4
# shared memory a block may use (232,448 B on Hopper) less room for the
# compiler's own layout-conversion scratch
SWEEP_SHARED_BYTES = 232448 - 16384


def _sweep_stages(block_q: int, bd: int, nd: int, q_bytes: int,
                  db_bytes: int) -> int:
    """Pipeline depth that fits shared memory: every stage holds one db
    tile per plane (and, when d is walked in several steps, the query
    tiles too); a single d step keeps the query tiles outside the loop."""
    q_tile = block_q * bd * q_bytes
    db_tile = GROUP * bd * db_bytes
    fixed, per_stage = (q_tile, db_tile) if nd == 1 else (0, q_tile + db_tile)
    fit = (SWEEP_SHARED_BYTES - fixed) // per_stage
    return max(1, min(SWEEP_STAGES, fit))


_DN = (((1,), (1,)), ((), ()))  # contract d: (nq, d) × (rows, d) → (nq, rows)
_DEFAULT = jax.lax.Precision.DEFAULT  # bf16/int8 products are exact


def _sweep_block_q(nq_pad: int) -> int:
    """Query rows per sweep program: a power of two in [16, 128]."""
    return min(SWEEP_BQ_MAX, max(SWEEP_BQ_MIN, 1 << (nq_pad - 1).bit_length()))


def _sweep_block_d(d_pad: int) -> int:
    """d step: SWEEP_BD, or the whole of a smaller power-of-two d_pad
    (the index layer pads d to 128; direct callers may pass 32 or 64)."""
    if d_pad % SWEEP_BD == 0:
        return SWEEP_BD
    if d_pad >= 16 and d_pad & (d_pad - 1) == 0:
        return d_pad
    raise ValueError(f"sweep needs d_pad a multiple of {SWEEP_BD} or a "
                     f"power of two ≥ 16, got {d_pad}")


def _decode_planes(planes, f16: str):
    """db tile planes → the bf16/int8 operands the products read. int16
    f16 bit patterns decode to the exact (hi, lo) bf16 pair
    (storage.split_f16_bits[_clean]); every other storage is read as is."""
    if not f16:
        return list(planes)
    from ..storage import split_f16_bits, split_f16_bits_clean

    split = split_f16_bits_clean if f16 == "clean" else split_f16_bits
    return list(split(planes[0]))


def _sweep_operands(queries_f32, db, db_split, *, sweep_passes, scales,
                    f16_clean):
    """The one description of the sweep arithmetic both forms share:
    (query planes, db planes, products, f16 decode mode, int8 betas).
    ``products`` lists (query plane, db plane) pairs; each pass is an
    exact-product bf16 (or int8) dot accumulated in f32 (int32)."""
    from ..storage import split_f32_bf16

    if db.dtype == jnp.int8:
        assert scales is not None, "int8 sweep needs quantization scales"
        q1, q2, b1, b2 = _int8_query_pair(queries_f32, scales)
        return [q1, q2], [db], [(0, 0), (1, 0)], "", (b1, b2)
    if db.dtype == jnp.int16:
        planes, f16 = [db], ("clean" if f16_clean else "raw")
    elif db_split is not None or db.dtype != jnp.bfloat16:
        if db_split is None:
            # direct callers without precomputed splits (tests): derive here
            # (f16→f32 decode is exact, so the pair reproduces stored values)
            db_split = split_f32_bf16(db.astype(jnp.float32))
        planes, f16 = list(db_split), ""
    else:
        planes, f16 = [db], ""
    pair = len(planes) == 2 or f16
    if sweep_passes == 1:
        qs = [queries_f32.astype(jnp.bfloat16)]  # RNE: half the trunc error
        products = [(0, 0), (0, 1)] if pair else [(0, 0)]
    else:
        qs = list(split_f32_bf16(queries_f32))
        products = [(0, 0), (0, 1), (1, 0)] if pair else [(0, 0), (1, 0)]
    return qs, planes, products, f16, None


def _epilogue_scores(dots, vn, metric):
    """s = 2·dots − vn (L2) / dots − vn (IP, vn is 0 / +inf)."""
    return (2.0 * dots if metric is MetricType.L2 else dots) - vn


def _sweep_kernel(*refs, n_q, n_db, products, f16, int8, metric, block_q,
                  bd, nd, ngroups):
    """One program: rows [i·block_q, +block_q) × groups [j·G, +G).

    Walks its groups (fewer on the ragged last program) and, per group,
    d in SWEEP_BD steps; each step accumulates the storage's exact-product
    passes on the tensor cores. The group's 128 scores reduce to one max
    per query row, collected into a (block_q, G) register tile that is
    stored once. Pre-masked norms (``vn`` +inf past ntotal / on filtered
    rows) make masked columns −inf with no per-tile compare."""
    q_refs = refs[:n_q]
    db_refs = refs[n_q:n_q + n_db]
    vn_ref = refs[n_q + n_db]
    beta_refs = refs[n_q + n_db + 1:-1]
    out_ref = refs[-1]
    i, j = pl.program_id(0), pl.program_id(1)
    q_rows = pl.ds(i * block_q, block_q)
    g0 = j * SWEEP_GROUPS
    n_acc = n_q if int8 else 1
    acc_t = jnp.int32 if int8 else jnp.float32

    def load_q(t):
        cols = pl.ds(t * bd, bd)
        return [r[q_rows, cols] for r in q_refs]

    q_once = load_q(0) if nd == 1 else None

    def group(g, gm):
        rows = pl.ds((g0 + g) * GROUP, GROUP)

        def d_step(t, accs):
            qs = q_once if q_once is not None else load_q(t)
            cols = pl.ds(t * bd, bd)
            vs = _decode_planes([r[rows, cols] for r in db_refs], f16)
            accs = list(accs)
            for qi, vi in products:
                a = qi if int8 else 0
                accs[a] = accs[a] + pl.dot(qs[qi], vs[vi], trans_b=True,
                                           precision=_DEFAULT)
            return tuple(accs)

        zero = tuple(jnp.zeros((block_q, GROUP), acc_t) for _ in range(n_acc))
        accs = d_step(0, zero) if nd == 1 else jax.lax.fori_loop(
            0, nd, d_step, zero)
        if int8:
            dots = (accs[0].astype(jnp.float32) * beta_refs[0][q_rows][:, None]
                    + accs[1].astype(jnp.float32)
                    * beta_refs[1][q_rows][:, None])
        else:
            dots = accs[0]
        s = _epilogue_scores(dots, vn_ref[rows][None, :], metric)
        m = jnp.max(s, axis=1)
        col = jax.lax.broadcasted_iota(jnp.int32, (block_q, SWEEP_GROUPS), 1)
        return jnp.where(col == g, m[:, None], gm)

    n_valid = jnp.minimum(SWEEP_GROUPS, ngroups - g0)
    gm = jax.lax.fori_loop(
        0, n_valid, group,
        jnp.full((block_q, SWEEP_GROUPS), NEG_INF, jnp.float32))
    out_ref[q_rows, pl.ds(g0, SWEEP_GROUPS)] = gm


def _sweep_pallas(qs, planes, products, f16, betas, vn, *, metric, nv_eff,
                  interpret):
    """Launch _sweep_kernel over the first nv_eff rows of the WHOLE db
    planes (slicing would copy the database). Queries pad to a block_q
    multiple and the output to whole programs; both pads are sliced off."""
    nq_pad, d_pad = qs[0].shape
    bd = _sweep_block_d(d_pad)
    block_q = _sweep_block_q(nq_pad)
    nqb = pl.cdiv(nq_pad, block_q)
    ngroups = nv_eff // GROUP
    nprog = pl.cdiv(ngroups, SWEEP_GROUPS)
    pad = nqb * block_q - nq_pad
    if pad:
        qs = [jnp.pad(q, ((0, pad), (0, 0))) for q in qs]
        if betas is not None:
            betas = tuple(jnp.pad(b, (0, pad)) for b in betas)
    kernel = functools.partial(
        _sweep_kernel, n_q=len(qs), n_db=len(planes),
        products=tuple(products), f16=f16, int8=betas is not None,
        metric=metric, block_q=block_q, bd=bd, nd=d_pad // bd,
        ngroups=ngroups)
    itemsize = sum(p.dtype.itemsize for p in planes)
    stages = _sweep_stages(block_q, bd, d_pad // bd,
                           sum(q.dtype.itemsize for q in qs), itemsize)
    out = pl.pallas_call(
        kernel,
        grid=(nqb, nprog),
        out_shape=jax.ShapeDtypeStruct(
            (nqb * block_q, nprog * SWEEP_GROUPS), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=SWEEP_WARPS, num_stages=stages),
        interpret=interpret,
        name="groupmax_sweep",
        cost_estimate=pl.CostEstimate(
            flops=2 * nq_pad * nv_eff * d_pad * len(products),
            bytes_accessed=nqb * nv_eff * d_pad * itemsize
            + nq_pad * ngroups * 4,
            transcendentals=0),
    )(*qs, *planes, vn, *(betas or ()))
    return out[:nq_pad, :ngroups]


def _sweep_xla(qs, planes, products, f16, betas, vn, *, metric, nv_eff):
    """The plain XLA form of the sweep: the same passes as whole-range dots
    (materializing the (nq, nv_eff) score plane), then reshape-max."""
    planes = _decode_planes(
        [jax.lax.slice_in_dim(p, 0, nv_eff, axis=0) for p in planes], f16)
    if betas is not None:
        acc = [jax.lax.dot_general(qs[qi], planes[vi], _DN, precision=_DEFAULT,
                                   preferred_element_type=jnp.int32)
               for qi, vi in products]
        dots = (betas[0][:, None] * acc[0].astype(jnp.float32)
                + betas[1][:, None] * acc[1].astype(jnp.float32))
    else:
        dots = None
        for qi, vi in products:
            p = jax.lax.dot_general(qs[qi], planes[vi], _DN, precision=_DEFAULT,
                                    preferred_element_type=jnp.float32)
            dots = p if dots is None else dots + p
    s = _epilogue_scores(dots, vn[None, :], metric)
    return s.reshape(s.shape[0], -1, GROUP).max(axis=-1)


@functools.partial(
    jax.jit,
    static_argnames=("metric", "nv_eff", "interpret", "sweep_passes",
                     "f16_clean", "xla_sweep"),
)
def groupmax_scores(
    queries_f32: jax.Array,    # (nq_pad, d_pad) fp32
    db: jax.Array,             # (capacity, d_pad) storage dtype
    db_norms: jax.Array,       # (capacity,) f32 (‖v‖², all metrics)
    ntotal: jax.Array,         # () or (1,) int32
    db_split=None,             # fp32/f16 storage: (db_hi, db_lo) bf16 pair
    *,
    metric: MetricType,
    nv_eff: int,
    interpret: bool = False,
    sweep_passes: int = 2,
    scales=None,               # int8 storage: (d_pad,) per-dim quant scales
    f16_clean: bool = False,   # int16 db: clean bits → lean in-kernel decode
    sel=None,                  # (capacity,) bool selector stream, or None
    xla_sweep: bool = False,   # plain XLA form instead of the kernel
) -> jax.Array:
    """(nq_pad, nv_eff/GROUP) per-group max of masked nomination scores.

    ``sel`` (selector.SearchParams stream): excluded rows fold into the SAME
    pre-masked norm stream as padding (+inf norm → −inf score), so filtered
    search rides the fused sweep unchanged.

    ``sweep_passes=1``: REDUCED sweep — RNE-rounded queries instead of the
    exact (hi, lo) query pair, cutting one pass everywhere (bf16: 2→1
    passes; fp32/f16 pair: 3→2). Nomination coarsens to ~2^-9 relative,
    still certified by _sweep_eps(single_pass=True); integer-valued data
    ≤256 (e.g. SIFT descriptors) rounds exactly, so nothing is lost.

    int8 storage (``db.dtype == int8``, ``scales`` required): two exact
    int8×int8 passes over the per-query residual expansion of q∘s;
    certified by _sweep_eps_int8."""
    nq_pad, d_pad = queries_f32.shape
    assert nv_eff % GROUP == 0, nv_eff
    qs, planes, products, f16, betas = _sweep_operands(
        queries_f32, db, db_split, sweep_passes=sweep_passes, scales=scales,
        f16_clean=f16_clean)
    vn = _premask_norms(db_norms, ntotal, nv_eff, metric, sel)
    if xla_sweep:
        return _sweep_xla(qs, planes, products, f16, betas, vn,
                          metric=metric, nv_eff=nv_eff)
    return _sweep_pallas(qs, planes, products, f16, betas, vn, metric=metric,
                         nv_eff=nv_eff, interpret=interpret)


def _top_groups(
    gmax: jax.Array, kg: int, ngroups: int
) -> Tuple[jax.Array, jax.Array]:
    """(top-kg group ids, max gmax among NON-nominated groups) per query row.

    The second output is the certificate threshold t: any element of an
    un-nominated group scores ≤ t (+sweep error). −inf when every group is
    nominated. One flat lax.top_k over the groups (a two-level variant over
    8-group blocks measured no faster at 78K groups on an H100 — PERF.md)."""
    nq = gmax.shape[0]
    _, gidx = jax.lax.top_k(gmax, kg)
    if kg >= ngroups:
        return gidx, jnp.full((nq,), NEG_INF, jnp.float32)
    # threshold = max over NON-nominated groups: scatter −inf at the
    # nominated columns and row-max
    masked = jnp.put_along_axis(gmax, gidx, NEG_INF, axis=-1, inplace=False)
    return gidx, jnp.max(masked, axis=-1)


def _premask_norms(db_norms, ntotal, nv_eff, metric, sel=None):
    """(nv_eff,) pre-masked norm stream: the raw ‖v‖² (L2) / 0.0 (IP) on
    valid rows, +inf past ``ntotal`` AND on selector-excluded rows — the ONE
    mechanism the sweep uses to mask, so filtered rows score −inf exactly
    like padding."""
    nt = jnp.asarray(ntotal, jnp.int32).reshape(())
    col = jax.lax.iota(jnp.int32, nv_eff)
    vn_raw = jax.lax.slice_in_dim(db_norms, 0, nv_eff, axis=0)
    ok = col < nt
    if sel is not None:
        ok = ok & jax.lax.slice_in_dim(sel, 0, nv_eff, axis=0)
    if metric is MetricType.L2:
        return jnp.where(ok, vn_raw, jnp.inf)
    return jnp.where(ok, 0.0, jnp.inf)


def _gather_groups(arr: jax.Array, gidx: jax.Array) -> jax.Array:
    """(nq, kg) group ids → (nq, kg·GROUP, …) rows: one contiguous
    GROUP-row slice per take index on the group-major view of the WHOLE
    buffer (a reshape is metadata-only; a slice would copy the database)."""
    nq, kg = gidx.shape
    tail = arr.shape[1:]
    g = arr.reshape((arr.shape[0] // GROUP, GROUP) + tail)
    rows = jnp.take(g, gidx.reshape(-1), axis=0)
    return rows.reshape((nq, kg * GROUP) + tail)


def rescore_groups(
    queries_f32: jax.Array,   # (nq_pad, d_pad) fp32
    db: jax.Array,            # (capacity, d_pad) storage dtype
    db_norms: jax.Array,      # (capacity,) f32
    gidx: jax.Array,          # (nq_pad, kg) int32
    *,
    metric: MetricType,
    db_lo=None,               # pair-only storage: `db` is hi, this is lo
    f16_clean: bool = False,
) -> jax.Array:
    """(nq_pad, kg·GROUP) fp32-true scores of each query's candidate groups
    (phase 3): XLA take of the groups' contiguous row slices and one
    batched dot, in the plain path's arithmetic class per storage —
    bf16 rows (and int8 codes, which widen to bf16 exactly) against the
    exact 3-way bf16 split of the query, stacked so the rows are read once
    (every product exact in f32); f32 masters, f16 bit patterns (decoded
    exactly) and pairs (hi + lo reconstructs exactly) at HIGHEST. int8
    callers pass q∘s as the query, matching the decoded norms they store.
    Unmasked: the caller masks padding / filtered rows."""
    from ..storage import decode_f16_bits, split3_f32_bf16

    rows = _gather_groups(db, gidx)
    if db.dtype in (jnp.bfloat16, jnp.int8) and db_lo is None:
        q3 = jnp.stack(split3_f32_bf16(queries_f32), axis=1)  # (nq, 3, d)
        dots = jnp.sum(jax.lax.dot_general(
            q3, rows.astype(jnp.bfloat16), (((2,), (2,)), ((0,), (0,))),
            precision=_DEFAULT, preferred_element_type=jnp.float32), axis=1)
    else:
        if db.dtype == jnp.int16:
            rows = decode_f16_bits(rows)
        else:
            rows = rows.astype(jnp.float32)
        if db_lo is not None:
            rows = rows + _gather_groups(db_lo, gidx).astype(jnp.float32)
        dots = jax.lax.dot_general(
            queries_f32, rows, (((1,), (2,)), ((0,), (0,))),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)
    if metric is MetricType.L2:
        return 2.0 * dots - _gather_groups(db_norms, gidx)
    return dots


def _sweep_eps(queries_f32: jax.Array, db_norms: jax.Array, nv_eff: int,
               *, metric: MetricType, pair_sweep: bool, d_pad: int,
               single_pass: bool = False, split_stats=None):
    """Per-query rigorous upper bound ε on |nomination score − rescored
    score| for ANY stored row (module docstring "EXACTNESS IS CERTIFIED").

    Soundness statement. Let s_resc(x) be the score phase 3 would assign row
    x and s_swp(x) the sweep's nomination score (both computed f32 values).
    This function returns ε with ε > |s_resc(x) − s_swp(x)| STRICTLY, for
    every stored x. Then for any row x of a non-nominated group,
    s_resc(x) < s_swp(x) + ε ≤ t + ε, and the comparison
    ``vals[k-1] ≥ fl(t + ε)`` (whose own rounding is budgeted below)
    proves no non-nominated row can displace — or even TIE, thanks to
    strictness — any of the returned top-k.

    Notation: u = 2^-24 (f32 unit roundoff); Q = ‖q‖; R = ‖q − Σq_parts‖
    (the query residual the sweep drops, COMPUTED EXACTLY: the bit-mask
    split makes q − q_hi and (q − q_hi) − q_lo exact f32 subtractions);
    L = ‖q_lo‖; V = max‖v_stored‖ ≤ √(max norms)·(1+2^-8) (stored norms are
    pre-quantization; RNE bf16/f16 quantization grows each element ≤ 2^-9
    relative); N = max ‖v‖² (the stored f32 norm actually subtracted);
    s0 ≥ max‖v_lo‖ and s1 ≥ max‖v − v_hi − v_lo‖ (EXACT running statistics
    over stored rows, storage._split_stats_fn; generic envelopes
    s0 ≤ 2^-7·V, s1 ≤ 2^-15·V when stats are absent — wildly loose on
    integer data, where the true stats are 0).

    Error budget (every term an upper bound valid for ANY summation order,
    since k f32 additions of terms t_i err ≤ (k−1)·u·Σ|t_i| regardless of
    association, and bf16×bf16 / int8×int8 products are EXACT in f32/int32):

      (1) dropped split terms (sweep targets a subset of the exact product
          expansion q·v = Σ_parts):
            R·V                      (q-residual · v   — all variants)
            + L·s0 + (Q+R)·s1        (pair sweeps: dropped q_lo·v_lo and
                                      (q−resid)·v_residual)
      (2) sweep accumulation: ≤ (d+2)·u·[(Q+R)·(V+s0) + L·V]
          (each pass p=a·b errs ≤ d·u·‖a‖‖b‖; pass operand norms are
          bounded by Q+R / L on the query side and V / s0 on the v side;
          +2 covers the f32 adds combining ≤3 passes)
      (3) rescore accumulation: ≤ 2·d·u·Q·V
          (the HIGHEST fp32 dot and the 3-pass exact bf16 split of the
          rescore both err ≤ ~1.1·d·u·Q·V; 2d·u is the envelope)
      (4) L2 epilogue + comparison rounding: scores are fl(2·dot − ‖v‖²)
          with bit-identical ‖v‖² on both sides; each side's subtraction
          rounds ≤ u·(2·Q·V + N), and fl(t+ε) in the certificate comparison
          rounds ≤ u·(|t| + ε) ≤ u·(2·Q·V + N) + u·(E + ε)   → 3·u·(2QV+N)
          (the u·(E+ε) part is second-order, covered by the slack).
          IP epilogue subtracts literal 0.0 (exact); only the fl(t+ε)
          rounding remains → 2·u·Q·V.
      (5) ×2 on (1)-(3) for L2 (score = 2·dot − ‖v‖²).
      (×) final ×(1+2^-10) slack: makes the bound STRICT and dominates
          (by >100×) the f32 rounding of this ε computation itself
          (~20 ops ≤ 20·u), the ≤2^-17 relative downward rounding of the
          computed norms Q/R/L, and every second-order u·E cross term.

    There is NO undefended safety factor: each contribution above is tied
    to a specific arithmetic step of the sweep (_sweep_kernel), the rescore
    (rescore_groups), or the certificate comparison, and
    tests/test_property_selection.py adversarially validates the bound on
    norm-skewed and near-tie data (ADVICE r2 medium).
    """
    from ..storage import split_f32_bf16

    if single_pass:
        # single-pass sweeps use RNE-rounded queries: the only query error
        # is RNE rounding, computed exactly per query (no lo pass)
        resid = queries_f32 - queries_f32.astype(jnp.bfloat16).astype(
            jnp.float32)
        lo32 = jnp.zeros_like(queries_f32)
    else:
        qh, ql = split_f32_bf16(queries_f32)
        resid = queries_f32 - qh.astype(jnp.float32) - ql.astype(jnp.float32)
        lo32 = ql.astype(jnp.float32)
    R = jnp.sqrt(jnp.sum(resid * resid, axis=-1))
    L = jnp.sqrt(jnp.sum(lo32 * lo32, axis=-1))
    Q = jnp.sqrt(jnp.sum(queries_f32 * queries_f32, axis=-1))
    # norms are ≥ 0 and padding rows are 0, so no validity mask is needed
    N = jnp.max(jax.lax.slice_in_dim(db_norms, 0, nv_eff, axis=0))
    V = jnp.sqrt(N) * _QUANT_V
    if pair_sweep:
        if split_stats is not None:
            s0, s1 = split_stats[0], split_stats[1]
        else:
            s0, s1 = _LO_REL * V, _RESID_REL * V
        drop = R * V + L * s0 + (Q + R) * s1
    else:
        s0 = 0.0
        drop = R * V
    acc_sweep = (d_pad + 2.0) * _U32 * ((Q + R) * (V + s0) + L * V)
    acc_resc = 2.0 * d_pad * _U32 * Q * V
    eps = drop + acc_sweep + acc_resc
    if metric is MetricType.L2:
        eps = 2.0 * eps + 3.0 * _U32 * (2.0 * Q * V + N)
    else:
        eps = eps + 2.0 * _U32 * Q * V
    return _EPS_SLACK * eps


def _int8_query_pair(queries_f32: jax.Array, scales: jax.Array):
    """qs = q∘s ≈ β₁·q₁ + β₂·q₂ with q₁/q₂ int8 — the residual expansion
    the int8 sweep consumes (q₂ quantizes the first residual, the int8
    analog of the bf16 hi/lo pair; relative error ~2^-12)."""
    qs = queries_f32 * scales[None, :]
    b1 = jnp.maximum(jnp.max(jnp.abs(qs), axis=1), 1e-30) / 127.0
    q1 = jnp.clip(jnp.round(qs / b1[:, None]), -127.0, 127.0)
    r = qs - b1[:, None] * q1
    b2 = jnp.maximum(jnp.max(jnp.abs(r), axis=1), 1e-30) / 127.0
    q2 = jnp.clip(jnp.round(r / b2[:, None]), -127.0, 127.0)
    return q1.astype(jnp.int8), q2.astype(jnp.int8), b1, b2


def _sweep_eps_int8(queries_f32: jax.Array, scales: jax.Array,
                    int_norm_max: jax.Array, db_norms: jax.Array,
                    nv_eff: int, *, metric: MetricType, d_pad: int):
    """Rigorous per-query ε for the int8 sweep vs the fp32-true rescore
    (same soundness statement and budgeting discipline as _sweep_eps).

    Both sides score against the SAME stored v_q with the same stored
    decoded-norm values N_v = fl‖v̂‖² (bit-identical f32 subtracted on both
    sides), and both consume the SAME computed qs = fl(q∘s) — so the common
    real-valued target is qs·v_q and the per-element q∘s rounding cancels:
      sweep   = fl(β₁·fl(a₁) + β₂·fl(a₂)), a_i = q_i·v_q EXACT int32 dots
                (|a_i| ≤ 127²·d < 2^24 → the int32→f32 converts are exact)
      rescore = 3-pass exact-bf16-split dot of qs against v_q widened to
                bf16 (ints ≤ 127 are bf16-exact)
    Budget (u = 2^-24, Qs = ‖qs‖, Vq = max‖v_q‖ exact running statistic,
    Rs = ‖qs − β₁q₁ − β₂q₂‖ and R1 = ‖qs − β₁q₁‖ computed per query,
    N = max stored decoded norm):
      (1) dropped residual:        Rs·Vq
      (2) sweep β-multiplies/add:  ≤ 3·u·(Qs + 2·R1 + Rs)·Vq
          (‖β₁q₁‖ ≤ Qs + R1, ‖β₂q₂‖ ≤ R1 + Rs; 3 roundings)
      (3) rescore accumulation:    ≤ 2·d·u·Qs·Vq (envelope, as _sweep_eps)
      (4) L2 epilogue ×2 sides + fl(t+ε):  3·u·(2·Qs·Vq + N)
          (IP: 2·u·Qs·Vq for the comparison rounding only)
      (5) ×2 on (1)-(3) for L2;  ×(1+2^-10) strictness/computation slack
          (covers the ~u·Rs-relative rounding of computing Rs/R1 itself).
    """
    q1, q2, b1, b2 = _int8_query_pair(queries_f32, scales)
    qs = queries_f32 * scales[None, :]
    r1 = qs - b1[:, None] * q1.astype(jnp.float32)
    resid = r1 - b2[:, None] * q2.astype(jnp.float32)
    Rs = jnp.sqrt(jnp.sum(resid * resid, axis=-1))
    R1 = jnp.sqrt(jnp.sum(r1 * r1, axis=-1))
    Qs = jnp.sqrt(jnp.sum(qs * qs, axis=-1))
    N = jnp.max(jax.lax.slice_in_dim(db_norms, 0, nv_eff, axis=0))
    Vq = int_norm_max
    eps = (Rs * Vq
           + 3.0 * _U32 * (Qs + 2.0 * R1 + Rs) * Vq
           + 2.0 * d_pad * _U32 * Qs * Vq)
    if metric is MetricType.L2:
        eps = 2.0 * eps + 3.0 * _U32 * (2.0 * Qs * Vq + N)
    else:
        eps = eps + 2.0 * _U32 * Qs * Vq
    return _EPS_SLACK * eps


def fused_search(
    queries_f32: jax.Array,    # (nq_pad, d_pad) fp32
    db: jax.Array,             # (capacity, d_pad) storage dtype
    db_norms: jax.Array,       # (capacity,) f32 (‖v‖² for all metrics)
    ntotal: jax.Array,         # scalar int32 (traced)
    *,
    k: int,
    metric: MetricType,
    nv_eff: int,
    interpret: bool = False,
    db_split=None,             # fp32/f16 storage: (db_hi, db_lo) bf16 pair
    pair_only: bool = False,   # device memory holds ONLY the pair (db is hi)
    sweep_passes: int = 2,     # bf16 storage: 1 = RNE single-pass nomination
    xla_sweep: bool = False,   # plain XLA group-max instead of the kernel
    split_stats=None,          # (2,) f32 exact v-side split maxima (storage)
    scales=None,               # int8 storage: (d_pad,) per-dim quant scales
    int_norm_max=None,         # int8 storage: () f32 max ‖v_q‖ (certificate)
    hi_exact: bool = False,    # caller-proven max‖v_lo‖ == max‖resid‖ == 0
    f16_clean: bool = False,   # f16 bits proven subnormal/inf/NaN-free
    sel=None,                  # (capacity,) bool selector stream, or None
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Full fused path: kernel group-max → top groups → gather+rescore.

    Returns (scores (nq_pad, k_eff) descending, ids (nq_pad, k_eff) int32
    −1-free, certified (nq_pad,) bool). ``certified[i]`` proves query i's
    result is the exact top-k of the stored (possibly quantized) database;
    the caller MUST fall back to an exact path for uncertified queries
    (index.py / sharded.py rerun the plain XLA path — the forceMPS-style
    cross-path, MetalDistance.mm:121-123). k_eff = min(k, nv_eff).

    ``sel`` (selector.SearchParams stream): filtered rows mask to −inf via
    the SAME pre-masked norm stream as padding in the sweep, and via the
    final candidate mask after the rescore, so results/certificate
    semantics are those of the admitted sub-database. Soundness is
    unchanged: t is the max masked group-max over non-nominated groups, ε
    bounds |sweep − rescore| per stored row (masked rows are −inf on both
    sides), so certified results are the exact filtered top-k.
    """
    nq_pad, d_pad = queries_f32.shape
    k_eff = min(k, nv_eff)
    is_int8 = db.dtype == jnp.int8
    pair_sweep = not is_int8 and (
        pair_only or db_split is not None or db.dtype != jnp.bfloat16)
    # hi_exact (fp32/pair storage whose EXACT stored split statistics are
    # zero — integer-valued data like SIFT descriptors, where v == v_hi and
    # v_lo/residual are all-zero planes): the sweep reads ONLY the hi bf16
    # plane. Bit-identical to the pair program (every dropped term is an
    # exact f32 +0.0) at HALF the sweep traffic, and the certificate needs
    # no new analysis: _sweep_eps with stats (0, 0) already charges the
    # dropped lo/residual passes exactly 0.
    if hi_exact:
        assert db_split is not None, "hi_exact requires the (hi, lo) pair"
        sweep_db, sweep_split = db_split[0], None
    else:
        sweep_db, sweep_split = db, db_split

    # phase 1 — the group-max sweep (fp32-grade nomination for every storage)
    ngroups = nv_eff // GROUP
    kg = min(k_eff + GROUP_PAD, ngroups)
    gmax = groupmax_scores(
        queries_f32, sweep_db, db_norms, ntotal, sweep_split,
        metric=metric, nv_eff=nv_eff, interpret=interpret,
        sweep_passes=sweep_passes, scales=scales, f16_clean=f16_clean,
        sel=sel, xla_sweep=xla_sweep,
    )
    # phase 2 — top-(k+pad) groups; t is the certificate threshold (max
    # un-nominated group-max); ascending ids keep lowest-id tie order
    gidx, t = _top_groups(gmax, kg, ngroups)
    gidx = jnp.sort(gidx, axis=-1)

    # phase 3 — gather candidate groups and rescore exactly w.r.t. the
    # *stored* (possibly quantized) vectors — strictly more accurate than
    # the sweep, whose only job is nominating groups
    offs = jax.lax.broadcasted_iota(jnp.int32, (1, 1, GROUP), 2)
    cols = (gidx[:, :, None] * GROUP + offs).reshape(nq_pad, kg * GROUP)
    if pair_only:
        s = rescore_groups(queries_f32, db_split[0], db_norms, gidx,
                           metric=metric,
                           db_lo=None if hi_exact else db_split[1])
    else:
        qq = queries_f32 * scales[None, :] if is_int8 else queries_f32
        s = rescore_groups(qq, db, db_norms, gidx, metric=metric,
                           f16_clean=f16_clean)
    ok_cols = cols < ntotal
    if sel is not None:
        ok_cols &= jnp.take(sel, cols, axis=0)
    s = jnp.where(ok_cols, s, NEG_INF)
    vals, pos = topk_ops.topk_scores(s, k_eff)
    ids = jnp.take_along_axis(cols, pos, axis=-1)

    # certificate: the k-th rescored score strictly dominates anything a
    # non-nominated group could hold (its sweep max + ε) → provably exact.
    # −inf threshold (all groups nominated / empty shard) certifies trivially.
    if is_int8:
        eps = _sweep_eps_int8(queries_f32, scales, int_norm_max, db_norms,
                              nv_eff, metric=metric, d_pad=d_pad)
    else:
        eps = _sweep_eps(queries_f32, db_norms, nv_eff, metric=metric,
                         pair_sweep=pair_sweep, d_pad=d_pad,
                         single_pass=sweep_passes == 1,
                         split_stats=split_stats)
    certified = (t == NEG_INF) | (vals[:, k_eff - 1] >= t + eps)
    return vals, ids, certified


def fused_path_eligible(*, metric: MetricType, k: int, nv_eff: int,
                        d_pad: int, nq_pad: int = 128,
                        itemsize: int = 2, dtype=None) -> bool:
    """Dispatch gate (≈ MetalDistance::encodeFused gate, mm:346-353 — but our
    fused kernel handles all nq, both metrics and large k; the gate is about
    phase-3 gather volume). The decision is a traffic cost model: the plain
    path's extra cost is materializing the nq×nv fp32 score matrix plus a
    k-scaled lax.top_k over it; the fused path's extra cost is the
    candidate gather + rescore. Large-k passes for small query batches;
    large-d/small-nv shapes (where the gather rivals the sweep) route to
    the XLA paths."""
    del metric, dtype
    if nv_eff < FUSED_MIN_NV:
        return False
    ngroups = nv_eff // GROUP
    kg = min(k + GROUP_PAD, ngroups)
    # the rescore gathers the stored rows (fp32: the 4 B/elem master)
    gather_bytes = nq_pad * kg * GROUP * d_pad * itemsize
    if gather_bytes > FUSED_GATHER_BUDGET:
        return False
    plain_extra = nq_pad * nv_eff * (
        PLAIN_SCORE_BYTES + PLAIN_TOPK_BYTES_PER_K16 * k / 16.0
    )
    fused_extra = FUSED_GATHER_WEIGHT * gather_bytes + nq_pad * ngroups * 8.0
    return fused_extra < plain_extra
