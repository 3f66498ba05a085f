"""IVF fine-scan kernel: gather the probed chunks and score them in one
pass (Pallas, Triton route).

Each program owns one query and CHUNKS_PER_PROGRAM positions of that
query's chunk list: it loads its own chunk ids, reads each 128-row chunk
of the pool once, and writes the chunk's 128 scores — the candidate rows
never land in device memory as a gathered copy (the XLA take + batched dot
form, ivf._probed_scores, writes and re-reads them).

Scores are the plain path's fp32 class: rows widen exactly to f32 (bf16
and int8 codes are exact in f32) and the dot is an f32 multiply-add over d
against the f32 query (int8 callers pass q∘s, matching the decoded norms
they store).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..dtypes import MetricType

CHUNK = 128               # pool chunk rows (== ivf._CHUNK)
CHUNKS_PER_PROGRAM = 8
SCAN_BD = 128             # d step
SCAN_WARPS = 4
SCAN_STAGES = 2


def _scan_kernel(q_ref, qn_ref, cidx_ref, okc_ref, data_ref, norms_ref,
                 valid_ref, out_ref, *, metric, nd):
    i, j = pl.program_id(0), pl.program_id(1)
    qn = qn_ref[i]

    def chunk(c, carry):
        pos = j * CHUNKS_PER_PROGRAM + c
        cid = cidx_ref[i, pos]
        rows = pl.ds(cid * CHUNK, CHUNK)
        dots = jnp.zeros((CHUNK,), jnp.float32)
        for t in range(nd):
            cols = pl.ds(t * SCAN_BD, SCAN_BD)
            v = data_ref[rows, cols].astype(jnp.float32)
            q = q_ref[i, cols]
            dots = dots + jnp.sum(v * q[None, :], axis=1)
        if metric is MetricType.L2:
            s = 2.0 * dots - norms_ref[rows] - qn
        else:
            s = dots
        ok = (valid_ref[rows] != 0) & (okc_ref[i, pos] != 0)
        out_ref[i, pl.ds(pos * CHUNK, CHUNK)] = jnp.where(ok, s, -jnp.inf)
        return carry

    jax.lax.fori_loop(0, CHUNKS_PER_PROGRAM, chunk, 0)


def scan_chunks(qeff, qn, cidx, okc, data, norms, valid, *, metric,
                interpret):
    """(nq, nbudget·CHUNK) scores of each query's chunk list.

    qeff (nq, d_pad) f32 dot-side queries; qn (nq,) f32 ‖q‖²; cidx (nq,
    nbudget) int32 pool chunk ids; okc (nq, nbudget) bool live positions;
    data (npool·CHUNK, d_pad) pool rows; norms (npool·CHUNK,) f32; valid
    (npool·CHUNK,) bool slot validity (occupancy and selector). Invalid
    positions score −inf."""
    nq, nbudget = cidx.shape
    d_pad = data.shape[1]
    assert d_pad % SCAN_BD == 0, d_pad
    nprog = pl.cdiv(nbudget, CHUNKS_PER_PROGRAM)
    pad = nprog * CHUNKS_PER_PROGRAM - nbudget
    okc = okc.astype(jnp.int32)
    if pad:  # whole programs: padded positions read chunk 0, masked
        cidx = jnp.pad(cidx, ((0, 0), (0, pad)))
        okc = jnp.pad(okc, ((0, 0), (0, pad)))
    out = pl.pallas_call(
        functools.partial(_scan_kernel, metric=metric, nd=d_pad // SCAN_BD),
        grid=(nq, nprog),
        out_shape=jax.ShapeDtypeStruct(
            (nq, nprog * CHUNKS_PER_PROGRAM * CHUNK), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=SCAN_WARPS,
                                             num_stages=SCAN_STAGES),
        interpret=interpret,
        name="ivf_chunk_scan",
    )(qeff, qn, cidx, okc, data, norms, valid.astype(jnp.int32))
    return out[:, :nbudget * CHUNK]
