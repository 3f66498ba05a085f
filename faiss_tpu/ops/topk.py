"""Top-k selection stage.

≈ MetalSelect (src/MetalSelect.mm) + the warp_select / block_select shaders
(shaders/warp_select.metal, shaders/block_select.metal). The reference routes
k ≤ 32 to a 32-thread warp-select and k > 32 to a 256/512-thread block-select;
here the baseline is ``lax.top_k`` (exact, sort-based) and the scalable path
is a two-stage chunked select that never materializes the full (nq, nv) score
matrix for huge nv.

IMPORTANT behavioral fix over the reference: block_select's pairwise merge
keeps only LOCAL_K=8 real results, so for k > 8 the reference silently pads
ranks 9..k with sentinels (shaders/block_select.metal:170-192 — see
SURVEY.md §2.3.1). Every path here is exact for all k up to nv; tests assert
large-k (k = 1024–2048) correctness against the oracle.

All functions consume max-is-best *scores* (see ops/distance.py) and return
(scores, int32 ids) sorted descending by score.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def topk_scores(scores: jax.Array, k: int) -> Tuple[jax.Array, jax.Array]:
    """Exact top-k over the last axis. Baseline path (≈ warp/block_select).

    Indices-only top_k + a value gather, which reproduces the values
    exactly (one lowering whether or not a caller consumes the values)."""
    _, idx = jax.lax.top_k(scores, k)
    vals = jnp.take_along_axis(scores, idx, axis=-1)
    return vals, idx.astype(jnp.int32)


def merge_topk(
    vals_a: jax.Array, ids_a: jax.Array,
    vals_b: jax.Array, ids_b: jax.Array,
    k: int,
) -> Tuple[jax.Array, jax.Array]:
    """Merge two (…, ka/kb) partial top-k lists into one (…, k) list.

    The correct analog of block_select's pairwise merge — but keeping the full
    k instead of LOCAL_K=8 (the reference bug noted above). Also the building
    block for the cross-shard merge (parallel/sharded.py).
    """
    vals = jnp.concatenate([vals_a, vals_b], axis=-1)
    ids = jnp.concatenate([ids_a, ids_b], axis=-1)
    top_vals, pos = jax.lax.top_k(vals, k)
    return top_vals, jnp.take_along_axis(ids, pos, axis=-1)


def chunked_topk_scores(
    score_fn,
    nv_padded: int,
    chunk: int,
    k: int,
) -> Tuple[jax.Array, jax.Array]:
    """Two-stage exact top-k over a virtual (nq, nv) score matrix.

    ``score_fn(start)`` must return the (nq, chunk) score block for db columns
    [start, start+chunk). Stage 1 runs top-min(k, chunk) per chunk under
    ``lax.fori_loop`` so only one chunk of scores is live at a time (the memory
    property the reference's fused_l2_topk kernel buys — it never materializes
    nq×nv, shaders/fused_l2_topk.metal:19-131). Stage 2 merges the running
    partials after every chunk, so peak memory is O(nq·(chunk + k)).
    """
    assert nv_padded % chunk == 0, (nv_padded, chunk)
    nchunks = nv_padded // chunk
    kc = min(k, chunk)

    def first_chunk():
        s = score_fn(0)
        v, i = topk_scores(s, kc)
        if kc < k:  # pad so carry shape is static (can only happen if k > chunk)
            pad_v = jnp.full(v.shape[:-1] + (k - kc,), -jnp.inf, v.dtype)
            pad_i = jnp.full(i.shape[:-1] + (k - kc,), -1, jnp.int32)
            v = jnp.concatenate([v, pad_v], axis=-1)
            i = jnp.concatenate([i, pad_i], axis=-1)
        return v, i

    def body(c, carry):
        run_v, run_i = carry
        start = c * chunk
        s = score_fn(start)
        v, i = topk_scores(s, kc)
        return merge_topk(run_v, run_i, v, i + start, k)

    init = first_chunk()
    if nchunks == 1:
        return init
    return jax.lax.fori_loop(1, nchunks, body, init)


def take_topk_rows(db: jax.Array, ids: jax.Array) -> jax.Array:
    """Gather rows by top-k ids (used by reconstruct-style helpers)."""
    return jnp.take(db, jnp.clip(ids, 0, db.shape[0] - 1), axis=0)
