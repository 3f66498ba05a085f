"""Row-wise squared-L2 norms.

≈ MetalL2Norm (src/MetalL2Norm.mm:9-89) + the l2_norm / l2_norm_f16 shaders
(shaders/l2_norm.metal, shaders/l2_norm_f16.metal). Here this is a single
fused VPU reduction; the reference's small-d vs large-d (>1024) kernel split
and FP16-ALU fast path collapse into one einsum that XLA tiles automatically.
Kept as a named component because the index precomputes database norms at
add() time from the *fp32* input, before any bf16/f16 quantization
(reference: src/MetalIndexFlat.mm:258-267, README.md:170).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def l2_norm_squared(x: jax.Array) -> jax.Array:
    """``‖x_i‖²`` per row of an (n, d) matrix, fp32 accumulation.

    Low-precision inputs (bf16/f16) are multiplied in their storage dtype but
    accumulated in fp32 — the analog of the reference's half-multiply /
    float-accumulate l2_norm_f16 kernel (shaders/l2_norm_f16.metal:10-29).
    """
    if x.ndim != 2:
        raise ValueError(f"expected (n, d) matrix, got shape {x.shape}")
    return jnp.sum(
        (x * x).astype(jnp.float32), axis=-1,
    )
