"""Occupancy / density scatter-adds.

Device replacement for the reference's ``np.bincount`` occupancy builders
(PARTICLE_solver_CLASS.py:248-252, :205-206): masked scatter-adds with static
output length (alive-mask instead of variable-length position arrays).
"""
from __future__ import annotations

import jax.numpy as jnp


def masked_bincount(pos: jnp.ndarray, weights: jnp.ndarray, L: int) -> jnp.ndarray:
    """Per-site sum of ``weights`` at lattice index ``pos`` (trailing particle
    axis; leading dims batch).  Dead particles contribute weight 0."""
    out_shape = pos.shape[:-1] + (L,)
    zeros = jnp.zeros(out_shape, dtype=weights.dtype)
    if pos.ndim == 1:
        # explicit mask, not bare mode="drop": concrete negative indices
        # would wrap NumPy-style (-1 -> L-1) instead of dropping
        valid = (pos >= 0) & (pos < L)
        return zeros.at[jnp.where(valid, pos, 0)].add(
            jnp.where(valid, weights, 0), mode="drop")
    # batched: flatten leading dims and offset indices into a single axis.
    # Out-of-range indices must DROP here too (matching the unbatched
    # branch): after the flatten, a raw pos >= L would land in the NEXT
    # batch row's bins (pos + b*L is in-range for the flat buffer), silently
    # corrupting the neighbor replica — zero the weight and route to bin 0.
    import math
    B = math.prod(pos.shape[:-1])
    flat_pos = pos.reshape(B, -1)
    flat_w = weights.reshape(B, -1)
    in_range = (flat_pos >= 0) & (flat_pos < L)
    flat_pos = jnp.where(in_range, flat_pos, 0)
    flat_w = jnp.where(in_range, flat_w, 0)
    offsets = (jnp.arange(B, dtype=flat_pos.dtype) * L)[:, None]
    flat = jnp.zeros((B * L,), dtype=weights.dtype)
    flat = flat.at[(flat_pos + offsets).reshape(-1)].add(
        flat_w.reshape(-1), mode="drop")
    return flat.reshape(out_shape)


def occupancy(pos: jnp.ndarray, sigma: jnp.ndarray, alive: jnp.ndarray,
              L: int):
    """(occ_total, counts_p, counts_m) per site — the reference's
    ``_build_occupancy`` with an alive-mask."""
    a = alive.astype(jnp.float32)
    wp = a * (sigma > 0)
    wm = a * (sigma < 0)
    counts_p = masked_bincount(pos, wp, L)
    counts_m = masked_bincount(pos, wm, L)
    return counts_p + counts_m, counts_p, counts_m
