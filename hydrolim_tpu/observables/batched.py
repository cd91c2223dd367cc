"""Batched on-device estimator suite.

Round 1 computed the estimator layer as a host-side Python loop over
replicas (``frames_to_out`` + NumPy per replica) — fine at the reference's
3-10 runs, but it dominates wall time for the 10³+-replica grids one
device advances together.  This module evaluates the same five estimators
(``..._sweep_beta.py:123-229,500-525``) for EVERY replica in one jitted
program over the batch-leading frame arrays, with the measurement window
realized as a per-replica frame mask instead of Python slicing:

- v_eff: d⟨x⟩/dt of the density COM, masked mean over the window (:123-162),
- legacy/strict window semantics identical to ``estimators.measurement_window``,
- mean magnetization (:316-319),
- rho_eff front density (:165-194),
- blocking probability (:197-229),
- D_eff displacement-variance slope on stable buffer slots (:500-525),
  as a masked least-squares slope.

Host-side results match ``estimators.*`` to float32 precision (see
tests/test_estimators.py::test_batched_matches_host).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp


class BatchedEstimates(NamedTuple):
    v_eff: jnp.ndarray     # (B,)
    D_eff: jnp.ndarray     # (B,)  nan when undefined
    m_mean: jnp.ndarray    # (B,)
    rho_eff: jnp.ndarray   # (B,)
    p_block: jnp.ndarray   # (B,)
    start_idx: jnp.ndarray  # (B,) int32
    end_idx: jnp.ndarray    # (B,) int32


def _window_mask(total, *, xlim: float, window_mode: str,
                 boundary_xmin_frac: float = 0.99,
                 max_boundary_fraction: float = 0.06,
                 min_window_fraction: float = 0.10):
    """Per-replica (start, end) as arrays + the (B, M) frame mask."""
    B, M, L = total.shape
    x = jnp.linspace(0.0, xlim, L)
    dx = x[1] - x[0]
    bmask = x >= boundary_xmin_frac * xlim
    boundary_mass = jnp.sum(total * bmask, axis=-1) * dx          # (B, M)
    N_t = jnp.sum(total, axis=-1) * dx
    frac = boundary_mass / (N_t + 1e-12)
    unsafe = frac >= max_boundary_fraction

    start = int(0.65 * M)
    min_len = max(3, int(min_window_fraction * M))
    if window_mode == "legacy":
        # reference rule (see estimators.measurement_window): collapse to
        # min_len only when the unsafe-frame COUNT exceeds 0.65·M
        count_unsafe = jnp.sum(unsafe, axis=-1)
        end = jnp.where(count_unsafe > start, min(M, start + min_len), M)
    elif window_mode == "strict":
        tail = unsafe[:, start:]
        has = jnp.any(tail, axis=-1)
        first = jnp.argmax(tail, axis=-1)
        end = jnp.where(has, start + first, M)
        end = jnp.maximum(end, min(M, start + min_len))
    else:
        raise ValueError(window_mode)
    idx = jnp.arange(M)
    mask = (idx[None, :] >= start) & (idx[None, :] < end[:, None])
    return start, end.astype(jnp.int32), mask


@functools.partial(
    jax.jit,
    static_argnames=("xlim", "dx", "window_mode", "rho_window",
                     "has_positions"))
def batched_estimates(total, m_global, rho_p, times,
                      pos: Optional[jnp.ndarray] = None,
                      alive: Optional[jnp.ndarray] = None, *,
                      dx: float, xlim: float = 1.0,
                      window_mode: str = "legacy",
                      rho_window: float = 0.05,
                      has_positions: bool = True) -> BatchedEstimates:
    """All five reference estimators over the batch axis, on device.

    Args:
      total/rho_p: (B, M, L) density frames; m_global: (B, M);
      times: (M,); pos/alive: (B, M, n) unwrapped slot positions + masks
      (required for D_eff unless ``has_positions=False``).
    """
    total = jnp.asarray(total, jnp.float32)
    B, M, L = total.shape
    start, end, mask = _window_mask(total, xlim=float(xlim),
                                    window_mode=window_mode)
    maskf = mask.astype(jnp.float32)
    n_mask = jnp.maximum(jnp.sum(maskf, axis=-1), 1.0)

    # --- v_eff (:123-162) --------------------------------------------------
    x = jnp.linspace(0.0, float(xlim), L)
    mean_x = jnp.sum(total * x, axis=-1) / (jnp.sum(total, axis=-1) + 1e-12)
    v_ts = jnp.gradient(mean_x, jnp.asarray(times, jnp.float32), axis=-1)
    v_eff = jnp.sum(v_ts * maskf, axis=-1) / n_mask

    # --- mean magnetization (:316-319) --------------------------------------
    m_mean = jnp.sum(jnp.asarray(m_global, jnp.float32) * maskf, axis=-1) \
        / n_mask

    # --- rho_eff front density (:165-194) -----------------------------------
    occ = total > 0
    any_occ = jnp.any(occ, axis=-1)                               # (B, M)
    idx_max = (L - 1) - jnp.argmax(jnp.flip(occ, axis=-1), axis=-1)
    x_max = x[idx_max]                                            # (B, M)
    in_win = ((x[None, None, :] >= x_max[..., None] - rho_window)
              & (x[None, None, :] <= x_max[..., None]))
    # the reference integrates on its linspace grid: dx_grid = xlim/(L-1)
    # (:168-169), NOT the lattice dx = xlim/L
    dx_grid = x[1] - x[0]
    frame_val = jnp.sum(total * in_win, axis=-1) * dx_grid / rho_window
    frame_ok = (any_occ & (jnp.sum(in_win, axis=-1) > 0)).astype(jnp.float32) \
        * maskf
    n_ok_frames = jnp.sum(frame_ok, axis=-1)
    # nan when no window frame has occupancy — matches the host estimator
    # (silently returning 0.0 would deflate sweep means)
    rho_eff = jnp.where(
        n_ok_frames > 0,
        jnp.sum(frame_val * frame_ok, axis=-1) / jnp.maximum(n_ok_frames,
                                                             1e-12),
        jnp.nan)

    # --- blocking probability (:197-229) ------------------------------------
    rp = jnp.asarray(rho_p, jnp.float32)[..., :-1]
    nxt = total[..., 1:]
    attempts = jnp.sum(rp * maskf[..., None], axis=(-2, -1))
    blocked = jnp.sum(rp * (nxt >= 1.0) * maskf[..., None], axis=(-2, -1))
    p_block = jnp.where(attempts > 0, blocked / attempts, 0.0)

    # --- D_eff displacement-variance slope (:500-525) -----------------------
    if has_positions and pos is not None:
        posf = jnp.asarray(pos, jnp.float32) * dx                 # (B, M, n)
        al = jnp.asarray(alive, bool)
        p0 = posf[:, start]                                       # (B, n)
        a0 = al[:, start]
        ok = a0[:, None, :] & al                                  # (B, M, n)
        n_ok = jnp.sum(ok, axis=-1).astype(jnp.float32)           # (B, M)
        r = (posf - p0[:, None, :]) * ok
        r_mean = jnp.sum(r, axis=-1) / jnp.maximum(n_ok, 1.0)
        S = jnp.sum(((posf - p0[:, None, :]) - r_mean[..., None]) ** 2 * ok,
                    axis=-1) / jnp.maximum(n_ok - 1.0, 1.0)       # (B, M)
        idx = jnp.arange(M)
        fmask = ((idx[None, :] > start) & (idx[None, :] < end[:, None])
                 & (n_ok >= 2)).astype(jnp.float32)
        t_rel = jnp.asarray(times, jnp.float32) - times[start]
        w_sum = jnp.maximum(jnp.sum(fmask, axis=-1), 1.0)
        t_bar = jnp.sum(t_rel * fmask, axis=-1) / w_sum
        S_bar = jnp.sum(S * fmask, axis=-1) / w_sum
        cov = jnp.sum((t_rel[None, :] - t_bar[:, None])
                      * (S - S_bar[:, None]) * fmask, axis=-1)
        var = jnp.sum((t_rel[None, :] - t_bar[:, None]) ** 2 * fmask, axis=-1)
        D_eff = jnp.where(jnp.sum(fmask, axis=-1) >= 2,
                          cov / jnp.maximum(var, 1e-30), jnp.nan)
    else:
        D_eff = jnp.full((B,), jnp.nan, jnp.float32)

    return BatchedEstimates(
        v_eff=v_eff, D_eff=D_eff, m_mean=m_mean, rho_eff=rho_eff,
        p_block=p_block,
        start_idx=jnp.full((B,), start, jnp.int32), end_idx=end)
