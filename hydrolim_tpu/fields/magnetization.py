"""Local/global magnetization fields.

Particle side: ``compute_local_m_field`` (PARTICLE_solver_CLASS.py:216-246) —
m(x) = smoothed(counts₊ − counts₋) / smoothed(counts₊ + counts₋), clipped to
[−1, 1]; σ ≤ 0 broadcasts the global magnetization; periodic smoothing is a
cached torus-Gaussian circular convolution, non-periodic a reflect-mode
Gaussian blur.

PDE side: ``pde_magnetization`` (IMEX_PDE_solver_class.py:154-166) —
pointwise (ρ₊−ρ₋)/(ρ₊+ρ₋) without a kernel, global scalar above the σ>1e5
sentinel, else kernel smoothing of numerator and denominator.  The sentinel
quirk is reproduced deliberately (SURVEY.md §2.4).

The circular convolution runs as one dense f32 matmul by default (ops.dft);
the rFFT path is the opt-in large-L mode.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from hydrolim_tpu.ops import dft
from hydrolim_tpu.ops.convolve import periodic_gaussian_kernel, reflect_gaussian_filter


class SmoothOp(NamedTuple):
    """Cached circular-convolution operator (exactly one of the three fields
    is non-empty); real arrays only."""

    kernel_rfft_ri: jnp.ndarray   # float32 (L//2+1, 2) — native-fft mode
    conv_mat: jnp.ndarray         # float32 (L, L)      — matmul mode
    conv_kernel: jnp.ndarray      # float32 (W,)        — large-L narrow conv


_ZK = lambda: jnp.zeros((0,), jnp.float32)

# past this lattice size the L×L circulant matmul stops scaling; narrow
# (symmetric) kernels switch to a wrap-padded banded convolution
_NARROW_CONV_MIN_L = 4096


def build_smooth_op(kernel: Optional[np.ndarray]) -> SmoothOp:
    if kernel is None:
        return SmoothOp(jnp.zeros((0, 2), jnp.float32),
                        jnp.zeros((0, 0), jnp.float32), _ZK())
    kernel = np.asarray(kernel, np.float64)
    L = kernel.shape[0]
    if L > _NARROW_CONV_MIN_L:
        # centered support radius (Gaussian kernels are symmetric)
        mags = np.abs(kernel)
        eps = 1e-9 * mags.max()
        d = np.minimum(np.arange(L), L - np.arange(L))
        nz = d[mags >= eps]
        r = int(nz.max()) if nz.size else 0
        if r < L // 8:
            w = np.concatenate([kernel[L - r:], kernel[:r + 1]]) \
                if r else kernel[:1]
            return SmoothOp(jnp.zeros((0, 2), jnp.float32),
                            jnp.zeros((0, 0), jnp.float32),
                            jnp.asarray(w, jnp.float32))
    if dft.fft_mode() == "native":
        K = np.fft.rfft(kernel)
        kri = np.stack([K.real, K.imag], axis=-1).astype(np.float32)
        return SmoothOp(jnp.asarray(kri), jnp.zeros((0, 0), jnp.float32),
                        _ZK())
    return SmoothOp(jnp.zeros((0, 2), jnp.float32),
                    dft.circulant_matmul_matrix(kernel), _ZK())


def apply_smooth(op: SmoothOp, x: jnp.ndarray) -> jnp.ndarray:
    if op.conv_kernel.shape[0] > 0:
        from hydrolim_tpu.ops.convolve import banded_circular_conv

        return banded_circular_conv(x, op.conv_kernel)
    if op.conv_mat.shape[0] > 0:
        return dft.circular_convolve(x, op.conv_mat)
    L = x.shape[-1]
    X = dft.rfft_ri(x)
    kr, ki = op.kernel_rfft_ri[..., 0], op.kernel_rfft_ri[..., 1]
    re = X[..., 0] * kr - X[..., 1] * ki
    im = X[..., 0] * ki + X[..., 1] * kr
    return dft.irfft_ri(jnp.stack([re, im], axis=-1), n=L)


# ---------------------------------------------------------------------------
# particle m-field
# ---------------------------------------------------------------------------

class MFieldOp(NamedTuple):
    smooth: SmoothOp


def build_mfield_op(L: int, dx: float, sigma: float, periodic: bool) -> MFieldOp:
    if sigma > 0 and periodic:
        return MFieldOp(build_smooth_op(periodic_gaussian_kernel(L, dx, sigma)))
    return MFieldOp(build_smooth_op(None))


def local_m_field(counts_p: jnp.ndarray, counts_m: jnp.ndarray,
                  op: MFieldOp, *, sigma: float, sigma_grid: float,
                  periodic: bool) -> jnp.ndarray:
    """Batched over leading dims; trailing axis is the lattice."""
    s = counts_p - counts_m
    tot = counts_p + counts_m
    if sigma <= 0:
        m_global = jnp.sum(s, axis=-1, keepdims=True) / jnp.maximum(
            jnp.sum(tot, axis=-1, keepdims=True), 1e-12)
        return jnp.broadcast_to(m_global, s.shape)
    if periodic:
        s_conv = apply_smooth(op.smooth, s)
        tot_conv = apply_smooth(op.smooth, tot)
    else:
        s_conv = reflect_gaussian_filter(s, sigma_grid)
        tot_conv = reflect_gaussian_filter(tot, sigma_grid)
    m = jnp.where(tot_conv > 0, s_conv / jnp.where(tot_conv > 0, tot_conv, 1.0), 0.0)
    return jnp.clip(m, -1.0, 1.0)


# ---------------------------------------------------------------------------
# PDE magnetization
# ---------------------------------------------------------------------------

def pde_magnetization(rho_p: jnp.ndarray, rho_m: jnp.ndarray,
                      smooth: Optional[SmoothOp], *,
                      kernel_sigma: float,
                      global_sentinel: float = 1e5) -> jnp.ndarray:
    """IMEX_PDE_solver_class.py:154-166 semantics, batched."""
    num = rho_p - rho_m
    den = rho_p + rho_m
    if smooth is None:
        return num / (den + 1e-12)
    if kernel_sigma > global_sentinel:
        g = jnp.sum(num, axis=-1, keepdims=True) / (
            jnp.sum(den, axis=-1, keepdims=True) + 1e-12)
        return jnp.broadcast_to(g, num.shape)
    both = apply_smooth(smooth, jnp.stack([num, den], axis=-2))
    return both[..., 0, :] / (both[..., 1, :] + 1e-12)
