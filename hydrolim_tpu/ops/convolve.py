"""Smoothing convolutions for the magnetization field.

Device replacements for the reference's two smoothing paths
(PARTICLE_solver_CLASS.py:223-238):

- periodic: FFT convolution with a cached torus Gaussian kernel,
- non-periodic: ``scipy.ndimage.gaussian_filter1d(mode='reflect')``
  re-implemented as a reflect-padded direct convolution (half-sample
  symmetric extension, identical weights: radius = int(4·σ + 0.5)).

All functions operate on the trailing axis and broadcast over leading batch
dims so that vmapped replica/β sweeps go through a single compiled program.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def periodic_gaussian_kernel(L: int, dx: float, sigma: float) -> np.ndarray:
    """Normalized Gaussian on the torus, centered at site 0
    (PARTICLE_solver_CLASS.py:108-122, IMEX_PDE_solver_class.py:84-93)."""
    j = np.arange(L)
    dist = np.minimum(j, L - j) * dx
    kernel = np.exp(-0.5 * (dist / sigma) ** 2)
    return (kernel / kernel.sum()).astype(np.float32)


def periodic_conv(x: jnp.ndarray, kernel_rfft: jnp.ndarray) -> jnp.ndarray:
    """Circular convolution via rFFT; ``kernel_rfft = rfft(kernel)``."""
    L = x.shape[-1]
    return jnp.fft.irfft(jnp.fft.rfft(x) * kernel_rfft, n=L)


def gaussian_filter_weights(sigma_grid: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage.gaussian_filter1d weights (normalized, radius=4σ)."""
    radius = int(truncate * sigma_grid + 0.5)
    xs = np.arange(-radius, radius + 1)
    w = np.exp(-0.5 * (xs / sigma_grid) ** 2)
    return (w / w.sum()).astype(np.float32)


def reflect_pad(x: jnp.ndarray, pad: int) -> jnp.ndarray:
    """Half-sample symmetric padding (scipy mode='reflect') of the trailing
    axis, supporting pad widths larger than the axis length."""
    L = x.shape[-1]
    while pad > 0:
        p = min(pad, L)
        left = jnp.flip(x[..., :p], axis=-1)
        right = jnp.flip(x[..., -p:], axis=-1)
        x = jnp.concatenate([left, x, right], axis=-1)
        pad -= p
        L = x.shape[-1]
    return x


@functools.lru_cache(maxsize=16)
def _reflect_ring_matrix(L: int, sigma_grid: float,
                         truncate: float) -> np.ndarray:
    """Matrix M (2L, 2L) with ``even_ext(x) @ M`` = the reflect-mode Gaussian
    correlation on the 2L-periodic half-sample even extension (mathematically
    identical to scipy's reflect filtering for any kernel radius, since the
    reflect extension has period 2L)."""
    w = gaussian_filter_weights(sigma_grid, truncate).astype(np.float64)
    r = (len(w) - 1) // 2
    M2 = 2 * L
    ring = np.zeros(M2, np.float64)
    for d in range(-r, r + 1):
        ring[(-d) % M2] += w[d + r]
    j = np.arange(M2)
    C = ring[(j[:, None] - j[None, :]) % M2]   # y = C @ e
    return np.ascontiguousarray(C.T.astype(np.float32))  # e @ M


@functools.partial(jax.jit, static_argnames=("sigma_grid", "truncate"))
def reflect_gaussian_filter(x: jnp.ndarray, sigma_grid: float,
                            truncate: float = 4.0) -> jnp.ndarray:
    """Drop-in for ``gaussian_filter1d(x, sigma_grid, mode='reflect')`` on the
    trailing axis (batched over leading dims).

    Narrow kernels run as a VALID convolution over a reflect-padded signal;
    wide kernels (radius > L/4) run as ONE (…, 2L)·(2L, 2L) circulant matmul
    on the even extension — exactly equivalent (the reflect
    extension is 2L-periodic)."""
    w_np = gaussian_filter_weights(sigma_grid, truncate)
    radius = (len(w_np) - 1) // 2
    L = x.shape[-1]
    xf = x.astype(jnp.float32)
    if radius > L // 4:
        M = jnp.asarray(_reflect_ring_matrix(L, float(sigma_grid),
                                             float(truncate)))
        even = jnp.concatenate([xf, jnp.flip(xf, axis=-1)], axis=-1)
        out = jnp.matmul(even, M, precision=jax.lax.Precision.HIGHEST)
        return out[..., :L]
    w = jnp.asarray(w_np)
    xp = reflect_pad(xf, radius)
    batch_shape = xp.shape[:-1]
    flat = xp.reshape((-1, 1, xp.shape[-1]))
    out = jax.lax.conv_general_dilated(
        flat,
        w.reshape((1, 1, -1)),
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST,
    )
    return out.reshape(batch_shape + (out.shape[-1],))


def banded_circular_conv(x, w):
    """Periodic banded convolution with a centered symmetric kernel ``w``
    ((W,), W = 2r+1) on the trailing axis, batched over leading dims — the
    shared large-L primitive behind the banded diffusion solve
    (ops.diffusion) and the narrow m-field smoothing (fields.magnetization).
    Wrap-pads by r and runs one VALID `conv_general_dilated` at
    `Precision.HIGHEST` (bf16 operands would quantize density fluctuations;
    see VALIDATION.md)."""
    r = (w.shape[0] - 1) // 2
    L = x.shape[-1]
    xf = x.astype(jnp.float32)
    assert r < L, "banded kernel wider than the lattice"
    xp = jnp.concatenate([xf[..., L - r:], xf, xf[..., :r]], axis=-1) \
        if r else xf
    flat = xp.reshape((-1, 1, xp.shape[-1]))
    out = jax.lax.conv_general_dilated(
        flat, w.reshape((1, 1, -1)), window_strides=(1,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST)
    return out.reshape(x.shape[:-1] + (L,))
