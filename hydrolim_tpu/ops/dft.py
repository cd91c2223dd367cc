"""DFT and circular convolution as dense matmuls.

At the framework's native problem sizes (L ≈ 10³ lattice sites) the DFT and
circulant operators run as one (B, L)·(L, L) f32 matmul each, batched over
replicas and sweep points.  ``jnp.fft`` is the opt-in alternative: set
``HYDROLIM_FFT_MODE=native`` or call :func:`set_fft_mode`.

Conventions match ``numpy.fft``: ``rfft``/``irfft``/``fft`` of a real signal
on the trailing axis.
"""
from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_FFT_MODE: Optional[str] = None  # 'matmul' | 'native'


def _mm(a: "jnp.ndarray", b: "jnp.ndarray") -> "jnp.ndarray":
    """f32 matmul at HIGHEST precision (no TF32 or bf16 passes)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def fft_mode() -> str:
    global _FFT_MODE
    if _FFT_MODE is None:
        _FFT_MODE = os.environ.get("HYDROLIM_FFT_MODE", "matmul")
    return _FFT_MODE


def set_fft_mode(mode: str) -> None:
    assert mode in ("matmul", "native")
    global _FFT_MODE
    _FFT_MODE = mode


@functools.lru_cache(maxsize=16)
def _rfft_mats(L: int) -> Tuple[np.ndarray, np.ndarray]:
    """COS/SIN forward matrices: X_k = Σ_j x_j·exp(−2πijk/L), k = 0..L/2."""
    j = np.arange(L)[:, None]
    k = np.arange(L // 2 + 1)[None, :]
    ang = 2.0 * np.pi * j * k / L
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _irfft_mats(L: int) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse matrices A, B with x_j = Re(X)·A + Im(X)·B (hermitian input)."""
    K = L // 2 + 1
    k = np.arange(K)[:, None]
    j = np.arange(L)[None, :]
    ang = 2.0 * np.pi * k * j / L
    w = np.full((K, 1), 2.0)
    w[0] = 1.0
    if L % 2 == 0:
        w[-1] = 1.0
    A = (w * np.cos(ang) / L).astype(np.float32)
    B = (-w * np.sin(ang) / L).astype(np.float32)
    return A, B


def rfft_ri(x: jnp.ndarray, L: Optional[int] = None) -> jnp.ndarray:
    """Real→hermitian DFT on the trailing axis, returned as stacked
    (..., L//2+1, 2) real/imag float32 channels.

    The device path stays in real pairs; complex views are materialized
    host-side only."""
    if L is None:
        L = x.shape[-1]
    if fft_mode() == "native":
        X = jnp.fft.rfft(x, n=L)
        return jnp.stack([jnp.real(X), jnp.imag(X)], axis=-1).astype(jnp.float32)
    C, S = _rfft_mats(L)
    xr = x.astype(jnp.float32)
    # HIGHEST precision: reduced-precision matmul inputs (bf16, TF32)
    # quantize density fluctuations and freeze the PDE dynamics
    re = _mm(xr, jnp.asarray(C))
    im = -_mm(xr, jnp.asarray(S))
    return jnp.stack([re, im], axis=-1)


@functools.lru_cache(maxsize=16)
def _rfft_mats_partial(L: int, kmax: int) -> Tuple[np.ndarray, np.ndarray]:
    """Truncated forward matrices — the first ``kmax`` bins only."""
    j = np.arange(L)[:, None]
    k = np.arange(kmax)[None, :]
    ang = 2.0 * np.pi * j * k / L
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def rfft_ri_partial(x: jnp.ndarray, kmax: int,
                    L: Optional[int] = None) -> jnp.ndarray:
    """First ``kmax`` rfft bins of the trailing axis as (..., kmax, 2)
    re/im — identical to ``rfft_ri(x)[..., :kmax, :]`` but against an
    (L, kmax) DFT slab instead of the full (L, L//2+1) matrix.  Use for
    record streams where kmax ≪ L: at L = 8192 the full matrix is a
    ~268 MB program constant; the slab is L·kmax·8 bytes."""
    if L is None:
        L = x.shape[-1]
    kmax = min(kmax, L // 2 + 1)
    if fft_mode() == "native":
        X = jnp.fft.rfft(x, n=L)[..., :kmax]
        return jnp.stack([jnp.real(X), jnp.imag(X)],
                         axis=-1).astype(jnp.float32)
    C, S = _rfft_mats_partial(L, kmax)
    xr = x.astype(jnp.float32)
    re = _mm(xr, jnp.asarray(C))
    im = -_mm(xr, jnp.asarray(S))
    return jnp.stack([re, im], axis=-1)


def irfft_ri(Xri: jnp.ndarray, n: int) -> jnp.ndarray:
    """(..., K, 2) real/imag → real signal of length n (trailing axis)."""
    if fft_mode() == "native":
        X = jax.lax.complex(Xri[..., 0], Xri[..., 1])
        return jnp.fft.irfft(X, n=n)
    A, B = _irfft_mats(n)
    return _mm(Xri[..., 0], jnp.asarray(A)) + _mm(Xri[..., 1], jnp.asarray(B))


def fft_of_real_ri(x: jnp.ndarray) -> jnp.ndarray:
    """Full L-point DFT of a *real* signal as (..., L, 2) real/imag pairs
    (the particle recorder stores the full spectrum,
    PARTICLE_solver_CLASS.py:503)."""
    L = x.shape[-1]
    Xh = rfft_ri(x, L)
    # mirror: F[L-k] = conj(F[k]) for k = 1..ceil(L/2)-1
    body = jnp.flip(Xh[..., 1:(L + 1) // 2, :], axis=-2)
    body = body * jnp.asarray([1.0, -1.0], jnp.float32)
    return jnp.concatenate([Xh, body], axis=-2)


def ri_to_complex(Xri) -> np.ndarray:
    """Host-side view of an ri pair array as complex64."""
    Xri = np.asarray(Xri)
    return (Xri[..., 0] + 1j * Xri[..., 1]).astype(np.complex64)


# complex-returning convenience wrappers (host / CPU use)
def rfft(x: jnp.ndarray, L: Optional[int] = None) -> jnp.ndarray:
    if fft_mode() == "native":
        return jnp.fft.rfft(x, n=L if L is not None else x.shape[-1])
    X = rfft_ri(x, L)
    return jax.lax.complex(X[..., 0], X[..., 1])


def irfft(X: jnp.ndarray, n: int) -> jnp.ndarray:
    if fft_mode() == "native":
        return jnp.fft.irfft(X, n=n)
    Xri = jnp.stack([jnp.real(X), jnp.imag(X)], axis=-1).astype(jnp.float32)
    return irfft_ri(Xri, n)


@functools.lru_cache(maxsize=32)
def _circulant_from_kernel(kernel_bytes: bytes, L: int) -> np.ndarray:
    kernel = np.frombuffer(kernel_bytes, dtype=np.float32)
    j = np.arange(L)
    # y_i = Σ_j kernel[(i-j) mod L] x_j  (circular convolution)
    C = kernel[(j[:, None] - j[None, :]) % L]
    return np.ascontiguousarray(C.T.astype(np.float32))  # x @ C.T^T = x @ Cmat


def circulant_matmul_matrix(kernel: np.ndarray) -> jnp.ndarray:
    """Matrix M with ``conv(x) = x @ M`` equal to circular convolution with
    ``kernel`` on the trailing axis."""
    kernel = np.asarray(kernel, np.float32)
    L = kernel.shape[0]
    return jnp.asarray(_circulant_from_kernel(kernel.tobytes(), L))


def circular_convolve(x: jnp.ndarray, conv_mat: jnp.ndarray) -> jnp.ndarray:
    return _mm(x.astype(jnp.float32), conv_mat)
