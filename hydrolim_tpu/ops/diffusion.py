"""Implicit-diffusion solve operators for the IMEX PDE stepper.

The reference builds ``A = I − γ·dt·D/dx²`` as a sparse CSR matrix and calls
``scipy.sparse.linalg.spsolve`` twice per step
(IMEX_PDE_solver_class.py:68-82, 189-190).  Sparse triangular solves do
not batch; the operator here is constant-coefficient tridiagonal
(+periodic corners or Neumann mirrors), so we diagonalize it instead:

- ``periodic``: circulant ⇒ exact solve in rFFT space (one rfft/irfft pair).
- ``neumann``: the mirrored tridiagonal (D[0,1]=2, D[-1,-2]=2) is the
  restriction of the periodic operator of size 2L−2 acting on the half-sample
  even extension ⇒ exact solve via rFFT of the even extension (a DCT-I
  diagonalization).
- ``dense``: precompute ``A⁻¹`` on host (float64) and apply it as a dense
  matmul — trivially batched; used for cross-validation.

All solves broadcast over leading batch dims and are vmappable in ``γ``.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class DiffusionSolveOp(NamedTuple):
    """Precomputed implicit-diffusion solver ``x ↦ A⁻¹x``.

    Exactly one of ``denom`` (spectral path) / ``a_inv`` (dense path) is used;
    the unused one is a size-0 placeholder so the pytree keeps static
    structure under jit/vmap.  The solver ``kind`` is static config and is
    passed separately to :func:`diffusion_solve`.
    """

    denom: jnp.ndarray   # spectral denominators 1 - γ·dt·λ_k/dx²
    a_inv: jnp.ndarray   # dense inverse (L, L)


def _laplacian_eigs_periodic(M: int) -> np.ndarray:
    k = np.arange(M // 2 + 1)
    return 2.0 * np.cos(2.0 * np.pi * k / M) - 2.0


def build_diffusion_op(L: int, dx: float, dt: float, gamma,
                       bc: str, kind: str) -> DiffusionSolveOp:
    """Build the solve operator.  ``gamma`` may be a python float or a jnp
    scalar (possibly traced/vmapped) on the spectral paths."""
    if kind in ("banded", "banded_dct"):
        # Large-L scale path: the rows of (I − c·D)⁻¹ decay exponentially
        # away from the diagonal (tridiagonal-Toeplitz inverse), so the
        # solve is a narrow banded convolution to float precision — O(L·W)
        # instead of the O(L²) dense/DFT matrix, shardable over a 'space'
        # mesh axis (the conv halo is W/2 sites).  Kernel computed once on
        # host from the circulant symbol at a probe size (L-independent).
        g = float(np.asarray(gamma))
        c = g * dt / dx ** 2
        # kernel radius ~ √c · ln(1/eps); probe size adapts to c
        est_r = int(21.0 * (np.sqrt(max(c, 0.0)) + 1.0))
        M0 = 1 << max(12, int(np.ceil(np.log2(8 * est_r))))
        if M0 > (1 << 20):
            raise ValueError(
                f"banded diffusion kernel radius ~{est_r} too wide "
                f"(c = {c:.3g}); use the spectral solver or rescale dt/dx")
        lam = _laplacian_eigs_periodic(M0)
        k = np.fft.irfft(1.0 / (1.0 - c * lam), n=M0)
        eps = 1e-9 * abs(k[0])
        nz = np.flatnonzero(np.abs(k[:M0 // 2]) >= eps)
        r = int(nz[-1]) if nz.size else 0
        if r >= M0 // 2 - 1:
            raise ValueError(
                f"banded diffusion kernel does not decay within the probe "
                f"(c = {c:.3g} too large); use the spectral solver")
        w = np.concatenate([k[M0 - r:], k[:r + 1]]) if r else k[:1]
        return DiffusionSolveOp(jnp.asarray(w, jnp.float32),
                                jnp.zeros((0, 0), jnp.float32))
    gamma = jnp.asarray(gamma, dtype=jnp.float32)
    if kind == "identity":   # gamma == 0: A = I exactly
        return DiffusionSolveOp(jnp.zeros((0,), jnp.float32),
                                jnp.zeros((0, 0), jnp.float32))
    if kind == "fft":
        assert bc == "periodic"
        lam = jnp.asarray(_laplacian_eigs_periodic(L), dtype=jnp.float32)
        denom = 1.0 - gamma * dt * lam / dx ** 2
        return DiffusionSolveOp(denom, jnp.zeros((0, 0), jnp.float32))
    if kind == "dct":
        assert bc == "neumann"
        M = 2 * L - 2
        lam = jnp.asarray(_laplacian_eigs_periodic(M), dtype=jnp.float32)
        denom = 1.0 - gamma * dt * lam / dx ** 2
        return DiffusionSolveOp(denom, jnp.zeros((0, 0), jnp.float32))
    if kind == "dense":
        g = float(np.asarray(gamma))
        D = np.zeros((L, L), dtype=np.float64)
        idx = np.arange(L)
        D[idx, idx] = -2.0
        D[idx[:-1], idx[:-1] + 1] = 1.0
        D[idx[1:], idx[1:] - 1] = 1.0
        if bc == "periodic":
            D[0, -1] = D[-1, 0] = 1.0
        else:  # neumann mirror (IMEX_PDE_solver_class.py:76-78)
            D[0, 1] = 2.0
            D[-1, -2] = 2.0
        A = np.eye(L) - g * dt * D / dx ** 2
        a_inv = np.linalg.inv(A).astype(np.float32)
        return DiffusionSolveOp(jnp.zeros((0,), jnp.float32), jnp.asarray(a_inv))
    raise ValueError(f"unknown solver kind {kind!r}")


def diffusion_solve(op: DiffusionSolveOp, rho: jnp.ndarray,
                    kind: str) -> jnp.ndarray:
    """Apply ``A⁻¹`` to ``rho`` along the trailing axis (batched).
    ``kind`` is the static solver kind used to build ``op``."""
    from hydrolim_tpu.ops import dft

    if kind == "identity":
        return rho
    if kind in ("banded", "banded_dct"):
        from hydrolim_tpu.ops.convolve import banded_circular_conv

        if kind == "banded_dct":   # Neumann = periodic on the even extension
            x = jnp.concatenate([rho, jnp.flip(rho[..., 1:-1], axis=-1)],
                                axis=-1)
        else:
            x = rho
        y = banded_circular_conv(x, op.denom)
        # The periodic solve has unit DC gain, so it conserves sum(x) (on
        # the even extension for Neumann).  f32 tap sums drop the kernel's
        # sub-ulp tail terms instead: ~-4e-8 of the mass per solve on the
        # GPU, a drift that compounds over thousands of steps.  Restore it.
        y = y * (jnp.sum(x, axis=-1, keepdims=True)
                 / jnp.maximum(jnp.sum(y, axis=-1, keepdims=True), 1e-30))
        return y[..., :rho.shape[-1]]
    if kind == "fft":
        L = rho.shape[-1]
        return dft.irfft_ri(dft.rfft_ri(rho) / op.denom[..., :, None], n=L)
    if kind == "dct":
        L = rho.shape[-1]
        even = jnp.concatenate([rho, jnp.flip(rho[..., 1:-1], axis=-1)], axis=-1)
        sol = dft.irfft_ri(dft.rfft_ri(even) / op.denom[..., :, None],
                           n=2 * L - 2)
        return sol[..., :L]
    if kind == "dense":
        return jnp.einsum("...j,ij->...i", rho, op.a_inv,
                          precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=jnp.float32)
    raise ValueError(f"unknown solver kind {kind!r}")
