"""Matmul-DFT ops vs numpy.fft ground truth."""
import numpy as np
import jax.numpy as jnp

from hydrolim_tpu.ops import dft


def test_rfft_matches_numpy():
    rng = np.random.default_rng(0)
    for L in (8, 9, 100):
        x = rng.normal(size=L).astype(np.float32)
        ours = np.asarray(dft.rfft(jnp.asarray(x)))
        ref = np.fft.rfft(x)
        np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


def test_irfft_roundtrip():
    rng = np.random.default_rng(1)
    for L in (8, 9, 64):
        x = rng.normal(size=L).astype(np.float32)
        back = np.asarray(dft.irfft(dft.rfft(jnp.asarray(x)), n=L))
        np.testing.assert_allclose(back, x, rtol=1e-4, atol=1e-5)


def test_fft_of_real_matches_numpy():
    rng = np.random.default_rng(2)
    for L in (8, 9, 50):
        x = rng.normal(size=L).astype(np.float32)
        ours = dft.ri_to_complex(dft.fft_of_real_ri(jnp.asarray(x)))
        ref = np.fft.fft(x)
        np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-4)


def test_rfft_ri_matches_numpy():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 24)).astype(np.float32)
    ours = dft.ri_to_complex(dft.rfft_ri(jnp.asarray(x)))
    np.testing.assert_allclose(ours, np.fft.rfft(x, axis=-1), rtol=1e-4,
                               atol=1e-4)
    back = np.asarray(dft.irfft_ri(dft.rfft_ri(jnp.asarray(x)), n=24))
    np.testing.assert_allclose(back, x, rtol=1e-4, atol=1e-5)


def test_circulant_matmul_is_circular_conv():
    rng = np.random.default_rng(3)
    L = 32
    x = rng.normal(size=L).astype(np.float32)
    k = rng.random(L).astype(np.float32)
    k /= k.sum()
    M = dft.circulant_matmul_matrix(k)
    ours = np.asarray(dft.circular_convolve(jnp.asarray(x), M))
    ref = np.real(np.fft.ifft(np.fft.fft(x) * np.fft.fft(k)))
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


def test_batched():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 16)).astype(np.float32)
    ours = np.asarray(dft.rfft(jnp.asarray(x)))
    np.testing.assert_allclose(ours, np.fft.rfft(x, axis=-1), rtol=1e-4,
                               atol=1e-4)


def test_rfft_ri_partial_matches_full():
    """Truncated-slab rfft equals the full transform's first kmax bins
    (the record-stream form: at L=8192 the full DFT matrix is a ~268 MB
    program constant that oversized remote-compile payloads)."""
    import numpy as np
    from hydrolim_tpu.ops import dft

    rng = np.random.default_rng(0)
    x = rng.random((3, 96)).astype(np.float32)
    kmax = 7
    got = np.asarray(dft.rfft_ri_partial(x, kmax))
    want = np.asarray(dft.rfft_ri(x))[:, :kmax]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # kmax clamped to the hermitian length
    assert dft.rfft_ri_partial(x, 1000).shape == (3, 49, 2)
