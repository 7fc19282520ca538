"""Unit tests for the small-matrix linalg primitives the hot paths use.

The GEMM-based helpers of ``utils/linalg.py`` (SPD solves replacing
LU/TriangularSolve sweeps, Gram-whitening re-orthonormalization
replacing QR in power-iteration intermediates) and the
precision-parameterized Gram product (``ops/qr_panel.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dmd_era5_tpu.utils.linalg import (
    complex_lstsq,
    complex_solve,
    orth_small,
    spd_solve,
)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _spd(rng, n, cond=1e4):
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.logspace(0, -np.log10(cond), n)
    return (q * d) @ q.T


def test_spd_solve_matches_numpy(rng):
    a = _spd(rng, 24).astype(np.float32)
    b = rng.standard_normal((24, 5)).astype(np.float32)
    x = np.asarray(spd_solve(jnp.asarray(a), jnp.asarray(b)))
    x_ref = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    assert np.allclose(x, x_ref, rtol=0, atol=1e-3 * np.abs(x_ref).max())


def test_spd_solve_batched(rng):
    a = np.stack([_spd(rng, 12) for _ in range(4)]).astype(np.float32)
    b = rng.standard_normal((4, 12, 3)).astype(np.float32)
    x = np.asarray(spd_solve(jnp.asarray(a), jnp.asarray(b)))
    for i in range(4):
        x_ref = np.linalg.solve(a[i], b[i])
        assert np.allclose(x[i], x_ref, atol=1e-3 * np.abs(x_ref).max())


def test_orth_small_orthonormal_and_same_subspace(rng):
    z = rng.standard_normal((200, 16)).astype(np.float32)
    # skew the conditioning a bit — the regime of power-iteration
    # intermediates after one multiply by X^T X
    z[:, :4] *= 50.0
    q = np.asarray(orth_small(jnp.asarray(z)))
    assert np.allclose(q.T @ q, np.eye(16), atol=5e-5)
    # same column space: projection of Z onto span(Q) reproduces Z
    assert np.allclose(q @ (q.T @ z), z, atol=1e-3 * np.abs(z).max())


def test_complex_solve_hpd_flag_matches_general(rng):
    n = 10
    m = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    a = (m @ m.conj().T + n * np.eye(n)).astype(np.complex64)
    b = (rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3))).astype(
        np.complex64
    )
    x_gen = np.asarray(complex_solve(jnp.asarray(a), jnp.asarray(b)))
    x_hpd = np.asarray(complex_solve(jnp.asarray(a), jnp.asarray(b), hpd=True))
    x_ref = np.linalg.solve(a.astype(np.complex128), b.astype(np.complex128))
    scale = np.abs(x_ref).max()
    assert np.allclose(x_gen, x_ref, atol=1e-4 * scale)
    assert np.allclose(x_hpd, x_ref, atol=1e-4 * scale)


def test_complex_lstsq_overdetermined(rng):
    a = (rng.standard_normal((40, 6)) + 1j * rng.standard_normal((40, 6))).astype(
        np.complex64
    )
    x_true = (rng.standard_normal(6) + 1j * rng.standard_normal(6)).astype(
        np.complex64
    )
    b = a @ x_true
    x = np.asarray(complex_lstsq(jnp.asarray(a), jnp.asarray(b)))
    assert np.allclose(x, x_true, atol=1e-3)


@pytest.mark.parametrize("precision", ["HIGHEST", "bf16_split"])
def test_pallas_gram_precision_option(rng, precision):
    from dmd_era5_tpu.ops.qr_panel import gram

    a = rng.standard_normal((300, 32)).astype(np.float32)
    p = precision if precision == "bf16_split" else getattr(
        jax.lax.Precision, precision
    )
    g = np.asarray(gram(jnp.asarray(a), precision=p))
    g_ref = (a.astype(np.float64).T @ a.astype(np.float64)).astype(np.float32)
    # the split Gram's hi/lo arithmetic runs as written on the CPU too,
    # so its ~1e-6 error model is exercised here
    tol = 1e-5 if precision == "HIGHEST" else 3e-5
    assert np.allclose(g, g_ref, rtol=0, atol=tol * np.abs(g_ref).max())


def test_exact_gram_route_split_precision(rng):
    from dmd_era5_tpu.ops.svd import exact_truncated_svd_gram

    x = rng.standard_normal((512, 48)).astype(np.float32)
    u0, s0, vt0 = np.linalg.svd(x, full_matrices=False)
    res = exact_truncated_svd_gram(
        jnp.asarray(x), 8, gram_precision="bf16_split"
    )
    # Rayleigh-Ritz restores f32-level values from the split subspace
    assert np.allclose(np.asarray(res.s), s0[:8], rtol=1e-5)
    ov = u0[:, :8].T @ np.asarray(res.U, np.float64)
    assert np.linalg.svd(ov)[1].min() > 1 - 1e-6
