"""Jacobi preconditioning for GMRES (right-preconditioned) and Chebyshev
(M^-1 A with weighted-Lanczos bounds) — solvers/gmres.py, chebyshev.py.

Oracles: inv_diag == ones must reproduce the unpreconditioned solver
exactly; on a badly diagonally-scaled SPD system the preconditioned
solver must converge where (or much faster than) the plain one; the
reported residual must equal the TRUE ||b - A x|| (the point of right
preconditioning for GMRES).
"""

import numpy as np
import pytest

import jax

from sparsebench.formats import from_csr
from sparsebench.host import HostCSR, generate_stencil
from sparsebench.solvers.chebyshev import solve_chebyshev
from sparsebench.solvers.gmres import solve_gmres

jax.config.update("jax_enable_x64", True)


def _scaled_spd(nx=6, ny=5, nz=4, seed=2, spread=1.5):
    """27-pt stencil symmetrically rescaled: SPD, condition inflated by
    the diagonal spread — the system Jacobi exists for."""
    csr = generate_stencil(nx, ny, nz)
    rng = np.random.default_rng(seed)
    s = 10.0 ** rng.uniform(-spread, spread, csr.nr)
    rows = np.repeat(np.arange(csr.nr), csr.row_lengths)
    scaled = HostCSR(
        row_ptr=csr.row_ptr, col=csr.col,
        val=csr.val * s[rows] * s[csr.col],
        nr=csr.nr, nc=csr.nc,
    )
    return scaled, rng


# ---------------------------------------------------------------- GMRES

def test_gmres_identity_precond_matches_plain():
    csr = generate_stencil(5, 5, 5)
    A = from_csr("crs", csr)
    b = np.ones(csr.nr)
    plain = solve_gmres(A, b, itermax=40, eps=1e-10, verbose=False)
    pre = solve_gmres(A, b, itermax=40, eps=1e-10,
                      inv_diag=np.ones(csr.nr), verbose=False)
    np.testing.assert_allclose(pre.residual_history, plain.residual_history,
                               rtol=1e-12)
    np.testing.assert_allclose(pre.x, plain.x, rtol=1e-10, atol=1e-12)


def test_gmres_jacobi_beats_plain_on_scaled_system():
    scaled, rng = _scaled_spd()
    A = from_csr("crs", scaled)
    b = rng.standard_normal(scaled.nr)
    inv_diag = 1.0 / scaled.diagonal()
    plain = solve_gmres(A, b, itermax=60, eps=1e-8, restart=30,
                        verbose=False)
    pre = solve_gmres(A, b, itermax=60, eps=1e-8, restart=30,
                      inv_diag=inv_diag, verbose=False)
    assert pre.final_normr < plain.final_normr * 0.5 or (
        pre.final_normr <= 1e-8 and pre.iterations <= plain.iterations
    )


def test_gmres_jacobi_reports_true_residual():
    """Right preconditioning keeps the minimized residual the TRUE one:
    the reported norm must match ||b - A x|| computed independently."""
    scaled, rng = _scaled_spd(5, 5, 4, seed=7)
    A = from_csr("crs", scaled)
    b = rng.standard_normal(scaled.nr)
    inv_diag = 1.0 / scaled.diagonal()
    res = solve_gmres(A, b, itermax=30, eps=0.0, restart=30,
                      inv_diag=inv_diag, verbose=False)
    dense = scaled.to_dense()
    true_norm = np.linalg.norm(b - dense @ res.x)
    np.testing.assert_allclose(res.final_normr, true_norm,
                               rtol=1e-6, atol=1e-10 * np.linalg.norm(b))


def test_gmres_jacobi_solution_correct():
    scaled, rng = _scaled_spd(5, 4, 4, seed=11)
    A = from_csr("crs", scaled)
    xe = rng.standard_normal(scaled.nr)
    dense = scaled.to_dense()
    b = dense @ xe
    res = solve_gmres(A, b, itermax=150, eps=1e-10 * np.linalg.norm(b),
                      inv_diag=1.0 / scaled.diagonal(), verbose=False)
    assert np.abs(res.x - xe).max() < 1e-6 * np.abs(xe).max()


# ------------------------------------------------------------ Chebyshev

def test_cheby_converges_when_lmin_much_below_lmax():
    """Regression: a problem large enough that the Ritz lmin << lmax.
    The old additive solver margin (lmin - 0.1*spread, floored at
    1e-8*lmax) produced an interval of effective condition ~1e8 here and
    the standalone solver STAGNATED (24^3 was enough to trigger it; at
    the benched 100^3 the residual sat at 1.8e+03 after 150 iters).
    Multiplicative margins must recover full convergence."""
    csr = generate_stencil(24, 24, 24)
    A = from_csr("crs", csr)
    counts = np.diff(csr.row_ptr)
    b = (27.0 - (counts - 1)).astype(np.float64)
    res = solve_chebyshev(A, b, itermax=150, eps=0.0, verbose=False)
    lmin, lmax = res.bounds
    assert lmin > 1e-3 * lmax  # margin no longer collapses the interval
    assert res.final_normr < 1e-8 * res.residual_history[0]
    assert np.abs(np.asarray(res.x) - 1.0).max() < 1e-6


def test_cheby_identity_precond_matches_plain():
    csr = generate_stencil(5, 5, 5)
    A = from_csr("crs", csr)
    b = np.ones(csr.nr)
    plain = solve_chebyshev(A, b, itermax=60, eps=1e-8, verbose=False)
    pre = solve_chebyshev(A, b, itermax=60, eps=1e-8,
                          inv_diag=np.ones(csr.nr), verbose=False)
    # same operator; bounds come from the same seeded Lanczos
    np.testing.assert_allclose(pre.bounds, plain.bounds, rtol=1e-8)
    n = min(len(pre.residual_history), len(plain.residual_history))
    np.testing.assert_allclose(pre.residual_history[:n],
                               plain.residual_history[:n], rtol=1e-9)


def test_cheby_jacobi_converges_on_scaled_system():
    """On the badly-scaled system plain Chebyshev's interval is inflated
    by the diagonal spread; Jacobi restores stencil-like conditioning."""
    scaled, rng = _scaled_spd(6, 5, 4, seed=5, spread=1.0)
    A = from_csr("crs", scaled)
    xe = rng.standard_normal(scaled.nr)
    dense = scaled.to_dense()
    b = dense @ xe
    inv_diag = 1.0 / scaled.diagonal()
    pre = solve_chebyshev(A, b, itermax=400, eps=1e-8 * np.linalg.norm(b),
                          inv_diag=inv_diag, verbose=False)
    plain = solve_chebyshev(A, b, itermax=400, eps=1e-8 * np.linalg.norm(b),
                            verbose=False)
    assert np.abs(pre.x - xe).max() < 1e-5 * np.abs(xe).max()
    # conditioning win: strictly fewer iterations (usually several-fold)
    assert pre.iterations < plain.iterations


def test_cheby_jacobi_bounds_are_preconditioned_spectrum():
    """With Jacobi, [lmin, lmax] must bracket spec(M^-1 A), not spec(A):
    for the unit stencil M^-1 A has spectrum in (0, 2) regardless of the
    diagonal scaling that inflates spec(A)."""
    scaled, _rng = _scaled_spd(5, 5, 4, seed=9)
    A = from_csr("crs", scaled)
    b = np.ones(scaled.nr)
    inv_diag = 1.0 / scaled.diagonal()
    res = solve_chebyshev(A, b, itermax=5, eps=0.0, inv_diag=inv_diag,
                          verbose=False)
    lmin, lmax = res.bounds
    dense = scaled.to_dense()
    ev = np.linalg.eigvalsh(np.diag(inv_diag ** 0.5) @ dense
                            @ np.diag(inv_diag ** 0.5))
    assert lmax >= ev[-1] * 0.99
    assert lmin <= ev[0] * 1.5 + 1e-9
    assert lmax < ev[-1] * 1.3  # bracket is tight-ish, not spec(A)-sized


# ----------------------------------------------------------- distributed

@pytest.fixture(scope="module")
def dist_pair():
    from sparsebench.parallel.dist import build_distributed
    from sparsebench.parallel.partition import slice_coo_rows

    scaled, rng = _scaled_spd(4, 4, 4, seed=13)
    rows = np.repeat(np.arange(scaled.nr, dtype=np.int64),
                     scaled.row_lengths)
    from sparsebench.host.coo import COOMatrix

    coo = COOMatrix(row=rows, col=scaled.col, val=scaled.val,
                    nr=scaled.nr, nc=scaled.nc)
    shards = [HostCSR.from_coo(slice_coo_rows(coo, r, 4)) for r in range(4)]
    dm = build_distributed(shards, fmt="crs")
    b = rng.standard_normal(scaled.nr)
    return scaled, dm, b


def test_dist_gmres_jacobi_matches_serial(dist_pair):
    from sparsebench.parallel.dist import dist_solve_gmres

    scaled, dm, b = dist_pair
    inv_diag = 1.0 / scaled.diagonal()
    serial = solve_gmres(from_csr("crs", scaled), b, itermax=25, eps=0.0,
                         inv_diag=inv_diag, verbose=False)
    dist = dist_solve_gmres(dm, b, itermax=25, eps=0.0, inv_diag=inv_diag,
                            verbose=False)
    n = min(len(serial.residual_history), len(dist.residual_history))
    np.testing.assert_allclose(dist.residual_history[:n],
                               serial.residual_history[:n],
                               rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(dist.x, serial.x, rtol=1e-6, atol=1e-9)


def test_dist_cheby_jacobi_matches_serial(dist_pair):
    from sparsebench.parallel.dist import dist_solve_chebyshev

    scaled, dm, b = dist_pair
    inv_diag = 1.0 / scaled.diagonal()
    serial = solve_chebyshev(from_csr("crs", scaled), b, itermax=40,
                             eps=0.0, inv_diag=inv_diag, verbose=False)
    dist = dist_solve_chebyshev(dm, b, itermax=40, eps=0.0,
                                inv_diag=inv_diag, verbose=False)
    # both estimate bounds via their own seeded Lanczos (same seed, same
    # operator); the recurrences then match to rounding
    np.testing.assert_allclose(dist.bounds, serial.bounds, rtol=1e-6)
    n = min(len(serial.residual_history), len(dist.residual_history))
    np.testing.assert_allclose(dist.residual_history[:n],
                               serial.residual_history[:n],
                               rtol=1e-7, atol=1e-12 * serial.residual_history[0])
