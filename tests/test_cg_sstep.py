"""s-step (communication-avoiding) CG tests (solvers/cg_sstep.py).

Oracle: standard CG on the same system. In exact arithmetic s-step CG
reproduces the CG iterates at outer-step boundaries; in f64 on small
well-conditioned systems the residual trajectory must track standard
CG's closely and the solution must converge to the exact one.
"""

import numpy as np
import pytest

import jax

from sparsebench.formats import from_csr
from sparsebench.host import HostCSR, generate_stencil
from sparsebench.solvers.cg import check_residual, init_vectors, solve_cg

jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("s", [1, 2, 4])
def test_sstep_converges_to_exact(s):
    csr = generate_stencil(8, 8, 8)
    _x0, b, xexact = init_vectors(csr)
    A = from_csr("crs", csr)
    res = solve_cg(A, b, itermax=200, eps=1e-9, variant="sstep", sstep=s,
                   verbose=False)
    err = check_residual(res.x, xexact)
    assert err < 1e-7, f"s={s}: max|x - 1| = {err}"
    assert res.final_normr <= 1e-9


def test_sstep_matches_standard_cg_trajectory():
    """Residuals at outer-step boundaries equal standard CG's at the same
    iteration index (same Krylov iterates), to f64 rounding on a
    well-conditioned stencil system."""
    csr = generate_stencil(7, 6, 5)
    _x0, b, xexact = init_vectors(csr)
    A = from_csr("crs", csr)
    s = 4
    std = solve_cg(A, b, itermax=41, eps=0.0, verbose=False)
    ca = solve_cg(A, b, itermax=41, eps=0.0, variant="sstep", sstep=s,
                  verbose=False)
    hist = ca.residual_history
    # boundaries: k = 1, 1+s, 1+2s, ... (hist slots in between are NaN).
    # Compare down to 1e-9 relative residual: below that, s-step's
    # attainable accuracy diverges from CG's (known finite-precision
    # property of monomial-basis s-step methods) — the convergence tests
    # cover that regime.
    floor = 1e-9 * std.residual_history[0]
    for k in range(1, min(len(hist), len(std.residual_history)), s):
        assert not np.isnan(hist[k])
        if std.residual_history[k] < floor:
            break
        np.testing.assert_allclose(
            hist[k], std.residual_history[k],
            rtol=1e-6, atol=floor,
        )
    # the in-between slots really are skipped (not silently filled)
    if s > 1:
        assert np.isnan(hist[2])
    assert check_residual(ca.x, xexact) < 1e-7


def test_sstep_s1_matches_standard_cg():
    """s=1 is mathematically plain CG with gram-based scalars."""
    csr = generate_stencil(6, 6, 6)
    _x0, b, _ = init_vectors(csr)
    A = from_csr("dia", csr)
    std = solve_cg(A, b, itermax=30, eps=0.0, verbose=False)
    ca = solve_cg(A, b, itermax=30, eps=0.0, variant="sstep", sstep=1,
                  verbose=False)
    n = min(len(std.residual_history), len(ca.residual_history))
    np.testing.assert_allclose(
        ca.residual_history[:n], std.residual_history[:n],
        rtol=1e-8, atol=1e-13 * std.residual_history[0],
    )


def test_sstep_jacobi_matches_standard_pcg():
    """Preconditioned s-step (M-inner-product formulation) tracks the
    standard Jacobi-PCG trajectory on a badly diagonally-scaled system."""
    csr = generate_stencil(6, 5, 4)
    rng = np.random.default_rng(3)
    sc = 10.0 ** rng.uniform(-1.5, 1.5, csr.nr)
    rows = np.repeat(np.arange(csr.nr), csr.row_lengths)
    scaled = HostCSR(
        row_ptr=csr.row_ptr, col=csr.col,
        val=csr.val * sc[rows] * sc[csr.col],
        nr=csr.nr, nc=csr.nc,
    )
    A = from_csr("crs", scaled)
    b = rng.standard_normal(csr.nr)
    inv_diag = 1.0 / scaled.diagonal()
    s = 4
    std = solve_cg(A, b, itermax=41, inv_diag=inv_diag, verbose=False)
    ca = solve_cg(A, b, itermax=41, inv_diag=inv_diag, variant="sstep",
                  sstep=s, verbose=False)
    hist = ca.residual_history
    # comparison floor at 1e-6 relative: the badly-scaled system has a
    # worse-conditioned monomial basis, so trajectory parity holds to a
    # correspondingly shallower depth (see the unpreconditioned test)
    floor = 1e-6 * std.residual_history[0]
    for k in range(1, min(len(hist), len(std.residual_history)), s):
        if std.residual_history[k] < floor:
            break
        np.testing.assert_allclose(
            hist[k], std.residual_history[k], rtol=1e-5, atol=floor,
        )


def test_sstep_breakdown_guard_no_nans():
    """Past machine-zero residual the s x s system collapses; the guard
    must freeze the converged state instead of poisoning x with NaN
    (cg_run's breakdown guard, one level up)."""
    csr = generate_stencil(5, 5, 5)
    _x0, b, xexact = init_vectors(csr)
    A = from_csr("crs", csr)
    res = solve_cg(A, b, itermax=400, eps=0.0, variant="sstep", sstep=4,
                   verbose=False)
    assert np.all(np.isfinite(res.x))
    assert check_residual(res.x, xexact) < 1e-7


def test_sstep_permuted_format():
    """Row-permuting formats (SELL-C-sigma) work through the same
    permute-once wrapper as the other variants."""
    csr = generate_stencil(6, 5, 4)
    _x0, b, xexact = init_vectors(csr)
    A = from_csr("sell", csr, chunk_height=4, sigma=0)
    res = solve_cg(A, b, itermax=200, eps=1e-9, variant="sstep", sstep=2,
                   verbose=False)
    assert check_residual(res.x, xexact) < 1e-7


def test_sstep_f32_converges():
    """f32 + Chebyshev basis: s=4 converges on the generated problem.
    A scaled MONOMIAL basis passed this at 8^3 but DIVERGED at the
    reference's 100^3 workload on the real chip (residual 2.6e3 -> 4e6)
    — so this test uses the largest stencil cheap enough for CI and the
    chip bench covers the real size."""
    csr = generate_stencil(20, 20, 20, dtype=np.float32)
    _x0, b, xexact = init_vectors(csr, dtype=np.float32)
    A = from_csr("crs", csr)
    res = solve_cg(A, b, itermax=200, eps=1e-4, variant="sstep", sstep=4,
                   verbose=False)
    assert check_residual(res.x, xexact) < 1e-3
    # the residual trajectory must be non-divergent throughout
    h = res.residual_history
    assert np.nanmin(h) <= 1e-4 or h[-1] < h[0]
    assert np.nanmax(h[1:]) < 10 * h[0]


def test_sstep_f32_drift_bounded_past_convergence():
    """Running far past convergence in f32 (eps=0) must NOT drift the
    residual upward unbounded: the drift-triggered residual replacement
    caps it near the attainable floor (measured unrepaired drift on the
    chip at 100^3: 1.2 -> 26 over 100 post-floor iterations)."""
    csr = generate_stencil(16, 16, 16, dtype=np.float32)
    _x0, b, xexact = init_vectors(csr, dtype=np.float32)
    A = from_csr("crs", csr)
    res = solve_cg(A, b, itermax=300, eps=0.0, variant="sstep", sstep=4,
                   verbose=False)
    h = res.residual_history
    # repaired runs hover near the f32 floor (~1e-7 relative, measured);
    # the unrepaired recurrence drifted to ~1e-2 relative — 5 orders up
    assert res.final_normr < 1e-5 * h[0]
    assert check_residual(res.x, xexact) < 1e-4


def test_sstep_rejects_bad_s():
    csr = generate_stencil(4, 4, 4)
    A = from_csr("crs", csr)
    b = np.ones(csr.nr)
    with pytest.raises(ValueError, match="s must be"):
        solve_cg(A, b, variant="sstep", sstep=0, verbose=False)
