"""GMRES and Chebyshev solver tests (bench types the reference declares but
never implements, src/main.c:22,217-222)."""

import numpy as np

import jax

from sparsebench.formats import from_csr
from sparsebench.host import HostCSR, generate_stencil, read_mm
from sparsebench.solvers.chebyshev import solve_chebyshev
from sparsebench.solvers.gmres import solve_gmres

jax.config.update("jax_enable_x64", True)


def test_gmres_solves_spd_stencil():
    csr = generate_stencil(6, 6, 6)
    b = np.random.default_rng(0).standard_normal(csr.nr)
    A = from_csr("sell", csr)
    res = solve_gmres(A, b, itermax=120, eps=1e-10, verbose=False)
    np.testing.assert_allclose(csr.spmv(res.x), b, rtol=0, atol=1e-8)


def test_gmres_solves_nonsymmetric(test_matrices_dir):
    """test0 is non-symmetric — CG can't touch it, GMRES must."""
    csr = HostCSR.from_coo(read_mm(str(test_matrices_dir / "test0.mtx")))
    b = np.arange(1.0, csr.nr + 1)
    A = from_csr("crs", csr)
    res = solve_gmres(A, b, itermax=60, eps=1e-12, restart=10, verbose=False)
    x_ref = np.linalg.solve(csr.to_dense(), b)
    np.testing.assert_allclose(res.x, x_ref, rtol=1e-6, atol=1e-8)


def test_gmres_cgs2_solves_nonsymmetric(test_matrices_dir):
    """CGS2 (reorthogonalized Gram-Schmidt) must solve to the same answer;
    on ill-conditioned bases its explicit orthogonality error is bounded by
    ~machine eps where single-pass CGS degrades (Giraud et al. 2005)."""
    csr = HostCSR.from_coo(read_mm(str(test_matrices_dir / "test0.mtx")))
    b = np.arange(1.0, csr.nr + 1)
    A = from_csr("crs", csr)
    res = solve_gmres(A, b, itermax=60, eps=1e-12, restart=10, orth="cgs2",
                      verbose=False)
    x_ref = np.linalg.solve(csr.to_dense(), b)
    np.testing.assert_allclose(res.x, x_ref, rtol=1e-6, atol=1e-8)


def test_gmres_cgs2_orthogonality_ill_conditioned():
    """Directly measure basis orthogonality on a severely ill-conditioned
    system, where CGS loses digits and CGS2 stays at machine precision."""
    from sparsebench.solvers.gmres import _gmres_cycle

    n = 48
    rng = np.random.default_rng(3)
    # graded diagonal spanning 12 orders of magnitude + small coupling
    D = np.logspace(-6, 6, n)
    Adense = np.diag(D) + 1e-3 * rng.standard_normal((n, n))
    from sparsebench.host.coo import COOMatrix

    rr, cc = np.nonzero(Adense)
    csr = HostCSR.from_coo(
        COOMatrix(row=rr, col=cc, val=Adense[rr, cc], nr=n, nc=n)
    )
    A = from_csr("crs", csr)
    b = np.ones(n)
    import jax.numpy as jnp

    def basis_err(orth):
        m = 24
        # run one cycle and inspect V via the cycle's own internals: redo
        # the arnoldi with the public API by solving and re-measuring is
        # enough — orthogonality shows up in the computed solution error,
        # but measure it directly for a sharp assertion
        from functools import partial

        cyc = jax.jit(partial(
            _gmres_cycle, m=m, exchange=lambda v: v, allsum=lambda v: v,
            spmv=A.spmv, nr=n, nc=n, eps=0.0, orth=orth,
            _return_basis=True,
        ))
        *_, V = cyc(A, jnp.asarray(b), jnp.zeros(n))
        V = np.asarray(V)[: m + 1]
        G = V @ V.T
        return np.abs(G - np.eye(m + 1)).max()

    err_cgs = basis_err("cgs")
    err_cgs2 = basis_err("cgs2")
    assert err_cgs2 < 1e-12
    assert err_cgs2 <= max(err_cgs, 1e-12)


def test_gmres_bad_orth_rejected():
    import pytest

    csr = generate_stencil(3, 3, 3)
    A = from_csr("crs", csr)
    with pytest.raises(ValueError, match="orth"):
        solve_gmres(A, np.ones(csr.nr), orth="mgs", verbose=False)


def test_chebyshev_solves_spd_stencil():
    csr = generate_stencil(6, 6, 6)
    b = np.random.default_rng(1).standard_normal(csr.nr)
    A = from_csr("crs", csr)
    res = solve_chebyshev(A, b, itermax=300, eps=1e-9, verbose=False)
    np.testing.assert_allclose(csr.spmv(res.x), b, rtol=0, atol=1e-6)
    assert res.bounds[0] > 0


def test_chebyshev_with_exact_bounds():
    csr = generate_stencil(4, 4, 4)
    d = csr.to_dense()
    ev = np.linalg.eigvalsh(d)
    b = np.random.default_rng(2).standard_normal(csr.nr)
    A = from_csr("dia", csr)
    res = solve_chebyshev(
        A, b, itermax=250, eps=1e-10, bounds=(float(ev[0]), float(ev[-1])),
        verbose=False,
    )
    np.testing.assert_allclose(csr.spmv(res.x), b, rtol=0, atol=1e-7)


def test_gmres_restart_larger_than_itermax():
    csr = generate_stencil(4, 4, 4)
    b = np.random.default_rng(5).standard_normal(csr.nr)
    A = from_csr("crs", csr)
    # restart capped at itermax (reference-style bounded iterations)
    res = solve_gmres(A, b, itermax=8, eps=0.0, restart=30, verbose=False)
    assert res.iterations <= 8


def test_gmres_exact_iterations_midcycle():
    """A system whose Krylov space is exhausted in n steps must report the
    exact inner-iteration count, not a multiple of the restart length
    (`iters += m` would overcount mid-cycle convergence)."""
    csr = generate_stencil(2, 2, 2)  # n = 8: converges within one m=30 cycle
    b = np.random.default_rng(7).standard_normal(csr.nr)
    A = from_csr("crs", csr)
    res = solve_gmres(A, b, itermax=150, eps=1e-12, restart=30, verbose=False)
    assert res.iterations <= csr.nr  # exact Krylov bound, far below m=30
    assert res.final_normr <= 1e-12
    assert not res.breakdown
    np.testing.assert_allclose(csr.spmv(res.x), b, rtol=0, atol=1e-9)


def test_gmres_one_cycle_exact_count():
    """Converging exactly at a cycle boundary still counts m, not 2m."""
    csr = generate_stencil(2, 2, 1)  # n = 4
    b = np.arange(1.0, 5.0)
    A = from_csr("crs", csr)
    res = solve_gmres(A, b, itermax=100, eps=1e-13, restart=4, verbose=False)
    assert res.iterations <= 4
    assert res.final_normr <= 1e-13


def test_gmres_breakdown_flagged():
    """A singular system must flag breakdown instead of silently patching
    the Hessenberg diagonal."""
    from sparsebench.host.coo import COOMatrix

    # singular: rank-1 matrix, b outside its range
    row = np.array([0, 0, 1, 1])
    col = np.array([0, 1, 0, 1])
    val = np.array([1.0, 1.0, 1.0, 1.0])
    coo = COOMatrix(row=row, col=col, val=val, nr=2, nc=2)
    csr = HostCSR.from_coo(coo)
    A = from_csr("crs", csr)
    b = np.array([1.0, -1.0])  # orthogonal to range(A)
    res = solve_gmres(A, b, itermax=10, eps=1e-14, restart=5, verbose=False)
    assert res.breakdown
    assert np.isfinite(res.x).all()  # last good iterate, not inf/nan


def test_chebyshev_eps_stops_early():
    csr = generate_stencil(5, 5, 5)
    b = np.random.default_rng(6).standard_normal(csr.nr)
    A = from_csr("crs", csr)
    res = solve_chebyshev(A, b, itermax=500, eps=1e-4, verbose=False)
    assert res.iterations < 500
    assert res.final_normr <= 1e-4 * 10  # eps checked on the lagged norm
