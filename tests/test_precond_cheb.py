"""Chebyshev polynomial preconditioning (solvers/precond.py) — operator
PCG for the standard and cs CG variants, serial + distributed + CLI.

Oracles: the scalar spectral map 1 - q(x) = x * p_k(x) must stay in
(0, 2) on [lmin, lmax] and in (0, 1) below lmin (SPD-ness of M, the
property that makes underestimated lmin safe); PCG must converge in far
fewer iterations than plain CG at the same tolerance with the TRUE
residual matching; distributed runs must match serial to rounding.
"""

import numpy as np
import pytest

import jax

from sparsebench.formats import from_csr
from sparsebench.host import generate_stencil
from sparsebench.solvers.cg import solve_cg
from sparsebench.solvers.chebyshev import bounds_from_tridiag
from sparsebench.solvers.precond import ChebPrecond, cheb_precond_for

jax.config.update("jax_enable_x64", True)


def _true_residual(A, x, b):
    import jax.numpy as jnp

    return float(np.linalg.norm(b - np.asarray(A.spmv(jnp.asarray(x)))))


# ------------------------------------------------------------ polynomial

@pytest.mark.parametrize("degree", [1, 2, 3, 5])
def test_spectral_map_positive(degree):
    """1 - q(x) in (0, 2] on [lmin, lmax] and (0, 1) on (0, lmin):
    M = p_k(A) stays SPD even when lmin overestimates the true minimum."""
    lmin, lmax = 1.5, 40.0
    pc = ChebPrecond(lmin, lmax, degree=degree)
    inside = np.linspace(lmin, lmax, 60)
    below = np.linspace(lmin * 1e-6, lmin * 0.999, 20)
    for x in inside:
        m = float(pc.apply(lambda v: x * v, np.ones(1))[0]) * x
        assert 0.0 < m <= 2.0 + 1e-12, (x, m)
    for x in below:
        m = float(pc.apply(lambda v: x * v, np.ones(1))[0]) * x
        assert 0.0 < m < 1.0, (x, m)


def test_precond_bounds_mode_tight():
    """Both modes take MULTIPLICATIVE haircuts on the Ritz lmin (0.9x
    precond, 0.5x solver) — neither may collapse it toward zero, which is
    what the old additive solver widening (lmin - 0.1*spread, floored at
    1e-8*lmax) did for any lmin << lmax, stalling the standalone solver
    at effective condition ~1e8."""
    alphas = np.array([2.0, 20.0, 38.0])
    betas = np.array([0.5, 0.5, 0.0])
    ls, us = bounds_from_tridiag(alphas, betas, 3, mode="solver")
    lp, up = bounds_from_tridiag(alphas, betas, 3, mode="precond")
    ritz_lmin = 2.0 - 0.5  # < ev[0] of this tridiagonal < alphas[0]
    assert lp > ls > 0.25 * ritz_lmin  # no collapse in either mode
    assert lp == pytest.approx(ls * 0.9 / 0.5)  # 0.9x vs 0.5x haircut
    assert up > us > 0


def test_chebprecond_validates():
    with pytest.raises(ValueError):
        ChebPrecond(1.0, 40.0, degree=0)
    with pytest.raises(ValueError):
        ChebPrecond(-1.0, 40.0, degree=3)
    with pytest.raises(ValueError):
        ChebPrecond(5.0, 4.0, degree=3)


# ------------------------------------------------------------ serial PCG

def test_cheb_pcg_beats_plain():
    csr = generate_stencil(16, 16, 16)
    A = from_csr("crs", csr)
    b = np.random.default_rng(0).standard_normal(csr.nr)
    plain = solve_cg(A, b, itermax=400, eps=1e-8, verbose=False)
    pc = cheb_precond_for(A, csr.nr, np.float64, degree=3)
    pre = solve_cg(A, b, itermax=400, eps=1e-8, precond=pc, verbose=False)
    assert pre.iterations < plain.iterations / 2
    assert _true_residual(A, pre.x, b) < 1e-7
    np.testing.assert_allclose(pre.x, plain.x, rtol=1e-6, atol=1e-9)


def test_cheb_pcg_cs_matches_standard():
    csr = generate_stencil(12, 12, 12)
    A = from_csr("crs", csr)
    b = np.random.default_rng(1).standard_normal(csr.nr)
    pc = cheb_precond_for(A, csr.nr, np.float64, degree=2)
    std = solve_cg(A, b, itermax=300, eps=1e-9, precond=pc, verbose=False)
    cs = solve_cg(A, b, itermax=300, eps=1e-9, precond=pc, variant="cs",
                  verbose=False)
    assert abs(std.iterations - cs.iterations) <= 1
    np.testing.assert_allclose(cs.x, std.x, rtol=1e-8, atol=1e-12)


def test_cheb_jacobi_on_scaled_system():
    """Scaled polynomial (precond + inv_diag): on a badly diagonally
    scaled SPD system it must beat BOTH plain CG and pure Jacobi PCG."""
    from sparsebench.host import HostCSR

    csr = generate_stencil(8, 8, 8)
    rng = np.random.default_rng(2)
    s = 10.0 ** rng.uniform(-1.5, 1.5, csr.nr)
    rows = np.repeat(np.arange(csr.nr), csr.row_lengths)
    scaled = HostCSR(row_ptr=csr.row_ptr, col=csr.col,
                     val=csr.val * s[rows] * s[csr.col],
                     nr=csr.nr, nc=csr.nc)
    A = from_csr("crs", scaled)
    b = rng.standard_normal(scaled.nr)
    inv_diag = 1.0 / scaled.diagonal()
    jac = solve_cg(A, b, itermax=800, eps=1e-8, inv_diag=inv_diag,
                   verbose=False)
    pc = cheb_precond_for(A, scaled.nr, np.float64, degree=3,
                          inv_diag=inv_diag)
    pre = solve_cg(A, b, itermax=800, eps=1e-8, inv_diag=inv_diag,
                   precond=pc, verbose=False)
    # small well-conditioned system: Jacobi alone needs ~25 iterations,
    # so the polynomial's multiplier is modest here — require a solid
    # reduction, not the asymptotic (degree+1)-fold one
    assert pre.iterations < jac.iterations * 0.7
    assert _true_residual(A, pre.x, b) < 1e-7


def test_cheb_pcg_rejects_sstep():
    csr = generate_stencil(6, 6, 6)
    A = from_csr("crs", csr)
    b = np.ones(csr.nr)
    pc = ChebPrecond(1.0, 40.0, degree=2)
    with pytest.raises(ValueError, match="standard"):
        solve_cg(A, b, itermax=10, precond=pc, variant="sstep",
                 verbose=False)


def test_cheb_pcg_pipe_matches_standard():
    """Preconditioned pipelined CG (Ghysels-Vanroose Alg. 4 r-space
    form): same Krylov iterates as standard polynomial PCG in exact
    arithmetic — trajectories match to rounding in f64."""
    csr = generate_stencil(12, 12, 12)
    A = from_csr("crs", csr)
    b = np.random.default_rng(10).standard_normal(csr.nr)
    pc = cheb_precond_for(A, csr.nr, np.float64, degree=3)
    std = solve_cg(A, b, itermax=300, eps=1e-9, precond=pc, verbose=False)
    pipe = solve_cg(A, b, itermax=300, eps=1e-9, precond=pc,
                    variant="pipe", verbose=False)
    assert abs(std.iterations - pipe.iterations) <= 1
    np.testing.assert_allclose(pipe.x, std.x, rtol=1e-7, atol=1e-11)
    n = min(len(std.residual_history), len(pipe.residual_history))
    np.testing.assert_allclose(pipe.residual_history[:n],
                               std.residual_history[:n],
                               rtol=1e-6, atol=1e-12)


def test_cheb_jacobi_pipe_scaled_system():
    """Scaled polynomial + pipe on a badly scaled system: the drift
    repair keeps the recurrence honest; solution matches standard."""
    from sparsebench.host import HostCSR

    csr = generate_stencil(8, 8, 8)
    rng = np.random.default_rng(11)
    s = 10.0 ** rng.uniform(-1.5, 1.5, csr.nr)
    rows = np.repeat(np.arange(csr.nr), csr.row_lengths)
    scaled = HostCSR(row_ptr=csr.row_ptr, col=csr.col,
                     val=csr.val * s[rows] * s[csr.col],
                     nr=csr.nr, nc=csr.nc)
    A = from_csr("crs", scaled)
    b = rng.standard_normal(scaled.nr)
    inv_diag = 1.0 / scaled.diagonal()
    pc = cheb_precond_for(A, scaled.nr, np.float64, degree=3,
                          inv_diag=inv_diag)
    std = solve_cg(A, b, itermax=400, eps=1e-9, inv_diag=inv_diag,
                   precond=pc, verbose=False)
    pipe = solve_cg(A, b, itermax=400, eps=1e-9, inv_diag=inv_diag,
                    precond=pc, variant="pipe", verbose=False)
    assert _true_residual(A, pipe.x, b) < 1e-7
    np.testing.assert_allclose(pipe.x, std.x, rtol=1e-6, atol=1e-10)


def test_cheb_pcg_permuted_format():
    """Row-permuting format (sell): bounds estimated in permuted space,
    solve handles the permutation — result must match the crs run."""
    csr = generate_stencil(10, 10, 10)
    b = np.random.default_rng(3).standard_normal(csr.nr)
    ref = solve_cg(from_csr("crs", csr), b, itermax=300, eps=1e-9,
                   verbose=False)
    A = from_csr("sell", csr, chunk_height=8, sigma=16)
    permute = (A.permute_vector
               if getattr(A, "permuted_output", False) else None)
    pc = cheb_precond_for(A, csr.nr, np.float64, degree=3, permute=permute)
    pre = solve_cg(A, b, itermax=300, eps=1e-9, precond=pc, verbose=False)
    np.testing.assert_allclose(pre.x, ref.x, rtol=1e-6, atol=1e-9)


# ------------------------------------------------ GMRES / BiCGStab serial

def test_cheb_gmres_beats_plain():
    """Right polynomial preconditioning for GMRES: the Arnoldi operator is
    A p_k(A) — fixed, so plain GMRES theory applies — and the reported
    norm stays the TRUE residual."""
    from sparsebench.solvers.gmres import solve_gmres

    csr = generate_stencil(10, 10, 10)
    A = from_csr("crs", csr)
    b = np.random.default_rng(6).standard_normal(csr.nr)
    plain = solve_gmres(A, b, itermax=200, eps=1e-8, verbose=False)
    pc = cheb_precond_for(A, csr.nr, np.float64, degree=3)
    pre = solve_gmres(A, b, itermax=200, eps=1e-8, precond=pc,
                      verbose=False)
    assert pre.final_normr <= 1e-8
    assert pre.iterations < plain.iterations / 2
    np.testing.assert_allclose(
        pre.final_normr, _true_residual(A, pre.x, b),
        rtol=1e-6, atol=1e-10 * np.linalg.norm(b))


def test_cheb_jacobi_gmres_scaled_system():
    """Scaled polynomial (cheb-jacobi) for GMRES on a badly diagonally
    scaled SPD system: solution correct, beats pure Jacobi."""
    from sparsebench.host import HostCSR
    from sparsebench.solvers.gmres import solve_gmres

    csr = generate_stencil(7, 6, 5)
    rng = np.random.default_rng(7)
    s = 10.0 ** rng.uniform(-1.5, 1.5, csr.nr)
    rows = np.repeat(np.arange(csr.nr), csr.row_lengths)
    scaled = HostCSR(row_ptr=csr.row_ptr, col=csr.col,
                     val=csr.val * s[rows] * s[csr.col],
                     nr=csr.nr, nc=csr.nc)
    A = from_csr("crs", scaled)
    xe = rng.standard_normal(scaled.nr)
    b = np.asarray(scaled.to_dense() @ xe)
    inv_diag = 1.0 / scaled.diagonal()
    tol = 1e-9 * np.linalg.norm(b)
    jac = solve_gmres(A, b, itermax=200, eps=tol, inv_diag=inv_diag,
                      verbose=False)
    pc = cheb_precond_for(A, scaled.nr, np.float64, degree=3,
                          inv_diag=inv_diag)
    pre = solve_gmres(A, b, itermax=200, eps=tol, inv_diag=inv_diag,
                      precond=pc, verbose=False)
    assert pre.iterations < jac.iterations
    assert np.abs(pre.x - xe).max() < 1e-6 * np.abs(xe).max()


def test_cheb_bicgstab_beats_plain():
    from sparsebench.solvers.bicgstab import solve_bicgstab

    csr = generate_stencil(10, 10, 10)
    A = from_csr("crs", csr)
    rng = np.random.default_rng(8)
    xe = rng.standard_normal(csr.nr)
    b = np.asarray(A.spmv(np.asarray(xe)))
    plain = solve_bicgstab(A, b, itermax=200, eps=1e-8, verbose=False)
    pc = cheb_precond_for(A, csr.nr, np.float64, degree=3)
    pre = solve_bicgstab(A, b, itermax=200, eps=1e-8, precond=pc,
                         verbose=False)
    assert pre.iterations < plain.iterations / 2
    assert _true_residual(A, pre.x, b) < 1e-7
    assert np.abs(pre.x - xe).max() < 1e-6 * np.abs(xe).max()


# ------------------------------------------------------- distributed PCG

def test_dist_cheb_pcg_parity():
    from sparsebench.parallel.dist import (
        _dist_estimate_bounds,
        build_distributed,
        dist_solve_cg,
    )

    size = 8
    shards = [generate_stencil(8, 8, 3, rank=r, size=size)
              for r in range(size)]
    csr = generate_stencil(8, 8, 3 * size)
    A = from_csr("crs", csr)
    b = np.random.default_rng(4).standard_normal(csr.nr)
    pc = cheb_precond_for(A, csr.nr, np.float64, degree=3)
    serial = solve_cg(A, b, itermax=300, eps=1e-9, precond=pc,
                      verbose=False)

    dm = build_distributed(shards, fmt="crs")
    bounds = _dist_estimate_bounds(dm, csr.nr, np.float64, mode="precond")
    np.testing.assert_allclose(bounds, (pc.lmin, pc.lmax), rtol=1e-10)
    for variant in ("standard", "cs"):
        d = dist_solve_cg(dm, b, itermax=300, eps=1e-9,
                          precond=ChebPrecond(*bounds, degree=3),
                          variant=variant, verbose=False)
        assert d.iterations == serial.iterations
        np.testing.assert_allclose(d.x, serial.x, rtol=1e-9, atol=1e-12)
    # pipe is a different recurrence: compare dist pipe to SERIAL pipe
    sp = solve_cg(A, b, itermax=300, eps=1e-9, precond=pc, variant="pipe",
                  verbose=False)
    dp = dist_solve_cg(dm, b, itermax=300, eps=1e-9,
                       precond=ChebPrecond(*bounds, degree=3),
                       variant="pipe", verbose=False)
    assert dp.iterations == sp.iterations
    np.testing.assert_allclose(dp.x, sp.x, rtol=1e-9, atol=1e-12)


def test_dist_cheb_pcg_stencil_parity():
    from sparsebench.parallel.stencil_dist import (
        build_halo_stencil,
        dist_estimate_bounds_stencil,
        dist_solve_cg_stencil,
    )

    from sparsebench.config import DTypePolicy

    size = 4
    nx, ny, nz = 8, 8, 3
    csr = generate_stencil(nx, ny, nz * size)
    A_ref = from_csr("crs", csr, DTypePolicy.from_names("f32", "i32"))
    b = np.random.default_rng(5).standard_normal(csr.nr).astype(np.float32)
    pc = cheb_precond_for(A_ref, csr.nr, np.float32, degree=3)
    serial = solve_cg(A_ref, b, itermax=200, eps=1e-5, precond=pc,
                      verbose=False)

    A, _counts = build_halo_stencil(nx, ny, nz, size)
    bounds = dist_estimate_bounds_stencil(A, size, np.float32,
                                          mode="precond")
    np.testing.assert_allclose(bounds, (pc.lmin, pc.lmax), rtol=1e-4)
    d = dist_solve_cg_stencil(A, size, b, itermax=200, eps=1e-5,
                              precond=ChebPrecond(*bounds, degree=3),
                              verbose=False)
    assert abs(d.iterations - serial.iterations) <= 1
    np.testing.assert_allclose(d.x, serial.x, rtol=2e-4, atol=1e-5)


def test_dist_cheb_gmres_bicgstab_parity():
    """Distributed GMRES/BiCGStab with the Chebyshev polynomial: the
    preconditioner apply runs inside shard_map (degree halo exchanges,
    zero psums) and must reproduce the serial run bit-for-rounding."""
    from sparsebench.parallel.dist import (
        build_distributed,
        dist_solve_bicgstab,
        dist_solve_gmres,
    )
    from sparsebench.solvers.bicgstab import solve_bicgstab
    from sparsebench.solvers.gmres import solve_gmres

    size = 4
    shards = [generate_stencil(6, 6, 2, rank=r, size=size)
              for r in range(size)]
    csr = generate_stencil(6, 6, 2 * size)
    A = from_csr("crs", csr)
    b = np.random.default_rng(9).standard_normal(csr.nr)
    pc = cheb_precond_for(A, csr.nr, np.float64, degree=2)
    dm = build_distributed(shards, fmt="crs")

    sg = solve_gmres(A, b, itermax=40, eps=1e-9, precond=pc, verbose=False)
    dg = dist_solve_gmres(dm, b, itermax=40, eps=1e-9, precond=pc,
                          verbose=False)
    assert dg.iterations == sg.iterations
    np.testing.assert_allclose(dg.x, sg.x, rtol=1e-9, atol=1e-12)

    sb = solve_bicgstab(A, b, itermax=60, eps=1e-9, precond=pc,
                        verbose=False)
    db = dist_solve_bicgstab(dm, b, itermax=60, eps=1e-9, precond=pc,
                             verbose=False)
    assert db.iterations == sb.iterations
    np.testing.assert_allclose(db.x, sb.x, rtol=1e-9, atol=1e-12)


# --------------------------------------------------------------- CLI

def test_cli_cheb_precond(capsys):
    from sparsebench.cli import main

    rc = main(["-t", "cg", "-x", "8", "-y", "8", "-z", "8", "-i", "100",
               "-e", "1e-8", "--precond", "cheb", "--precond-degree", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Preconditioner: Chebyshev(degree 2" in out
    assert "Difference between computed and exact" in out


def test_cli_cheb_jacobi_sharded(capsys):
    from sparsebench.cli import main

    rc = main(["-t", "cg", "-x", "6", "-y", "6", "-z", "2", "-i", "100",
               "-e", "1e-8", "--shards", "4", "--precond", "cheb-jacobi",
               "--cg-variant", "cs"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "on D^-1 A" in out


def test_cli_cheb_gmres(capsys):
    from sparsebench.cli import main

    rc = main(["-t", "gmres", "-x", "8", "-y", "8", "-z", "8", "-i", "100",
               "-e", "1e-6", "--precond", "cheb", "--precond-degree", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Preconditioner: Chebyshev(degree 2" in out


def test_cli_cheb_jacobi_bicgstab_sharded(capsys):
    from sparsebench.cli import main

    rc = main(["-t", "bicgstab", "-x", "6", "-y", "6", "-z", "2", "-i",
               "100", "-e", "1e-8", "--shards", "4", "--precond",
               "cheb-jacobi"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "on D^-1 A" in out


def test_cli_cheb_rejects_cheb_solver():
    """Chebyshev-preconditioning the Chebyshev solver is the same
    polynomial twice — rejected with guidance (cg/gmres/bicgstab allowed)."""
    from sparsebench.cli import main

    with pytest.raises(SystemExit, match="cg/gmres/bicgstab"):
        main(["-t", "cheb", "-x", "5", "-y", "5", "-z", "5",
              "--precond", "cheb"])


def test_cli_precond_degree_warning(capsys):
    from sparsebench.cli import main

    rc = main(["-t", "cg", "-x", "5", "-y", "5", "-z", "5", "-i", "5",
               "--precond-degree", "5"])
    err = capsys.readouterr().err
    assert rc == 0
    assert "--precond-degree has no effect" in err
