"""MINRES tests (solvers/minres.py).

Oracles: the generated SPD problem's exact solution (x == 1), dense
numpy solves for symmetric INDEFINITE systems (MINRES's reason to exist
— CG breaks down off the SPD cone, the reference enum offers nothing
symmetric-indefinite), and serial vs distributed history parity.
"""

import numpy as np
import pytest

import jax

from sparsebench.formats import from_csr
from sparsebench.host import HostCSR, generate_stencil
from sparsebench.solvers.cg import check_residual, init_vectors
from sparsebench.solvers.minres import solve_minres

jax.config.update("jax_enable_x64", True)


def _shifted(nx=5, ny=5, nz=5, shift=31.41):
    """Symmetric indefinite: the 27-pt stencil shifted by -shift*I.
    The stencil's spectrum sits in (1, 55) (A = 28I - Sz.Sy.Sx with
    |eig(S)| < 3 per axis — formats/stencil.py), so the shift lands
    strictly inside it: eigenvalues on both sides of zero. 31.41 keeps
    min|eig| >= 0.17 for every grid used here (30 is EXACTLY an
    eigenvalue: the S-products contain (1+sqrt(3))(1-sqrt(3))*1 = -2)."""
    csr = generate_stencil(nx, ny, nz)
    rows = np.repeat(np.arange(csr.nr), csr.row_lengths)
    val = csr.val.copy()
    val[csr.col == rows] -= shift
    return HostCSR(row_ptr=csr.row_ptr, col=csr.col, val=val,
                   nr=csr.nr, nc=csr.nc)


def test_minres_spd_converges_to_exact():
    csr = generate_stencil(8, 8, 8)
    _x0, b, xexact = init_vectors(csr)
    A = from_csr("crs", csr)
    res = solve_minres(A, b, itermax=200, eps=1e-9, verbose=False)
    assert res.final_normr <= 1e-9
    assert check_residual(res.x, xexact) < 1e-7


def test_minres_spd_matches_cg_rate():
    """On an SPD system MINRES minimizes ||r|| over the same Krylov
    spaces CG draws from — its residuals are monotone and no worse than
    CG's at every step."""
    from sparsebench.solvers.cg import solve_cg

    csr = generate_stencil(6, 6, 6)
    _x0, b, _ = init_vectors(csr)
    A = from_csr("crs", csr)
    mr = solve_minres(A, b, itermax=40, eps=0.0, verbose=False)
    cg = solve_cg(A, b, itermax=40, eps=0.0, verbose=False)
    hm = mr.residual_history
    assert np.all(np.diff(hm) <= 1e-12 * hm[0])  # monotone
    n = min(len(hm), len(cg.residual_history))
    assert np.all(hm[:n] <= cg.residual_history[:n] * (1 + 1e-10))


def test_minres_indefinite_matches_dense_solve():
    csr = _shifted()
    dense = csr.to_dense()
    eigs = np.linalg.eigvalsh(dense)
    assert eigs.min() < 0 < eigs.max()  # genuinely indefinite
    assert np.abs(eigs).min() > 0.05    # ... and well-posed
    rng = np.random.default_rng(3)
    b = rng.standard_normal(csr.nr)
    want = np.linalg.solve(dense, b)
    A = from_csr("crs", csr)
    res = solve_minres(A, b, itermax=140,
                       eps=1e-12 * np.linalg.norm(b), verbose=False)
    assert np.abs(res.x - want).max() < 1e-6 * np.abs(want).max()
    # recurrence norm tracks the true residual
    true_norm = np.linalg.norm(b - dense @ res.x)
    assert abs(true_norm - res.final_normr) < 1e-6 * np.linalg.norm(b)


def test_minres_indefinite_where_cg_fails():
    """The capability gap MINRES fills: on the shifted system CG's
    p.Ap can go negative and its iterates stall or blow up; MINRES
    converges cleanly. (CG's breakdown guard freezes — we only assert
    MINRES reaches the oracle while CG does not.)"""
    from sparsebench.solvers.cg import solve_cg

    csr = _shifted(4, 4, 4)
    dense = csr.to_dense()
    rng = np.random.default_rng(5)
    b = rng.standard_normal(csr.nr)
    want = np.linalg.solve(dense, b)
    A = from_csr("crs", csr)
    mr = solve_minres(A, b, itermax=70, eps=0.0, verbose=False)
    cg = solve_cg(A, b, itermax=70, eps=0.0, verbose=False)
    err_mr = np.abs(mr.x - want).max() / np.abs(want).max()
    err_cg = np.abs(cg.x - want).max() / np.abs(want).max()
    assert err_mr < 1e-8
    assert err_cg > 1e-4  # CG is not a usable method here


def test_minres_jacobi_precond():
    """Badly diagonally-scaled SPD system: Jacobi-preconditioned MINRES
    needs fewer iterations to a fixed residual, and the positive-diag
    validation refuses an indefinite M."""
    csr = generate_stencil(6, 5, 4)
    rng = np.random.default_rng(11)
    sc = 10.0 ** rng.uniform(-1.5, 1.5, csr.nr)
    rows = np.repeat(np.arange(csr.nr), csr.row_lengths)
    # symmetric scaling S A S keeps symmetry and wrecks the diagonal
    val = csr.val * sc[rows] * sc[csr.col]
    scaled = HostCSR(row_ptr=csr.row_ptr, col=csr.col, val=val,
                     nr=csr.nr, nc=csr.nc)
    A = from_csr("crs", scaled)
    b = rng.standard_normal(csr.nr)
    want = np.linalg.solve(scaled.to_dense(), b)
    inv_diag = 1.0 / scaled.diagonal()
    pre = solve_minres(A, b, itermax=500, eps=1e-9 * np.linalg.norm(b),
                       inv_diag=inv_diag, verbose=False)
    plain = solve_minres(A, b, itermax=500, eps=1e-9 * np.linalg.norm(b),
                         verbose=False)
    assert np.abs(pre.x - want).max() < 1e-5 * np.abs(want).max()
    assert pre.iterations < plain.iterations
    with pytest.raises(ValueError, match="positive"):
        solve_minres(A, b, itermax=5, inv_diag=-inv_diag, verbose=False)


def test_minres_permuted_format():
    csr = _shifted(5, 4, 4)
    A = from_csr("sell", csr, chunk_height=4, sigma=0)
    rng = np.random.default_rng(2)
    b = rng.standard_normal(csr.nr)
    want = np.linalg.solve(csr.to_dense(), b)
    res = solve_minres(A, b, itermax=110,
                       eps=1e-11 * np.linalg.norm(b), verbose=False)
    assert np.abs(res.x - want).max() < 1e-6 * np.abs(want).max()


def test_minres_f32_and_bf16_paths():
    csr = generate_stencil(6, 6, 6, dtype=np.float32)
    _x0, b, xexact = init_vectors(csr, dtype=np.float32)
    A = from_csr("crs", csr)
    res = solve_minres(A, b, itermax=80, eps=0.0, verbose=False)
    assert np.all(np.isfinite(res.x))
    assert check_residual(res.x, xexact) < 1e-4
    # bf16 input upcasts the working vectors to f32 (three-term
    # recurrences collapse in bf16 — solve_gmres's finding)
    res16 = solve_minres(A, b.astype(jax.numpy.bfloat16), itermax=80,
                         eps=0.0, verbose=False)
    assert check_residual(res16.x.astype(np.float64), xexact) < 1e-4


def test_dist_minres_matches_serial():
    from sparsebench.host.coo import COOMatrix
    from sparsebench.parallel.dist import (
        build_distributed,
        dist_solve_minres,
    )
    from sparsebench.parallel.partition import slice_coo_rows

    csr = _shifted(4, 4, 4)
    rows = np.repeat(np.arange(csr.nr, dtype=np.int64), csr.row_lengths)
    coo = COOMatrix(row=rows, col=csr.col, val=csr.val, nr=csr.nr,
                    nc=csr.nc)
    shards = [HostCSR.from_coo(slice_coo_rows(coo, r, 4)) for r in range(4)]
    rng = np.random.default_rng(7)
    b = rng.standard_normal(csr.nr)
    serial = solve_minres(from_csr("crs", csr), b, itermax=40, eps=0.0,
                          verbose=False)
    dm = build_distributed(shards, fmt="crs")
    dist = dist_solve_minres(dm, b, itermax=40, eps=0.0, verbose=False)
    n = min(len(serial.residual_history), len(dist.residual_history))
    hs = serial.residual_history[:n]
    # phibar is a product of one Givens sine per iteration, so near
    # Krylov exhaustion (~1e-8 relative on this 64-row system) serial
    # vs mesh reduction order legitimately amplifies — compare in the
    # meaningful range only (the bicgstab parity test's pattern), plus
    # the solutions themselves
    floor = 1e-4 * hs[0]
    cmp = hs > floor
    np.testing.assert_allclose(dist.residual_history[:n][cmp], hs[cmp],
                               rtol=1e-9)
    assert np.abs(dist.x - serial.x).max() < 1e-9 * np.abs(serial.x).max()
    with pytest.raises(ValueError, match="positive"):
        dist_solve_minres(dm, b, itermax=5,
                          inv_diag=-np.ones(csr.nr), verbose=False)


@pytest.mark.parametrize("sharded", [False, True])
def test_minres_cli(capsys, sharded):
    from sparsebench.cli import main

    argv = ["-t", "minres", "-x", "5", "-y", "5", "-z", "4", "-i", "60",
            "-e", "1e-8"]
    if sharded:
        argv += ["--shards", "4", "--fmt", "crs"]
    else:
        argv += ["--precond", "jacobi"]
    rc = main(argv)
    out = capsys.readouterr().out
    assert rc == 0
    assert "MINRES" in out
    assert "Difference between computed and exact" in out


def test_minres_cli_rejects_cheb_precond(capsys):
    from sparsebench.cli import main

    with pytest.raises(SystemExit):
        main(["-t", "minres", "-x", "4", "-y", "4", "-z", "4",
              "--precond", "cheb"])
