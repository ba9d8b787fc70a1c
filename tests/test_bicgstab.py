"""BiCGStab tests (solvers/bicgstab.py).

Oracles: the generated SPD problem's exact solution (x == 1), dense
numpy solves for nonsymmetric systems (BiCGStab's reason to exist —
GMRES is the only reference-enum alternative there), and serial vs
distributed history parity.
"""

import numpy as np
import pytest

import jax

from sparsebench.formats import from_csr
from sparsebench.host import HostCSR, generate_stencil
from sparsebench.solvers.bicgstab import solve_bicgstab
from sparsebench.solvers.cg import check_residual, init_vectors

jax.config.update("jax_enable_x64", True)


def _nonsym(nx=6, ny=5, nz=4, seed=4, skew=0.3):
    """Diagonally-dominant nonsymmetric: the 27-pt stencil with its
    off-diagonal entries randomly perturbed (asymmetric)."""
    csr = generate_stencil(nx, ny, nz)
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(csr.nr), csr.row_lengths)
    off = csr.col != rows
    val = csr.val.copy()
    val[off] *= 1.0 + skew * rng.uniform(-1, 1, off.sum())
    return HostCSR(row_ptr=csr.row_ptr, col=csr.col, val=val,
                   nr=csr.nr, nc=csr.nc), rng


def test_bicgstab_spd_converges_to_exact():
    csr = generate_stencil(8, 8, 8)
    _x0, b, xexact = init_vectors(csr)
    A = from_csr("crs", csr)
    res = solve_bicgstab(A, b, itermax=200, eps=1e-9, verbose=False)
    assert res.final_normr <= 1e-9
    assert check_residual(res.x, xexact) < 1e-7


def test_bicgstab_nonsymmetric_matches_dense_solve():
    csr, rng = _nonsym()
    A = from_csr("crs", csr)
    b = rng.standard_normal(csr.nr)
    dense = csr.to_dense()
    want = np.linalg.solve(dense, b)
    res = solve_bicgstab(A, b, itermax=400,
                         eps=1e-10 * np.linalg.norm(b), verbose=False)
    assert np.abs(res.x - want).max() < 1e-6 * np.abs(want).max()
    # the reported residual tracks the true one (it is recorded at
    # iteration start, so one iteration stale — larger than the final
    # true residual, never smaller by more than rounding)
    true_norm = np.linalg.norm(b - dense @ res.x)
    assert true_norm <= 2 * res.final_normr + 1e-12 * np.linalg.norm(b)
    assert res.final_normr <= 1e-8 * np.linalg.norm(b)


def test_bicgstab_jacobi_precond_nonsymmetric():
    csr, rng = _nonsym(5, 5, 4, seed=9)
    sc = 10.0 ** rng.uniform(-1.0, 1.0, csr.nr)
    rows = np.repeat(np.arange(csr.nr), csr.row_lengths)
    scaled = HostCSR(row_ptr=csr.row_ptr, col=csr.col,
                     val=csr.val * sc[rows], nr=csr.nr, nc=csr.nc)
    A = from_csr("crs", scaled)
    b = rng.standard_normal(csr.nr)
    dense = scaled.to_dense()
    want = np.linalg.solve(dense, b)
    inv_diag = 1.0 / scaled.diagonal()
    pre = solve_bicgstab(A, b, itermax=400, eps=1e-10 * np.linalg.norm(b),
                         inv_diag=inv_diag, verbose=False)
    plain = solve_bicgstab(A, b, itermax=400,
                           eps=1e-10 * np.linalg.norm(b), verbose=False)
    assert np.abs(pre.x - want).max() < 1e-6 * np.abs(want).max()
    assert pre.iterations <= plain.iterations


def test_bicgstab_breakdown_guard_no_nans():
    csr = generate_stencil(5, 5, 5)
    _x0, b, xexact = init_vectors(csr)
    A = from_csr("crs", csr)
    res = solve_bicgstab(A, b, itermax=400, eps=0.0, verbose=False)
    assert np.all(np.isfinite(res.x))
    assert check_residual(res.x, xexact) < 1e-6


def test_bicgstab_permuted_format():
    csr, rng = _nonsym(5, 4, 4, seed=2)
    A = from_csr("sell", csr, chunk_height=4, sigma=0)
    b = rng.standard_normal(csr.nr)
    want = np.linalg.solve(csr.to_dense(), b)
    res = solve_bicgstab(A, b, itermax=400,
                         eps=1e-10 * np.linalg.norm(b), verbose=False)
    assert np.abs(res.x - want).max() < 1e-6 * np.abs(want).max()


def test_dist_bicgstab_matches_serial():
    from sparsebench.host.coo import COOMatrix
    from sparsebench.parallel.dist import (
        build_distributed,
        dist_solve_bicgstab,
    )
    from sparsebench.parallel.partition import slice_coo_rows

    csr, rng = _nonsym(4, 4, 4, seed=7)
    rows = np.repeat(np.arange(csr.nr, dtype=np.int64), csr.row_lengths)
    coo = COOMatrix(row=rows, col=csr.col, val=csr.val, nr=csr.nr,
                    nc=csr.nc)
    shards = [HostCSR.from_coo(slice_coo_rows(coo, r, 4)) for r in range(4)]
    b = rng.standard_normal(csr.nr)
    serial = solve_bicgstab(from_csr("crs", csr), b, itermax=40, eps=0.0,
                            verbose=False)
    dm = build_distributed(shards, fmt="crs")
    dist = dist_solve_bicgstab(dm, b, itermax=40, eps=0.0, verbose=False)
    n = min(len(serial.residual_history), len(dist.residual_history))
    sh = serial.residual_history[:n]
    # BiCGStab residuals are erratic near breakdown levels; compare in
    # the meaningful range only
    floor = 1e-8 * sh[0]
    cmp = sh > floor
    np.testing.assert_allclose(dist.residual_history[:n][cmp], sh[cmp],
                               rtol=1e-6, atol=floor)


def test_bicgstab_f32_residual_from_actual_vector():
    """The reported residual must come from the actual maintained r
    vector (CG-family semantics). The first implementation derived it
    algebraically from the omega reduction (ss - 2w ts + w^2 tt), which
    catastrophically cancels in f32 — reported 5.1e-6 while the
    maintained r's norm was 4.2e-5, then a phantom exact 0.0 mid-run.
    With the fix, the history equals the recurrence residual's true
    norms: positive all the way to the exit (when the maintained r
    underflows, the rho breakdown guard exits instead of recording
    phantom zeros), and x converges to the f32 floor."""
    csr = generate_stencil(8, 8, 8, dtype=np.float32)
    _x0, b, xexact = init_vectors(csr, dtype=np.float32)
    A = from_csr("crs", csr)
    res = solve_bicgstab(A, b, itermax=150, eps=0.0, verbose=False)
    h = res.residual_history
    assert np.isfinite(h).all()
    assert (h[:-1] > 0).all()
    assert check_residual(res.x, xexact) < 1e-3
    # parity cross-check: the recorded norm at a mid-convergence slot
    # matches an independently recomputed ||b - A x|| trajectory there
    # only loosely (recurrence drift) but must be the same ORDER early:
    dense = csr.to_dense().astype(np.float64)
    # after 5 iterations the maintained and true residuals agree closely
    res5 = solve_bicgstab(A, b, itermax=6, eps=0.0, verbose=False)
    tn5 = float(np.linalg.norm(
        np.asarray(b, np.float64) - dense @ np.asarray(res5.x, np.float64)
    ))
    # final_normr is one iteration stale (recorded at iter start)
    assert res5.final_normr >= tn5 * 0.5
    assert res5.residual_history[-1] < res5.residual_history[0]


def test_dist_bicgstab_bf16_matches_serial_upcast():
    """--dtype bf16 -t bicgstab --shards must run the same f32-upcast
    recurrence as the serial path (it previously sharded bf16 vectors
    straight into the loop and diverged from the serial answer)."""
    import jax.numpy as jnp

    from sparsebench.config import DTypePolicy
    from sparsebench.host.coo import COOMatrix
    from sparsebench.parallel.dist import (
        build_distributed,
        dist_solve_bicgstab,
    )
    from sparsebench.parallel.partition import slice_coo_rows

    pol = DTypePolicy.from_names("bf16", "i32")
    csr = generate_stencil(8, 8, 8)
    rows = np.repeat(np.arange(csr.nr, dtype=np.int64), csr.row_lengths)
    coo = COOMatrix(row=rows, col=csr.col, val=csr.val, nr=csr.nr,
                    nc=csr.nc)
    shards = [HostCSR.from_coo(slice_coo_rows(coo, r, 4)) for r in range(4)]
    b = np.ones(csr.nr, dtype=np.dtype(jnp.bfloat16))
    serial = solve_bicgstab(from_csr("crs", csr, pol), b, itermax=40,
                            eps=0.0, verbose=False)
    dm = build_distributed(shards, fmt="crs", policy=pol)
    dist = dist_solve_bicgstab(dm, b, itermax=40, eps=0.0, verbose=False)
    err_s = np.abs(np.asarray(serial.x, np.float32) - 1.0).max()
    err_d = np.abs(np.asarray(dist.x, np.float32) - 1.0).max()
    # both run the f32-upcast recurrence on the bf16 matrix: same
    # accuracy class (the unfixed dist path was ~2.4x worse)
    assert err_d < 2 * err_s + 1e-3


@pytest.mark.parametrize("sharded", [False, True])
def test_bicgstab_cli(capsys, sharded):
    from sparsebench.cli import main

    argv = ["-t", "bicgstab", "-x", "5", "-y", "5", "-z", "4", "-i", "60",
            "-e", "1e-8"]
    if sharded:
        argv += ["--shards", "4", "--fmt", "crs"]
    rc = main(argv)
    out = capsys.readouterr().out
    assert rc == 0
    assert "BICGSTAB" in out
