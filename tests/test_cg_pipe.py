"""Pipelined CG tests (solvers/cg_pipe.py).

Oracle: standard CG — pipelined CG produces identical Krylov iterates
in exact arithmetic (its scalars are the Chronopoulos-Gear recurrences),
so f64 residual histories must match standard CG's down to the
comparison floor, like the cs variant's tests.
"""

import numpy as np
import pytest

import jax

from sparsebench.formats import from_csr
from sparsebench.host import HostCSR, generate_stencil
from sparsebench.solvers.cg import check_residual, init_vectors, solve_cg

jax.config.update("jax_enable_x64", True)


def test_pipe_matches_standard_cg_history():
    csr = generate_stencil(8, 8, 8)
    _x0, b, xexact = init_vectors(csr)
    A = from_csr("crs", csr)
    std = solve_cg(A, b, itermax=60, eps=0.0, verbose=False)
    pipe = solve_cg(A, b, itermax=60, eps=0.0, variant="pipe",
                    verbose=False)
    n = min(len(std.residual_history), len(pipe.residual_history))
    sh = std.residual_history[:n]
    floor = 1e-9 * sh[0]
    cmp = sh > floor
    np.testing.assert_allclose(
        pipe.residual_history[:n][cmp], sh[cmp], rtol=1e-6, atol=floor,
    )
    assert check_residual(pipe.x, xexact) < 1e-7


def test_pipe_converges_with_eps():
    csr = generate_stencil(6, 6, 6)
    _x0, b, xexact = init_vectors(csr)
    A = from_csr("dia", csr)
    res = solve_cg(A, b, itermax=200, eps=1e-9, variant="pipe",
                   verbose=False)
    assert res.final_normr <= 1e-9
    assert check_residual(res.x, xexact) < 1e-7


def test_pipe_jacobi_matches_standard_pcg():
    csr = generate_stencil(6, 5, 4)
    rng = np.random.default_rng(1)
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
    std = solve_cg(A, b, itermax=60, inv_diag=inv_diag, verbose=False)
    pipe = solve_cg(A, b, itermax=60, inv_diag=inv_diag, variant="pipe",
                    verbose=False)
    n = min(len(std.residual_history), len(pipe.residual_history))
    sh = std.residual_history[:n]
    floor = 1e-8 * sh[0]
    cmp = sh > floor
    np.testing.assert_allclose(
        pipe.residual_history[:n][cmp], sh[cmp], rtol=1e-5, atol=floor,
    )


def test_pipe_f32_drift_bounded_past_convergence():
    """The recurrently maintained u/w drift past the f32 floor; the
    drift-triggered replacement must keep the reported residual near
    the floor and x at standard-CG accuracy."""
    csr = generate_stencil(16, 16, 16, dtype=np.float32)
    _x0, b, xexact = init_vectors(csr, dtype=np.float32)
    A = from_csr("crs", csr)
    res = solve_cg(A, b, itermax=300, eps=0.0, variant="pipe",
                   verbose=False)
    assert res.final_normr < 1e-5 * res.residual_history[0]
    assert check_residual(res.x, xexact) < 1e-4


def test_pipe_breakdown_guard_no_nans():
    csr = generate_stencil(5, 5, 5)
    _x0, b, xexact = init_vectors(csr)
    A = from_csr("crs", csr)
    res = solve_cg(A, b, itermax=400, eps=0.0, variant="pipe",
                   verbose=False)
    assert np.all(np.isfinite(res.x))
    assert check_residual(res.x, xexact) < 1e-7


def test_pipe_permuted_format():
    csr = generate_stencil(6, 5, 4)
    _x0, b, xexact = init_vectors(csr)
    A = from_csr("sell", csr, chunk_height=4, sigma=0)
    res = solve_cg(A, b, itermax=200, eps=1e-9, variant="pipe",
                   verbose=False)
    assert check_residual(res.x, xexact) < 1e-7


def test_dist_pipe_matches_serial_pipe():
    from sparsebench.host.coo import COOMatrix
    from sparsebench.parallel.dist import (
        build_distributed,
        dist_solve_cg,
    )
    from sparsebench.parallel.partition import slice_coo_rows

    g = generate_stencil(5, 5, 5)
    rows = np.repeat(np.arange(g.nr, dtype=np.int64), g.row_lengths)
    coo = COOMatrix(row=rows, col=g.col, val=g.val, nr=g.nr, nc=g.nc)
    shards = [HostCSR.from_coo(slice_coo_rows(coo, r, 4)) for r in range(4)]
    _x0, b, _ = init_vectors(g)
    serial = solve_cg(from_csr("crs", g), b, itermax=40, eps=0.0,
                      variant="pipe", verbose=False)
    dm = build_distributed(shards, fmt="crs")
    dist = dist_solve_cg(dm, b, itermax=40, eps=0.0, variant="pipe",
                         verbose=False)
    n = min(len(serial.residual_history), len(dist.residual_history))
    sh = serial.residual_history[:n]
    floor = 1e-7 * sh[0]
    cmp = sh > floor
    np.testing.assert_allclose(
        dist.residual_history[:n][cmp], sh[cmp], rtol=1e-7, atol=floor,
    )
    assert np.abs(dist.x - 1.0).max() < 1e-6


@pytest.mark.parametrize("sharded", [False, True])
def test_pipe_cli(capsys, sharded):
    from sparsebench.cli import main

    argv = ["-t", "cg", "-x", "5", "-y", "5", "-z", "4", "-i", "25",
            "--cg-variant", "pipe"]
    if sharded:
        argv += ["--shards", "4", "--fmt", "crs"]
    rc = main(argv)
    out = capsys.readouterr().out
    assert rc == 0
    assert "Difference between computed and exact  = 0.000" in out
