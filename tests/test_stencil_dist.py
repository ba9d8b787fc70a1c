"""Distributed matrix-free stencil: z-slab SPMD parity tests.

Oracles: the z-stacked multi-rank generated problem equals one big
(nx, ny, nz*size) grid (reference src/matrix.c:37-41), so the dense
generated matrix and the SERIAL matrix-free operator on the global grid
are exact references for the sharded apply and solve."""

import jax
import numpy as np
import pytest

from sparsebench.config import DTypePolicy
from sparsebench.formats.stencil import StencilOperator
from sparsebench.host import generate_stencil
from sparsebench.parallel.stencil_dist import (
    build_halo_stencil,
    dist_solve_cg_stencil,
    dist_spmv_stencil,
)
from sparsebench.solvers.cg import check_residual, init_vectors, solve_cg

jax.config.update("jax_enable_x64", True)

F32 = DTypePolicy.from_names("f32", "i32")
SIZE = 4
# (x dtype, rtol, atol) of the sharded apply against the f64 dense oracle
TOL = {"f32": (np.float32, 2e-5, 2e-4), "f64": (np.float64, 1e-12, 1e-11)}


@pytest.mark.parametrize("dims", [(6, 5, 4), (4, 4, 1), (3, 3, 2)])
@pytest.mark.parametrize("use_7pt", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_dist_spmv_matches_global_matrix(dims, use_7pt, dtype):
    nx, ny, nz = dims
    dt, rtol, atol = TOL[dtype]
    A, counts = build_halo_stencil(nx, ny, nz, SIZE, use_7pt=use_7pt)
    csr = generate_stencil(nx, ny, nz * SIZE, use_7pt=use_7pt,
                           dtype=np.float64)
    assert A.nnz == csr.nnz
    np.testing.assert_array_equal(counts, csr.row_lengths)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(A.total_nr).astype(dt)
    want = csr.to_dense() @ x.astype(np.float64)
    got = dist_spmv_stencil(A, SIZE, x)
    assert got.dtype == dt
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_dist_cg_pipe():
    """--cg-variant pipe through the z-slab plane-halo exchange."""
    A, counts = build_halo_stencil(6, 6, 3, SIZE)
    b = (27.0 - (counts - 1)).astype(np.float32)
    res = dist_solve_cg_stencil(A, SIZE, b, itermax=60, eps=0.0,
                                variant="pipe", verbose=False)
    assert check_residual(res.x, np.ones(A.total_nr)) < 1e-4


def test_dist_cg_rejects_unknown_variant():
    """A typo'd variant must raise, not silently run standard CG (the
    shared resolve_cg_loop guarantee for every driver)."""
    A, counts = build_halo_stencil(4, 4, 1, SIZE)
    b = (27.0 - (counts - 1)).astype(np.float32)
    with pytest.raises(ValueError, match="variant"):
        dist_solve_cg_stencil(A, SIZE, b, itermax=5, variant="s-step",
                              verbose=False)


@pytest.mark.parametrize("variant", ["standard", "cs"])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_dist_cg_matches_serial(variant, dtype):
    nx, ny, nz = 6, 6, 3
    dt = TOL[dtype][0]
    A, counts = build_halo_stencil(nx, ny, nz, SIZE)
    b = (27.0 - (counts - 1)).astype(dt)
    res = dist_solve_cg_stencil(A, SIZE, b, itermax=60, eps=0.0,
                                variant=variant, verbose=False)
    assert check_residual(res.x, np.ones(A.total_nr)) < 1e-4

    As, counts_s = StencilOperator.from_stencil(nx, ny, nz * SIZE,
                                                policy=F32)
    _, bs, _ = init_vectors(row_lengths=counts_s, dtype=dt)
    res_s = solve_cg(As, bs, itermax=60, eps=0.0, verbose=False,
                     variant=variant)
    n = min(res.iterations, res_s.iterations)
    np.testing.assert_allclose(res.residual_history[:n],
                               res_s.residual_history[:n],
                               rtol=1e-4, atol=1e-6)


def test_dist_cg_sstep():
    """--cg-variant sstep must reach the matrix-free z-slab path (it
    previously fell through to standard CG silently)."""
    A, counts = build_halo_stencil(6, 6, 3, SIZE)
    b = (27.0 - (counts - 1)).astype(np.float32)
    res = dist_solve_cg_stencil(A, SIZE, b, itermax=61, eps=0.0,
                                variant="sstep", sstep=4, verbose=False)
    assert check_residual(res.x, np.ones(A.total_nr)) < 1e-4
    # sstep signature: NaN history slots between outer-step boundaries
    assert np.isnan(res.residual_history[2])


def test_cli_sharded_stencil_sstep(capsys):
    from sparsebench.cli import main

    rc = main(["-t", "cg", "-x", "5", "-y", "5", "-z", "2", "-i", "41",
               "--fmt", "stencil", "--shards", str(SIZE),
               "--cg-variant", "sstep", "--sstep", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Difference between computed and exact  = 0.000" in out


def test_dist_cg_jacobi():
    A, counts = build_halo_stencil(5, 5, 2, SIZE)
    b = (27.0 - (counts - 1)).astype(np.float32)
    inv_d = np.full(A.total_nr, 1.0 / 27.0, dtype=np.float32)
    res = dist_solve_cg_stencil(A, SIZE, b, itermax=60, eps=0.0,
                                inv_diag=inv_d, verbose=False)
    assert check_residual(res.x, np.ones(A.total_nr)) < 1e-4


def test_cli_sharded_stencil(capsys):
    from sparsebench.cli import main

    rc = main(["-t", "cg", "-x", "6", "-y", "6", "-z", "3", "-i", "40",
               "--fmt", "stencil", "--shards", str(SIZE)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "z-slabs" in out
    assert "Difference between computed and exact" in out


@pytest.mark.parametrize("dims", [(6, 5, 4), (3, 3, 2)])
@pytest.mark.parametrize("use_7pt", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_overlap_spmv_matches_global_matrix(dims, use_7pt, dtype):
    """OverlapHaloStencil (ppermutes concurrent with the zero-halo apply
    + one-plane corrections) must be the same linear operator as the
    blocking exchange->apply composition."""
    nx, ny, nz = dims
    dt, rtol, atol = TOL[dtype]
    A, _ = build_halo_stencil(nx, ny, nz, SIZE, use_7pt=use_7pt)
    csr = generate_stencil(nx, ny, nz * SIZE, use_7pt=use_7pt,
                           dtype=np.float64)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(A.total_nr).astype(dt)
    want = csr.to_dense() @ x.astype(np.float64)
    got = dist_spmv_stencil(A, SIZE, x, overlap=True)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    # and rounding-class-identical to the blocking path (the correction
    # only reassociates the one neighbor-plane term)
    blocking = dist_spmv_stencil(A, SIZE, x)
    np.testing.assert_allclose(got, blocking, rtol=rtol, atol=atol / 10)


@pytest.mark.parametrize("variant", ["standard", "cs", "pipe"])
def test_overlap_cg_matches_blocking(variant):
    A, counts = build_halo_stencil(6, 6, 3, SIZE)
    b = (27.0 - (counts - 1)).astype(np.float32)
    res_b = dist_solve_cg_stencil(A, SIZE, b, itermax=40, eps=0.0,
                                  variant=variant, verbose=False)
    res_o = dist_solve_cg_stencil(A, SIZE, b, itermax=40, eps=0.0,
                                  variant=variant, overlap=True,
                                  verbose=False)
    assert check_residual(res_o.x, np.ones(A.total_nr)) < 1e-4
    # trajectory parity over the meaningful decay range: the correction
    # reassociates one f32 plane sum, and the recurrence-maintained
    # variants (pipe) amplify that in the deep tail — same comparison
    # discipline as the MINRES dryrun leg (__graft_entry__.py)
    n = min(res_b.iterations, res_o.iterations)
    hb = res_b.residual_history[:n]
    keep = hb > 1e-5 * hb[0]
    np.testing.assert_allclose(res_o.residual_history[:n][keep], hb[keep],
                               rtol=1e-3)


def test_overlap_cg_cheb_precond():
    """Operator preconditioning composes with the overlapped apply (the
    polynomial's SpMVs each carry their own in-apply ppermutes)."""
    from sparsebench.parallel.stencil_dist import (
        dist_estimate_bounds_stencil,
    )
    from sparsebench.solvers.precond import ChebPrecond

    A, counts = build_halo_stencil(5, 5, 2, SIZE)
    b = (27.0 - (counts - 1)).astype(np.float32)
    bounds = dist_estimate_bounds_stencil(A, SIZE, np.float32,
                                          mode="precond", overlap=True)
    pc = ChebPrecond(*bounds, degree=2)
    res = dist_solve_cg_stencil(A, SIZE, b, itermax=40, eps=0.0,
                                precond=pc, overlap=True, verbose=False)
    assert check_residual(res.x, np.ones(A.total_nr)) < 1e-4


def test_cli_sharded_stencil_overlap(capsys):
    from sparsebench.cli import main

    rc = main(["-t", "cg", "-x", "6", "-y", "6", "-z", "3", "-i", "40",
               "--fmt", "stencil", "--shards", str(SIZE), "--overlap"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Exchange: overlapped" in out
    assert "Difference between computed and exact  = 0.000" in out


def test_cli_overlap_guard():
    """--overlap outside --fmt stencil --shards must error loudly, never
    be silently dropped."""
    from sparsebench.cli import main

    with pytest.raises(SystemExit, match="overlap"):
        main(["-t", "cg", "-x", "4", "-y", "4", "-z", "2", "-i", "5",
              "--overlap"])
    with pytest.raises(SystemExit, match="overlap"):
        main(["-t", "cg", "-x", "4", "-y", "4", "-z", "2", "-i", "5",
              "--fmt", "dia", "--shards", "2", "--overlap"])


def test_cli_sharded_stencil_guards():
    from sparsebench.cli import main

    with pytest.raises(SystemExit, match="-t cg"):
        main(["-t", "spmv", "-x", "4", "-y", "4", "-z", "2", "-i", "5",
              "--fmt", "stencil", "--shards", "2"])
    with pytest.raises(SystemExit, match="stored-format"):
        main(["-t", "cg", "-x", "4", "-y", "4", "-z", "2", "-i", "5",
              "--fmt", "stencil", "--shards", "2", "--profile"])
