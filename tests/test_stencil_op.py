"""Matrix-free stencil operator vs the generated-matrix oracle.

The StencilOperator (formats/stencil.py) claims A = 28 I - Sz.Sy.Sx
(27-pt) / A = 30 I - (Sx+Sy+Sz) (7-pt) for the reference generator's
matrix (src/matrix.c:30-121). These tests prove it against the actual
generated CSR on asymmetric grids, degenerate thin grids, and both
stencils, plus CG end-to-end equivalence.
"""

import jax
import numpy as np
import pytest

from sparsebench.config import DTypePolicy
from sparsebench.formats.stencil import (
    StencilOperator,
    stencil_row_counts,
)
from sparsebench.host import generate_stencil

jax.config.update("jax_enable_x64", True)

F32 = DTypePolicy.from_names("f32", "i32")
# x dtype -> (rtol, atol) of the apply against the f64 dense oracle
TOL = {np.float32: (2e-5, 2e-4), np.float64: (1e-13, 1e-12)}

GRIDS = [(8, 8, 8), (10, 9, 7), (4, 4, 4), (1, 5, 6), (2, 2, 2), (1, 1, 9)]


@pytest.mark.parametrize("dims", GRIDS)
@pytest.mark.parametrize("use_7pt", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spmv_matches_generated_matrix(dims, use_7pt, dtype):
    """The operator adopts the vector dtype; both agree with the dense
    generated matrix and with the neighbour-sum formula chip_smoke.py
    checks the card against."""
    from chip_smoke import stencil_reference

    nx, ny, nz = dims
    csr = generate_stencil(nx, ny, nz, use_7pt=use_7pt, dtype=np.float64)
    A, counts = StencilOperator.from_stencil(nx, ny, nz, use_7pt=use_7pt,
                                             policy=F32)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(csr.nc).astype(dtype)
    want = csr.to_dense() @ x.astype(np.float64)
    np.testing.assert_allclose(
        stencil_reference(x.astype(np.float64), nx, ny, nz, use_7pt), want,
        rtol=1e-13, atol=1e-12)
    got = np.asarray(A.spmv(x))
    assert got.dtype == dtype
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    assert A.nnz == csr.nnz
    np.testing.assert_array_equal(counts, csr.row_lengths)


@pytest.mark.parametrize("dims", GRIDS)
@pytest.mark.parametrize("use_7pt", [False, True])
def test_row_counts_analytic(dims, use_7pt):
    nx, ny, nz = dims
    csr = generate_stencil(nx, ny, nz, use_7pt=use_7pt, dtype=np.float64)
    np.testing.assert_array_equal(
        stencil_row_counts(nx, ny, nz, use_7pt), csr.row_lengths
    )


def test_cg_end_to_end():
    from sparsebench.solvers.cg import (
        check_residual,
        init_vectors,
        solve_cg,
    )

    A, counts = StencilOperator.from_stencil(12, 11, 10, policy=F32)
    x0, b, xexact = init_vectors(row_lengths=counts, dtype=np.float32)
    res = solve_cg(A, b, itermax=80, eps=0.0, verbose=False)
    assert check_residual(res.x, xexact) < 1e-4


def test_physical_bytes_are_vectors_only():
    from sparsebench.formats.base import physical_spmv_bytes

    A, _ = StencilOperator.from_stencil(8, 8, 8, policy=F32)
    assert physical_spmv_bytes(A, 4) == (A.nr + A.nc) * 4


def test_guards():
    with pytest.raises(ValueError, match="serial-only"):
        StencilOperator.from_stencil(4, 4, 4, rank=1, size=2)
    with pytest.raises(ValueError, match="matrix-free"):
        StencilOperator.from_csr(None)


def test_stencil_other_solvers():
    """GMRES and Chebyshev run on the matrix-free operator."""
    from sparsebench.solvers.chebyshev import solve_chebyshev
    from sparsebench.solvers.cg import check_residual, init_vectors
    from sparsebench.solvers.gmres import solve_gmres

    A, counts = StencilOperator.from_stencil(4, 4, 3, policy=F32)
    _, b, xexact = init_vectors(row_lengths=counts, dtype=np.float32)
    res = solve_gmres(A, b, itermax=16, restart=8, eps=1e-8, verbose=False)
    assert check_residual(res.x, xexact) < 1e-3
    res_c = solve_chebyshev(A, b, itermax=80, eps=1e-10, verbose=False)
    assert check_residual(res_c.x, xexact) < 1e-2


def test_cli_stencil_fmt(capsys):
    from sparsebench.cli import main

    rc = main(["-t", "cg", "-x", "8", "-y", "8", "-z", "8", "-i", "40",
               "--fmt", "stencil"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "format stencil" in out
    assert "Difference between computed and exact" in out


def test_cli_stencil_spmv_bench(capsys):
    from sparsebench.cli import main

    rc = main(["-t", "spmv", "-x", "8", "-y", "8", "-z", "8", "-i", "5",
               "--fmt", "stencil"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Test type: SPMVM" in out
