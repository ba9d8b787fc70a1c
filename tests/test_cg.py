"""CG solver tests (reference src/CGSolver.c behavior).

Oracles: the analytic exact solution of the generated problem (x == 1,
src/CGSolver.c:25-36) and a dense numpy solve of the bundled band matrix.
"""

import numpy as np
import pytest

import jax

from sparsebench.formats import from_csr
from sparsebench.host import HostCSR, generate_stencil, read_mm
from sparsebench.solvers.cg import check_residual, init_vectors, solve_cg

jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("fmt", ["crs", "sell", "ell", "dia", "bslab"])
def test_generated_problem_converges_to_exact(fmt):
    csr = generate_stencil(8, 8, 8)
    x0, b, xexact = init_vectors(csr)
    A = from_csr(fmt, csr)
    res = solve_cg(A, b, itermax=200, eps=1e-9, verbose=False)
    err = check_residual(res.x, xexact)
    assert err < 1e-7, f"{fmt}: max|x - 1| = {err}"
    assert res.final_normr <= 1e-9 or res.iterations == 200
    # history starts at ||b|| and decreases overall
    assert res.residual_history[0] > res.residual_history[-1]


def test_cg_cs_residual_parity_with_standard():
    """Single-reduction CG (Chronopoulos-Gear) generates the same Krylov
    iterates as standard CG: f64 residual histories must match to ~1e-10
    relative (same bar as cross-format parity, BASELINE.md)."""
    csr = generate_stencil(8, 8, 8)
    x0, b, xexact = init_vectors(csr)
    A = from_csr("crs", csr)
    res_std = solve_cg(A, b, itermax=60, eps=0.0, verbose=False)
    res_cs = solve_cg(A, b, itermax=60, eps=0.0, variant="cs", verbose=False)
    n = min(len(res_std.residual_history), len(res_cs.residual_history))
    # atol floor: once the residual reaches machine zero (~1e-16 * ||b||)
    # the two recurrences differ only in rounding noise
    np.testing.assert_allclose(
        res_cs.residual_history[:n], res_std.residual_history[:n],
        rtol=1e-9, atol=1e-14 * res_std.residual_history[0],
    )
    assert check_residual(res_cs.x, xexact) < 1e-7


def test_cg_cs_converges_with_eps():
    csr = generate_stencil(6, 6, 6)
    x0, b, xexact = init_vectors(csr)
    A = from_csr("dia", csr)
    res = solve_cg(A, b, itermax=200, eps=1e-9, variant="cs", verbose=False)
    assert res.final_normr <= 1e-9
    assert check_residual(res.x, xexact) < 1e-7


def test_cg_rejects_bad_variant():
    csr = generate_stencil(4, 4, 4)
    A = from_csr("crs", csr)
    b = np.ones(csr.nr)
    with pytest.raises(ValueError, match="variant"):
        solve_cg(A, b, variant="pipelined", verbose=False)


def test_cg_cs_jacobi_matches_standard_pcg():
    """Chronopoulos-Gear PCG (one fused 3-scalar allreduce) must produce
    the same residual history as the standard Jacobi PCG recurrence on a
    badly diagonally-scaled SPD system."""
    csr = generate_stencil(6, 5, 4)
    rng = np.random.default_rng(1)
    s = 10.0 ** rng.uniform(-1.5, 1.5, csr.nr)
    rows = np.repeat(np.arange(csr.nr), csr.row_lengths)
    scaled = HostCSR(
        row_ptr=csr.row_ptr, col=csr.col,
        val=csr.val * s[rows] * s[csr.col],
        nr=csr.nr, nc=csr.nc,
    )
    A = from_csr("crs", scaled)
    b = rng.standard_normal(csr.nr)
    inv_diag = 1.0 / scaled.diagonal()
    std = solve_cg(A, b, itermax=60, inv_diag=inv_diag, verbose=False)
    cs = solve_cg(A, b, itermax=60, inv_diag=inv_diag, variant="cs",
                  verbose=False)
    n = min(len(std.residual_history), len(cs.residual_history))
    np.testing.assert_allclose(
        cs.residual_history[:n], std.residual_history[:n],
        rtol=1e-8, atol=1e-13 * std.residual_history[0],
    )


def test_cg_cs_jacobi_identity_matches_unpreconditioned_cs():
    csr = generate_stencil(5, 5, 5)
    A = from_csr("crs", csr)
    _, b, _ = init_vectors(csr)
    plain = solve_cg(A, b, itermax=25, variant="cs", verbose=False)
    pcg = solve_cg(A, b, itermax=25, variant="cs", verbose=False,
                   inv_diag=np.ones(csr.nr))
    n = min(len(plain.residual_history), len(pcg.residual_history))
    np.testing.assert_allclose(
        pcg.residual_history[:n], plain.residual_history[:n], rtol=1e-12
    )


def test_band_klein_matches_dense_solve(data_dir):
    csr = HostCSR.from_coo(read_mm(str(data_dir / "matrix_band_klein.mtx")))
    b = np.ones(csr.nr)
    dense = csr.to_dense()
    x_ref = np.linalg.solve(dense, b)
    A = from_csr("sell", csr)
    res = solve_cg(A, b, itermax=400, eps=1e-12, verbose=False)
    np.testing.assert_allclose(res.x, x_ref, rtol=1e-6, atol=1e-8)


def test_histories_agree_across_formats():
    """All formats implement the same math: f64 residual histories must
    agree to ~1e-10 relative (BASELINE.md correctness target)."""
    csr = generate_stencil(8, 8, 8)
    # random rhs: the generated rhs lies in a tiny Krylov space (symmetric
    # stencil + near-constant row sums) and converges exactly within ~15
    # iterations, making histories degenerate
    b = np.random.default_rng(7).standard_normal(csr.nr)
    hists = {}
    for fmt in ("crs", "sell", "ell", "dia", "bslab"):
        A = from_csr(fmt, csr)
        res = solve_cg(A, b, itermax=60, verbose=False)
        hists[fmt] = res.residual_history
    base = hists["crs"]
    for fmt, h in hists.items():
        # exact-zero convergence iteration may shift by one between formats
        # (different fp reduction orders); compare the common prefix
        assert abs(len(h) - len(base)) <= 1, fmt
        n = min(len(h), len(base))
        np.testing.assert_allclose(
            h[:n], base[:n], rtol=1e-9, atol=1e-12 * base[0], err_msg=fmt
        )


def test_eps_zero_runs_to_itermax():
    csr = generate_stencil(8, 8, 8)
    b = np.random.default_rng(3).standard_normal(csr.nr)
    A = from_csr("crs", csr)
    res = solve_cg(A, b, itermax=25, eps=0.0, verbose=False)
    # reference loop: for k = 1; k < itermax -> itermax-1 iterations, k ends at itermax
    assert res.iterations == 25
    assert len(res.residual_history) == 25


def test_mm_problem_b_ones(test_matrices_dir):
    """Non-generated path: b = 1 (reference initVectors else-branch)."""
    csr = HostCSR.from_coo(read_mm(str(test_matrices_dir / "test0.mtx")))
    # test0 is not symmetric positive definite; just check the solver runs
    # and returns finite history on a general matrix.
    A = from_csr("crs", csr)
    x0, b, xexact = init_vectors(csr, generated=False)
    assert xexact is None
    res = solve_cg(A, b, itermax=5, verbose=False)
    assert np.isfinite(res.residual_history).all()


def test_jacobi_pcg_identity_matches_plain():
    """inv_diag == 1 must reproduce unpreconditioned CG (same recurrence)."""
    csr = generate_stencil(6, 5, 4)
    A = from_csr("crs", csr)
    _, b, xexact = init_vectors(csr)
    plain = solve_cg(A, b, itermax=25, verbose=False)
    pcg = solve_cg(A, b, itermax=25, verbose=False,
                   inv_diag=np.ones(csr.nr))
    n = min(len(plain.residual_history), len(pcg.residual_history))
    np.testing.assert_allclose(
        pcg.residual_history[:n], plain.residual_history[:n], rtol=1e-12
    )


def test_jacobi_pcg_converges_faster_on_scaled_problem():
    """On a badly diagonally-scaled SPD system Jacobi PCG needs far fewer
    iterations for the same residual drop."""
    csr = generate_stencil(6, 6, 6)
    rng = np.random.default_rng(0)
    s = 10.0 ** rng.uniform(-2, 2, csr.nr)  # condition-wrecking scaling
    rows = np.repeat(np.arange(csr.nr), csr.row_lengths)
    scaled = HostCSR(
        row_ptr=csr.row_ptr, col=csr.col,
        val=csr.val * s[rows] * s[csr.col],
        nr=csr.nr, nc=csr.nc,
    )
    A = from_csr("crs", scaled)
    b = np.ones(csr.nr)
    eps = 1e-8 * np.sqrt(csr.nr)
    plain = solve_cg(A, b, itermax=400, eps=eps, verbose=False)
    d = scaled.diagonal()
    pcg = solve_cg(A, b, itermax=400, eps=eps, verbose=False, inv_diag=1.0 / d)
    assert pcg.final_normr <= eps or pcg.iterations < plain.iterations
    assert pcg.iterations < plain.iterations


def test_rcm_cuts_bsell_padding_and_preserves_solution():
    """RCM on a randomly-permuted band matrix restores column locality:
    BSLAB padding (slice slots / nnz) drops and DIA becomes applicable;
    the reordered solve matches the original."""
    from sparsebench.host.rcm import (
        inverse_permutation,
        permute_csr,
        rcm_permutation,
    )

    # needs rows >> 128 and columns spanning several 128-blocks, or BSLAB
    # padding is locality-independent
    base = generate_stencil(32, 8, 8)  # banded 2048-row problem
    rng = np.random.default_rng(7)
    shuffle = rng.permutation(base.nr)
    scrambled = permute_csr(base, shuffle)  # destroys locality

    perm = rcm_permutation(scrambled)
    restored = permute_csr(scrambled, perm)

    A_bad = from_csr("bslab", scrambled)
    A_good = from_csr("bslab", restored)
    assert A_good.padding_ratio < A_bad.padding_ratio

    _, b, _ = init_vectors(scrambled)
    res_bad = solve_cg(A_bad, b, itermax=30, verbose=False)
    res_good = solve_cg(A_good, np.asarray(b)[perm], itermax=30,
                        verbose=False)
    inv = inverse_permutation(perm)
    np.testing.assert_allclose(res_good.x[inv], res_bad.x, atol=1e-8)


def test_rcm_numpy_fallback_matches_scipy_quality():
    """The pure-numpy RCM must produce a valid permutation with comparable
    bandwidth reduction."""
    from sparsebench.host.rcm import _rcm_numpy, permute_csr

    base = generate_stencil(30, 2, 2)
    rng = np.random.default_rng(3)
    scrambled = permute_csr(base, rng.permutation(base.nr))

    def bandwidth(c):
        rows = np.repeat(np.arange(c.nr), c.row_lengths)
        return int(np.abs(rows - c.col).max())

    perm = _rcm_numpy(scrambled)
    assert sorted(perm) == list(range(scrambled.nr))
    restored = permute_csr(scrambled, perm)
    assert bandwidth(restored) < bandwidth(scrambled) / 2


@pytest.mark.parametrize("variant", ["standard", "cs", "pipe"])
@pytest.mark.parametrize("fmt", ["dia", "stencil", "crs"])
def test_cg_parity_across_dia_stencil_crs(fmt, variant):
    """The analytic DIA build, the matrix-free stencil apply and the
    element-parallel CRS run the same math: in f64 every CG variant's
    residual history matches standard CG on CRS to 1e-9 relative."""
    from sparsebench.formats.dia import DiaMatrix
    from sparsebench.formats.stencil import StencilOperator

    nx, ny, nz = 10, 9, 8
    csr = generate_stencil(nx, ny, nz)
    _, b, xexact = init_vectors(csr)
    ref = solve_cg(from_csr("crs", csr), b, itermax=40, verbose=False)
    if fmt == "dia":
        A, _ = DiaMatrix.from_stencil(nx, ny, nz)
    elif fmt == "stencil":
        A, _ = StencilOperator.from_stencil(nx, ny, nz)
    else:
        A = from_csr("crs", csr)
    res = solve_cg(A, b, itermax=40, verbose=False, variant=variant)
    h0 = ref.residual_history[0]
    keep = ref.residual_history > 1e-8 * h0
    n = int(keep.sum())
    err = np.abs(res.residual_history[:n] - ref.residual_history[:n]).max()
    assert err / h0 < 1e-9, (fmt, variant, err / h0)
    assert check_residual(res.x, xexact) < 1e-6


@pytest.mark.parametrize("variant", ["fused", "vmem", "pipelined"])
def test_cg_unknown_variants_rejected(variant):
    csr = generate_stencil(4, 4, 4)
    A = from_csr("crs", csr)
    with pytest.raises(ValueError, match="variant"):
        solve_cg(A, np.ones(csr.nr), itermax=5, verbose=False,
                 variant=variant)
