"""Blocked (multi-RHS) CG tests (solvers/cg_multi.py — beyond the
reference, which solves one right-hand side, src/CGSolver.c).

Oracles: per-column parity with k independent single-RHS ``solve_cg``
runs, the analytic exact solution of the generated problem, and a dense
numpy solve for random right-hand sides.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sparsebench.formats import from_csr
from sparsebench.host import generate_stencil
from sparsebench.solvers.cg import check_residual, init_vectors, solve_cg
from sparsebench.solvers.cg_multi import make_spmm, solve_cg_multi

jax.config.update("jax_enable_x64", True)


def _rhs_block(csr, k=4, seed=0):
    rng = np.random.default_rng(seed)
    _x0, b, _xe = init_vectors(csr)
    B = rng.standard_normal((b.shape[0], k))
    B[:, 0] = b  # column 0 = the reference's generated rhs
    return B


@pytest.mark.parametrize("fmt", ["dia", "crs", "bslab"])
def test_spmm_matches_stacked_spmv(fmt):
    csr = generate_stencil(6, 5, 4)
    A = from_csr(fmt, csr)
    B = _rhs_block(csr, k=3)
    spmm = make_spmm(A)
    got = np.asarray(jax.jit(spmm)(jnp.asarray(B)))
    for j in range(B.shape[1]):
        want = np.asarray(jax.jit(A.spmv)(jnp.asarray(B[:, j])))
        np.testing.assert_allclose(got[:, j], want, rtol=1e-13,
                                   err_msg=f"{fmt} column {j}")


def test_spmm_sell_permuted_space():
    """The vmap fallback applies row-permuting formats in permuted space;
    composing with the perm must reproduce original-order spmv."""
    csr = generate_stencil(5, 4, 3)
    A = from_csr("sell", csr, C=4, sigma=8)
    B = _rhs_block(csr, k=2)
    spmm = make_spmm(A)
    Bp = jax.vmap(A.permute_vector, in_axes=1, out_axes=1)(jnp.asarray(B))
    got = jax.vmap(A.unpermute_vector, in_axes=1, out_axes=1)(spmm(Bp))
    for j in range(B.shape[1]):
        want = np.asarray(jax.jit(A.spmv)(jnp.asarray(B[:, j])))
        np.testing.assert_allclose(np.asarray(got)[:, j], want, rtol=1e-13)


def test_spmm_vmap_over_pallas():
    """The make_spmm fallback vmaps the format's single-vector spmv (bslab
    has no native multi-RHS product): every column must equal its own
    spmv."""
    csr = generate_stencil(6, 5, 4, dtype=np.float32)
    A = from_csr("bslab", csr)
    B = _rhs_block(csr, k=3).astype(np.float32)
    spmm = make_spmm(A)
    got = np.asarray(spmm(jnp.asarray(B)))
    for j in range(B.shape[1]):
        want = np.asarray(A.spmv(jnp.asarray(B[:, j])))
        np.testing.assert_allclose(got[:, j], want, rtol=1e-5,
                                   err_msg=f"column {j}")


def test_spmm_kn_pallas_dia_matches_oracle():
    """DIA's native multi-RHS product (one pass per diagonal over the
    (k, n) slab) against the CSR oracle, with bf16-compressed and with
    f32 diagonals."""
    csr = generate_stencil(8, 7, 5, dtype=np.float32)
    from sparsebench.config import DTypePolicy

    pol = DTypePolicy.from_names("f32", "i32")
    Ap = from_csr("dia", csr, pol)
    Ax = from_csr("dia", csr, pol, compress=False)
    assert Ap.data.dtype == jnp.bfloat16 and Ax.data.dtype == jnp.float32
    rng = np.random.default_rng(5)
    Xkn = rng.standard_normal((4, csr.nr)).astype(np.float32)
    got = np.asarray(Ap.spmm_kn(jnp.asarray(Xkn)))
    xla = np.asarray(Ax.spmm_kn(jnp.asarray(Xkn)))
    for j in range(4):
        want = csr.spmv(Xkn[j].astype(np.float64))
        np.testing.assert_allclose(got[j], want, rtol=1e-4, atol=1e-4,
                                   err_msg=f"bf16-diagonal row {j}")
        np.testing.assert_allclose(xla[j], want, rtol=1e-4, atol=1e-4,
                                   err_msg=f"f32-diagonal row {j}")


@pytest.mark.parametrize("fmt", ["dia", "crs"])
def test_cg_multi_matches_independent_solves(fmt):
    """Per-column iterates are the single-RHS recurrence exactly: f64
    histories and solutions must match k separate solve_cg runs to
    reduction-order rounding (same bar as cross-variant parity)."""
    csr = generate_stencil(7, 6, 5)
    A = from_csr(fmt, csr)
    B = _rhs_block(csr, k=3, seed=1)
    res = solve_cg_multi(A, B, itermax=40, eps=0.0, verbose=False)
    assert res.x.shape == B.shape
    for j in range(B.shape[1]):
        single = solve_cg(A, B[:, j], itermax=40, eps=0.0, verbose=False)
        np.testing.assert_allclose(
            res.residual_history[: single.iterations, j],
            single.residual_history,
            rtol=1e-9, atol=1e-13 * single.residual_history[0],
            err_msg=f"{fmt} column {j} history",
        )
        np.testing.assert_allclose(res.x[:, j], single.x, rtol=1e-8,
                                   atol=1e-10, err_msg=f"{fmt} column {j}")


def test_cg_multi_generated_problem_exact_solution():
    csr = generate_stencil(8, 8, 8)
    _x0, b, xexact = init_vectors(csr)
    A = from_csr("dia", csr)
    B = np.stack([b, 2.0 * b], axis=1)  # solutions: 1 and 2
    res = solve_cg_multi(A, B, itermax=200, eps=1e-9, verbose=False)
    assert check_residual(res.x[:, 0], xexact) < 1e-7
    assert check_residual(res.x[:, 1], 2.0 * xexact) < 1e-7


def test_cg_multi_per_column_convergence_mask():
    """Columns stop independently: an easy column (rhs scaled tiny, same
    eps) must freeze at fewer iterations than a hard one, and frozen
    history slots read NaN."""
    csr = generate_stencil(6, 6, 6)
    _x0, b, _xe = init_vectors(csr)
    rng = np.random.default_rng(7)
    hard = rng.standard_normal(b.shape[0])
    B = np.stack([1e-8 * b, hard], axis=1)
    res = solve_cg_multi(A := from_csr("crs", csr), B, itermax=150,
                         eps=1e-6, verbose=False)
    hist = res.residual_history
    iters = [int(np.sum(~np.isnan(hist[:, j]))) for j in range(2)]
    assert iters[0] < iters[1], iters
    assert np.isnan(hist[iters[0], 0]) and not np.isnan(hist[iters[0], 1])
    # each column still matches its independent solve
    for j in range(2):
        single = solve_cg(A, B[:, j], itermax=150, eps=1e-6, verbose=False)
        np.testing.assert_allclose(res.x[:, j], single.x, rtol=1e-8,
                                   atol=1e-12)


def test_cg_multi_sell_permutation_roundtrip():
    csr = generate_stencil(6, 5, 4)
    _x0, b, xexact = init_vectors(csr)
    A = from_csr("sell", csr, C=4, sigma=8)
    B = np.stack([b, -b], axis=1)
    res = solve_cg_multi(A, B, itermax=120, eps=1e-10, verbose=False)
    assert check_residual(res.x[:, 0], xexact) < 1e-7
    assert check_residual(res.x[:, 1], -xexact) < 1e-7


def test_cg_multi_bf16_storage_f32_accumulate():
    """bf16 value dtype follows the package discipline: slab vectors in
    bf16, reductions in f32 (default_acc_dtype); converges to bf16-class
    accuracy on the generated problem."""
    csr = generate_stencil(6, 6, 6)
    _x0, b, xexact = init_vectors(csr, dtype=np.float32)
    from sparsebench.config import DTypePolicy

    A = from_csr("dia", csr, DTypePolicy.from_names("bf16", "i32"))
    B = jnp.asarray(np.stack([b, b], axis=1), jnp.bfloat16)
    res = solve_cg_multi(A, B, itermax=100, eps=0.0, verbose=False)
    err = check_residual(res.x.astype(np.float32)[:, 0],
                         xexact.astype(np.float32))
    assert err < 0.1, err
