"""bf16 value-dtype solver behavior (--dtype bf16).

The CLI accepts bf16 values (half the matrix/vector bytes) but an
8-bit mantissa cannot carry solver
reductions: CG accumulates scalars in f32 by default
(solvers/cg.py default_acc_dtype), GMRES/Chebyshev upcast their working
vectors to f32 (matrix storage stays bf16). Before those defaults, a
bf16 CG run crashed formatting the residual history and its dots were
bf16 garbage. Tolerances here reflect bf16 attainable accuracy
(machine eps 2^-8 = 0.0039; calibrated against measured CPU runs).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from sparsebench.config import DTypePolicy
from sparsebench.formats import from_csr
from sparsebench.host import generate_stencil
from sparsebench.solvers.cg import check_residual, init_vectors, solve_cg

BF16 = DTypePolicy.from_names("bf16", "i32")


def _problem():
    csr = generate_stencil(8, 8, 8)
    A = from_csr("crs", csr, BF16)
    _x0, b, xe = init_vectors(csr, dtype=np.dtype(jnp.bfloat16))
    return A, b, xe


@pytest.mark.parametrize("variant,tol", [
    ("standard", 0.08), ("cs", 0.08), ("pipe", 0.15), ("sstep", 0.5),
])
def test_cg_bf16_converges(variant, tol):
    A, b, xe = _problem()
    res = solve_cg(A, b, itermax=100, eps=0.0, variant=variant,
                   verbose=False)
    assert np.all(np.isfinite(np.asarray(res.x, dtype=np.float32)))
    assert check_residual(res.x, xe) < tol
    # the history must be a widened dtype (bf16 history broke :E
    # formatting and cannot represent deep residuals)
    assert res.residual_history.dtype == np.float32


def test_gmres_bf16_matrix_f32_vectors():
    from sparsebench.solvers.gmres import solve_gmres

    A, b, xe = _problem()
    res = solve_gmres(A, np.asarray(b, dtype=np.float32), itermax=60,
                      eps=1e-3, verbose=False)
    assert res.final_normr < 1e-2
    # the bf16-rounded matrix itself perturbs the solution away from
    # exact ones by ~eps_bf16 x conditioning
    assert np.abs(np.asarray(res.x, np.float32) - 1.0).max() < 0.05


def test_cheb_bf16_matrix_f32_vectors():
    from sparsebench.solvers.chebyshev import solve_chebyshev

    A, b, xe = _problem()
    res = solve_chebyshev(A, np.asarray(b, dtype=np.float32), itermax=200,
                          eps=1e-3, verbose=False)
    assert res.final_normr < 1e-2


def test_bf16_x_through_dia_pallas_kernel():
    """bf16 x through DIA: the product stays in the x dtype (bf16 in,
    bf16 out) and agrees with the dense product to bf16 accuracy."""
    import jax.numpy as jnp

    csr = generate_stencil(6, 6, 6)
    A = from_csr("dia", csr, BF16)
    x = jnp.asarray(
        np.random.default_rng(0).standard_normal(A.nc), jnp.bfloat16
    )
    y = A.spmv(x)
    assert y.dtype == jnp.bfloat16
    want = csr.to_dense() @ np.asarray(x[: csr.nr], np.float32)
    err = np.abs(np.asarray(y, np.float32) - want).max()
    assert err < 0.02 * np.abs(want).max()


def test_cli_bf16_cg(capsys):
    """--dtype bf16 -t cg end-to-end (this crashed on residual
    formatting before f32 accumulation)."""
    from sparsebench.cli import main

    rc = main(["-t", "cg", "-x", "8", "-y", "8", "-z", "8", "-i", "60",
               "--dtype", "bf16", "--fmt", "crs"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Initial Residual" in out


def test_cli_bf16_gmres(capsys):
    from sparsebench.cli import main

    rc = main(["-t", "gmres", "-x", "6", "-y", "6", "-z", "4", "-i", "40",
               "-e", "1e-3", "--dtype", "bf16", "--fmt", "crs"])
    assert rc == 0
