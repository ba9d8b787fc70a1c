"""Mixed-precision iterative-refinement CG (solvers/refine.py).

Oracles: the dense solve (f64 ladder must reach near-machine f64
accuracy from an f32 inner solver); the generated problem's exact
solution x == 1 (f32 ladder with bf16 inner); the reported residual is
the TRUE ||b - A x|| recomputed independently; the loop stops on
stagnation at the inner precision's floor instead of burning sweeps;
distributed runs match serial to rounding.
"""

import numpy as np
import pytest

import jax

from sparsebench.config import DTypePolicy
from sparsebench.formats import from_csr
from sparsebench.host import generate_stencil
from sparsebench.solvers.refine import (
    refine_lo_dtype,
    refine_lo_policy,
    solve_cg_refine,
)

jax.config.update("jax_enable_x64", True)

F64 = DTypePolicy.from_names("f64", "i32")
F32 = DTypePolicy.from_names("f32", "i32")


def _pair(fmt="crs", n=(10, 10, 10), hi=F64, lo=F32, **opts):
    csr = generate_stencil(*n)
    return csr, from_csr(fmt, csr, hi, **opts), from_csr(fmt, csr, lo,
                                                         **opts)


# ------------------------------------------------------------- ladder map

def test_lo_dtype_ladder():
    import jax.numpy as jnp

    assert refine_lo_dtype(jnp.float64) == jnp.float32
    assert refine_lo_dtype(jnp.float32) == jnp.bfloat16
    with pytest.raises(ValueError, match="headroom"):
        refine_lo_dtype(jnp.bfloat16)


def test_lo_policy_keeps_index_dtype():
    lo, name = refine_lo_policy(DTypePolicy.from_names("f64", "i64"))
    assert name == "f32" and lo.index == np.int64
    lo, name = refine_lo_policy(F32)
    assert name == "bf16"
    with pytest.raises(ValueError, match="headroom"):
        refine_lo_policy(DTypePolicy.from_names("bf16", "i32"))


# ----------------------------------------------------------------- serial

def test_f64_ladder_reaches_f64_accuracy():
    """f32 inner CG + f64 outer residual = f64 solution accuracy: the
    whole point of refinement (Carson & Higham 2018 regime)."""
    csr, A_hi, A_lo = _pair()
    b = np.random.default_rng(0).standard_normal(csr.nr)
    res = solve_cg_refine(A_hi, b, A_lo=A_lo, eps=1e-11, verbose=False)
    x_ref = np.linalg.solve(csr.to_dense(), b)
    assert res.final_normr <= 1e-11
    assert np.abs(res.x - x_ref).max() < 1e-11 * np.abs(x_ref).max()
    # most iterations ran in low precision: a handful of sweeps only
    assert 2 <= len(res.residual_history) - 1 <= 12


def test_f32_ladder_recovers_exact_solution():
    csr = generate_stencil(10, 10, 10)
    A_hi = from_csr("crs", csr, F32)
    A_lo = from_csr("crs", csr, DTypePolicy.from_names("bf16", "i32"))
    b = (27.0 - (csr.row_lengths - 1)).astype(np.float32)
    res = solve_cg_refine(A_hi, b, A_lo=A_lo, eps=0.0, verbose=False)
    assert np.abs(res.x - 1.0).max() < 1e-5


def test_reported_residual_is_true():
    csr, A_hi, A_lo = _pair(n=(8, 8, 8))
    b = np.random.default_rng(1).standard_normal(csr.nr)
    res = solve_cg_refine(A_hi, b, A_lo=A_lo, eps=1e-9, verbose=False)
    true = np.linalg.norm(b - csr.to_dense() @ res.x)
    np.testing.assert_allclose(res.final_normr, true, rtol=1e-6,
                               atol=1e-13 * np.linalg.norm(b))
    # the history is monotone true residuals
    h = res.residual_history
    assert all(h[i + 1] < h[i] for i in range(len(h) - 1))


def test_stagnation_stops_early():
    """eps=0 runs to the low precision's floor, then the stall guard
    exits — well before the sweep budget."""
    csr = generate_stencil(8, 8, 8)
    A = from_csr("crs", csr, F32)
    A_lo = from_csr("crs", csr, DTypePolicy.from_names("bf16", "i32"))
    b = (27.0 - (csr.row_lengths - 1)).astype(np.float32)
    res = solve_cg_refine(A, b, A_lo=A_lo, eps=0.0, outer_max=30,
                          verbose=False)
    sweeps = len(res.residual_history) - 1
    assert sweeps < 12  # floor is hit in a handful of sweeps
    assert res.final_normr < 1e-3  # and it IS near the f32-update floor


def test_defaults_to_same_operator():
    """A_lo=None falls back to A_hi — exact for dtype-agnostic operators
    (stencil); the refinement still converges (inner vectors are lo)."""
    from sparsebench.formats.stencil import StencilOperator

    A, rc = StencilOperator.from_stencil(8, 8, 8, policy=F32)
    b = (27.0 - (rc - 1)).astype(np.float32)
    res = solve_cg_refine(A, b, eps=0.0, verbose=False)
    assert np.abs(res.x - 1.0).max() < 1e-5


def test_permuted_format_matches_crs():
    """Row-permuting lo/hi builds (sell): permutation handled once in the
    driver, result matches the crs ladder."""
    csr = generate_stencil(8, 8, 8)
    b = np.random.default_rng(2).standard_normal(csr.nr)
    ref = solve_cg_refine(from_csr("crs", csr, F64), b,
                          A_lo=from_csr("crs", csr, F32),
                          eps=1e-10, verbose=False)
    res = solve_cg_refine(
        from_csr("sell", csr, F64, chunk_height=8, sigma=16), b,
        A_lo=from_csr("sell", csr, F32, chunk_height=8, sigma=16),
        eps=1e-10, verbose=False,
    )
    np.testing.assert_allclose(res.x, ref.x, rtol=1e-8, atol=1e-12)


def test_rejects_bf16_b():
    import jax.numpy as jnp

    csr = generate_stencil(5, 5, 5)
    A = from_csr("crs", csr, F32)
    with pytest.raises(ValueError, match="f32/f64"):
        solve_cg_refine(A, jnp.ones(csr.nr, jnp.bfloat16), verbose=False)


# ------------------------------------------------------------ distributed

def test_dist_refine_matches_serial():
    from sparsebench.parallel.dist import (
        DistMatrix,
        build_distributed,
        dist_solve_cg_refine,
    )

    size = 4
    shards = [generate_stencil(8, 8, 2, rank=r, size=size)
              for r in range(size)]
    csr = generate_stencil(8, 8, 2 * size)
    b = np.random.default_rng(3).standard_normal(csr.nr)
    serial = solve_cg_refine(from_csr("crs", csr, F64), b,
                             A_lo=from_csr("crs", csr, F32),
                             eps=1e-11, verbose=False)

    dm = build_distributed(shards, fmt="crs", policy=F64)
    dm_lo = DistMatrix(dm.part, "crs", F32, mesh=dm.mesh)
    d = dist_solve_cg_refine(dm, b, dm_lo=dm_lo, eps=1e-11, verbose=False)
    assert len(d.residual_history) == len(serial.residual_history)
    np.testing.assert_allclose(d.x, serial.x, rtol=1e-10, atol=1e-13)


def test_dist_refine_stencil():
    from sparsebench.parallel.stencil_dist import (
        build_halo_stencil,
        dist_solve_cg_refine_stencil,
    )

    size = 4
    nx, ny, nz = 8, 8, 2
    A, counts = build_halo_stencil(nx, ny, nz, size)
    b = (27.0 - (counts - 1)).astype(np.float32)
    res = dist_solve_cg_refine_stencil(A, size, b, eps=0.0, verbose=False)
    assert np.abs(res.x - 1.0).max() < 1e-5


# --------------------------------------------------------------- CLI

def test_cli_refine(capsys):
    from sparsebench.cli import main

    rc = main(["-t", "cg", "-x", "8", "-y", "8", "-z", "8", "-i", "100",
               "-e", "1e-4", "--refine"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "inner CG in bf16" in out
    assert "Refinement sweep = 1" in out
    assert "Difference between computed and exact" in out


def test_cli_refine_sharded(capsys):
    from sparsebench.cli import main

    rc = main(["-t", "cg", "-x", "6", "-y", "6", "-z", "2", "-i", "100",
               "-e", "1e-10", "--dtype", "f64", "--fmt", "crs",
               "--shards", "4", "--refine"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "inner CG in f32" in out


def test_cli_refine_stencil_sharded(capsys):
    from sparsebench.cli import main

    rc = main(["-t", "cg", "-x", "6", "-y", "6", "-z", "2", "-i", "100",
               "-e", "1e-4", "--fmt", "stencil", "--shards", "4",
               "--refine"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "matrix-free" in out and "Refinement sweep" in out


def test_cli_refine_rejects_combos():
    from sparsebench.cli import main

    for extra in (["--precond", "jacobi"], ["--cg-variant", "cs"],
                  ["--profile"]):
        with pytest.raises(SystemExit, match="plain CG path"):
            main(["-t", "cg", "-x", "5", "-y", "5", "-z", "5",
                  "--refine", *extra])


def test_cli_refine_warnings(capsys):
    from sparsebench.cli import main

    rc = main(["-t", "gmres", "-x", "5", "-y", "5", "-z", "5", "-i", "20",
               "--refine"])
    err = capsys.readouterr().err
    assert rc == 0
    assert "--refine has no effect with -t gmres" in err

    rc = main(["-t", "cg", "-x", "5", "-y", "5", "-z", "5", "-i", "20",
               "--refine-sweeps", "5"])
    err = capsys.readouterr().err
    assert rc == 0
    assert "--refine-sweeps has no effect" in err


def test_cli_refine_rejects_bf16():
    from sparsebench.cli import main

    with pytest.raises((SystemExit, ValueError), match="headroom"):
        main(["-t", "cg", "-x", "5", "-y", "5", "-z", "5", "--dtype",
              "bf16", "--refine"])
