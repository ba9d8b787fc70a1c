"""Checkpoint / resume tests: segmented solves must be bit-identical to
uninterrupted ones, and resume-after-kill must reproduce the history."""

import numpy as np

import jax

from sparsebench.formats import from_csr
from sparsebench.host import generate_stencil
from sparsebench.solvers.cg import init_vectors, solve_cg
from sparsebench.solvers.checkpoint import (
    load_state,
    save_state,
    solve_cg_checkpointed,
)

jax.config.update("jax_enable_x64", True)


def test_segmented_equals_fused(tmp_path):
    csr = generate_stencil(6, 6, 6)
    b = np.random.default_rng(0).standard_normal(csr.nr)
    A = from_csr("crs", csr)
    ref = solve_cg(A, b, itermax=40, verbose=False)
    ck = str(tmp_path / "cg.ckpt")
    seg = solve_cg_checkpointed(
        A, b, checkpoint_path=ck, checkpoint_every=7, itermax=40, verbose=False
    )
    assert seg.iterations == ref.iterations
    np.testing.assert_array_equal(seg.residual_history, ref.residual_history)
    np.testing.assert_array_equal(seg.x, ref.x)


def test_resume_after_interrupt(tmp_path):
    csr = generate_stencil(6, 6, 6)
    b = np.random.default_rng(1).standard_normal(csr.nr)
    A = from_csr("sell", csr)
    ck = str(tmp_path / "cg.ckpt")

    # run only the first 10 iterations, "crash", then resume to 40
    partial_run = solve_cg_checkpointed(
        A, b, checkpoint_path=ck, checkpoint_every=10, itermax=10, verbose=False
    )
    assert partial_run.iterations == 10
    resumed = solve_cg_checkpointed(
        A, b, checkpoint_path=ck, checkpoint_every=10, itermax=40, verbose=False
    )
    ref = solve_cg(A, b, itermax=40, verbose=False)
    np.testing.assert_array_equal(resumed.residual_history, ref.residual_history)
    np.testing.assert_array_equal(resumed.x, ref.x)


def test_state_roundtrip(tmp_path):
    import jax.numpy as jnp

    state = (
        jnp.asarray(5),
        jnp.ones(10),
        jnp.zeros(12),
        jnp.full(10, 2.0),
        jnp.asarray(1.5),
        jnp.asarray(1.2),
        jnp.full(20, np.nan),
        jnp.asarray(False),
    )
    p = str(tmp_path / "s.npz")
    save_state(p, state)
    back = load_state(p)
    for a, b_ in zip(state, back):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))
