"""The solver jit cache (solvers/_jitcache.py) must make repeat solves on
the same operator reuse the compiled loop instead of recompiling — the
round-4 GMRES finding: a fresh jax.jit(partial(...)) per solve call paid a
full XLA compile every time (~20 s at 100^3 on the chip), and the
second-run-is-warm bench convention silently measured compile time."""

import numpy as np
import pytest

from sparsebench.config import DTypePolicy
from sparsebench.solvers._jitcache import _cached, jit_loop


@pytest.fixture()
def stencil_a():
    from sparsebench.formats.dia import DiaMatrix

    policy = DTypePolicy.from_names("f32", "i32")
    A, _ = DiaMatrix.from_stencil(6, 5, 4, policy=policy)
    return A


def test_jit_loop_returns_same_object_for_equal_knobs():
    def loop(x, k=1):
        return x * k

    a = jit_loop(loop, k=3)
    b = jit_loop(loop, k=3)
    assert a is b
    assert jit_loop(loop, k=4) is not a


def test_jit_loop_unhashable_falls_back_uncached():
    def loop(x, tag=None):
        return x

    # a list is unhashable: must still return a working jitted callable
    f = jit_loop(loop, tag=[1, 2])
    assert float(f(np.float32(2.0))) == 2.0


def test_repeat_cg_solves_share_compiled_loop(stencil_a):
    from sparsebench.solvers.cg import solve_cg

    b = np.ones(stencil_a.nr, np.float32)
    h0 = _cached.cache_info().hits
    r1 = solve_cg(stencil_a, b, itermax=10, eps=0.0, verbose=False)
    r2 = solve_cg(stencil_a, b, itermax=10, eps=0.0, verbose=False)
    # the second solve must have HIT the loop cache (the first may hit or
    # miss depending on test order; the delta is what matters)
    assert _cached.cache_info().hits > h0
    np.testing.assert_allclose(r1.x, r2.x)


def test_repeat_gmres_solves_hit_cycle_trace_cache(stencil_a):
    from sparsebench.solvers.gmres import _CYCLE_JIT, solve_gmres

    b = np.ones(stencil_a.nr, np.float32)
    r1 = solve_gmres(stencil_a, b, itermax=20, restart=10, verbose=False)
    n_traced = _CYCLE_JIT._cache_size()
    r2 = solve_gmres(stencil_a, b, itermax=20, restart=10, verbose=False)
    # the second solve must not have traced a new cycle executable
    assert _CYCLE_JIT._cache_size() == n_traced
    assert r2.final_normr == pytest.approx(r1.final_normr, rel=1e-5)


def test_bound_method_statics_key_by_object(stencil_a):
    # two accesses of the same bound method are EQUAL -> one cache entry
    def loop(x, op=None):
        return op(x)

    a = jit_loop(loop, op=stencil_a.spmv)
    b = jit_loop(loop, op=stencil_a.spmv)
    assert a is b
