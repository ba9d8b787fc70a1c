"""RGL (seeded random-graph Laplacian) tests: host spec vs device builder
parity, SPD/exact-solution structure, CG convergence."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sparsebench.config import DTypePolicy
from sparsebench.formats.rgl_build import rgl_bslab
from sparsebench.host.rgl import mix32, rgl_csr

F32 = DTypePolicy.from_names("f32", "i32")


def test_mix32_deterministic_and_spread():
    a = mix32(np.arange(1000), np.arange(1000) + 7, 1)
    b = mix32(np.arange(1000), np.arange(1000) + 7, 1)
    np.testing.assert_array_equal(a, b)
    c = mix32(np.arange(1000), np.arange(1000) + 7, 2)
    assert (a != c).mean() > 0.99
    # roughly uniform: mean near 2^31
    assert abs(a.astype(np.float64).mean() / 2**31 - 1) < 0.1


def test_rgl_csr_structure():
    csr = rgl_csr(800, band=96, deg=8.0, seed=3)
    dense = csr.to_dense()
    np.testing.assert_allclose(dense, dense.T)        # symmetric
    ones = np.ones(800)
    np.testing.assert_allclose(dense @ ones, ones)     # row sums == 1
    d = np.diag(dense)
    off = np.abs(dense).sum(axis=1) - d
    assert np.all(d >= off + 1 - 1e-9)                 # strictly dominant
    avg_deg = (csr.nnz - 800) / 800
    assert 4.0 < avg_deg < 12.0                        # near requested 8


@pytest.mark.parametrize("n,band,deg,sub", [
    (700, 96, 8.0, 8),
    (1500, 200, 10.0, 16),
])
def test_rgl_device_matches_host_oracle(n, band, deg, sub):
    csr = rgl_csr(n, band=band, deg=deg, seed=5)
    A, nnz = rgl_bslab(n, band=band, deg=deg, seed=5, policy=F32, sub=sub)
    assert nnz == csr.nnz
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    y = np.asarray(A.spmv(jnp.asarray(x)))
    want = csr.spmv(x.astype(np.float64))
    assert np.abs(y - want).max() / np.abs(want).max() < 1e-3


def test_rgl_device_jit_matches_oracle():
    n, band = 900, 96
    csr = rgl_csr(n, band=band, deg=6.0, seed=2)
    A, _ = rgl_bslab(n, band=band, deg=6.0, seed=2, policy=F32, sub=8)
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    y = np.asarray(jax.jit(lambda A, x: A.spmv(x))(A, jnp.asarray(x)))
    want = csr.spmv(x.astype(np.float64))
    assert np.abs(y - want).max() / np.abs(want).max() < 1e-3


def test_rgl_exact_solution_is_ones():
    """b = A @ 1 == 1 on device — the CG oracle needs no row counts."""
    A, _ = rgl_bslab(1000, band=128, deg=8.0, seed=1, policy=F32, sub=8)
    y = np.asarray(A.spmv(jnp.ones(1000, jnp.float32)))
    np.testing.assert_allclose(y, 1.0, atol=1e-3)


def test_rgl_cg_converges():
    from sparsebench.solvers.cg import check_residual, solve_cg

    n = 1200
    A, _ = rgl_bslab(n, band=128, deg=8.0, seed=4, policy=F32, sub=8)
    b = np.ones(n, dtype=np.float32)
    res = solve_cg(A, b, itermax=300, eps=1e-7, verbose=False)
    assert check_residual(res.x, np.ones(n)) < 1e-4


@pytest.mark.parametrize("band", [0, 256, 300])
def test_rgl_rejects_bad_band(band):
    with pytest.raises(ValueError, match="band must be"):
        rgl_bslab(256, band=band, deg=4.0, seed=1, policy=F32, sub=8)


# ------------------------------------------------- wide-slice overflow pool


def test_rgl_wide_forced_caps_matches_oracle_xla():
    """force_caps=1 per bucket pushes most entries into WIDE slices —
    maximal exercise of the per-element block-delta path."""
    n, band = 700, 96
    csr = rgl_csr(n, band=band, deg=8.0, seed=5)
    nD = 2 * ((band + 127) // 128) + 1
    A, nnz = rgl_bslab(n, band=band, deg=8.0, seed=5, policy=F32, sub=8, force_caps=(1,) * nD)
    assert nnz == csr.nnz
    assert A.s_wide > 0 and A.wide_k == nD
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    y = np.asarray(A.spmv(jnp.asarray(x)))
    want = csr.spmv(x.astype(np.float64))
    assert np.abs(y - want).max() / np.abs(want).max() < 1e-3


def test_rgl_wide_forced_caps_jit():
    """Caps of 2 per bucket under jit: the block-delta gather of the
    overflow pool must agree with the oracle."""
    n, band = 900, 96
    csr = rgl_csr(n, band=band, deg=6.0, seed=2)
    nD = 2 * ((band + 127) // 128) + 1
    A, _ = rgl_bslab(n, band=band, deg=6.0, seed=2, policy=F32, sub=8, force_caps=(2,) * nD)
    assert A.s_wide > 0
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    y = np.asarray(jax.jit(lambda A, x: A.spmv(x))(A, jnp.asarray(x)))
    want = csr.spmv(x.astype(np.float64))
    assert np.abs(y - want).max() / np.abs(want).max() < 1e-3


def test_rgl_wide_other_seed():
    """Wide slices on another graph of the family."""
    n, band = 700, 96
    csr = rgl_csr(n, band=band, deg=8.0, seed=7)
    nD = 2 * ((band + 127) // 128) + 1
    A, _ = rgl_bslab(n, band=band, deg=8.0, seed=7, policy=F32, sub=8, force_caps=(1,) * nD)
    x = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    y = np.asarray(A.spmv(jnp.asarray(x)))
    want = csr.spmv(x.astype(np.float64))
    assert np.abs(y - want).max() / np.abs(want).max() < 1e-3


def test_rgl_tail_auto_reduces_padding_and_matches():
    """The quantile+wide build (fewest stored bytes) must (a) agree with
    the exact-cap build's SpMV and (b) never store MORE than it."""
    n, band = 4096, 128
    At, _ = rgl_bslab(n, band=band, deg=12.0, seed=9, policy=F32, sub=8, tail=True)
    Ax, _ = rgl_bslab(n, band=band, deg=12.0, seed=9, policy=F32, sub=8, tail=False)
    assert Ax.s_wide == 0
    x = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    yt = np.asarray(At.spmv(jnp.asarray(x)))
    yx = np.asarray(Ax.spmv(jnp.asarray(x)))
    assert np.abs(yt - yx).max() <= 1e-5 * np.abs(yx).max()
    assert At.n_elems <= Ax.n_elems


def test_rgl_wide_cg_converges():
    from sparsebench.solvers.cg import check_residual, solve_cg

    n, nD = 1200, 3
    A, _ = rgl_bslab(n, band=128, deg=8.0, seed=4, policy=F32, sub=8, force_caps=(1,) * nD)
    assert A.s_wide > 0
    b = np.ones(n, dtype=np.float32)
    res = solve_cg(A, b, itermax=300, eps=1e-7, verbose=False)
    assert check_residual(res.x, np.ones(n)) < 1e-4


@pytest.mark.parametrize("span", [2, 3])
@pytest.mark.parametrize("sub", [8, 16])
def test_rgl_grouped_pools_match_oracle(span, sub):
    """Span-limited overflow pools: force tiny per-bucket caps so most
    entries overflow into span-K pools with per-group anchors, and check
    exact parity with the host CSR."""
    n, band, deg = 900, 128, 10.0
    nD = (band + 127) // 128 + (127 + band) // 128 + 1
    csr = rgl_csr(n, band=band, deg=deg, seed=11)
    A, nnz = rgl_bslab(n, band=band, deg=deg, seed=11, policy=F32, sub=sub,
                       force_caps=(1,) * nD, force_span=span)
    assert nnz == csr.nnz
    assert A.s_wide > 0 and A.wide_k == span
    x = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    y = np.asarray(A.spmv(jnp.asarray(x)))
    want = csr.spmv(x.astype(np.float64))
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-4 * np.abs(
        want).max())


def test_rgl_grouped_pools_pack_denser_than_single():
    """The span-K pools must not store more slices than the legacy
    single pool at the same caps (per-group maxima can only decrease
    the per-pool capacity bound... their SUM can exceed the single-pool
    max; what must hold is layout validity plus a smaller gather cost:
    span * s_wide_grouped vs nD * s_wide_single)."""
    n, band, deg = 1200, 128, 10.0
    nD = (band + 127) // 128 + (127 + band) // 128 + 1
    caps = (2,) * nD
    A1, _ = rgl_bslab(n, band=band, deg=deg, seed=3, policy=F32, sub=8, force_caps=caps)
    A2, _ = rgl_bslab(n, band=band, deg=deg, seed=3, policy=F32, sub=8, force_caps=caps, force_span=2)
    assert A1.wide_k == nD and A2.wide_k == 2
    assert 2 * A2.s_wide < nD * max(A1.s_wide, 1) or A2.s_wide == 0
    x = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(A1.spmv(jnp.asarray(x))),
        np.asarray(A2.spmv(jnp.asarray(x))), rtol=0, atol=1e-5)
