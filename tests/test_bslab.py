"""BSLAB (slab-table) format tests: layout correctness against the CSR
oracle across builders (host CSR, analytic stencil) and slice heights."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sparsebench.config import DTypePolicy
from sparsebench.formats import from_csr
from sparsebench.formats.bslab import BslabMatrix
from sparsebench.host import HostCSR, generate_stencil, read_mm
from sparsebench.solvers.cg import check_residual, init_vectors, solve_cg

jax.config.update("jax_enable_x64", True)

F32 = DTypePolicy.from_names("f32", "i32")


def random_csr(nr, nc, density, seed, band=None):
    rng = np.random.default_rng(seed)
    mask = rng.random((nr, nc)) < density
    if band is not None:
        i = np.arange(nr)[:, None]
        j = np.arange(nc)[None, :]
        mask &= np.abs(i - j) <= band
    dense = np.where(mask, rng.standard_normal((nr, nc)), 0.0)
    from sparsebench.host.coo import COOMatrix

    r, c = np.nonzero(dense)
    return HostCSR.from_coo(
        COOMatrix(row=r, col=c, val=dense[r, c], nr=nr, nc=nc)
    ), dense


CASES = [
    ("stencil", lambda: (generate_stencil(5, 4, 3), None)),
    ("random", lambda: random_csr(300, 300, 0.02, 0)),
    ("banded", lambda: random_csr(500, 500, 0.3, 1, band=40)),
    ("rect", lambda: random_csr(130, 260, 0.05, 2)),
    ("tall", lambda: random_csr(2100, 2100, 0.004, 3)),
]


@pytest.mark.parametrize("name,make", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("sub", [8, 16, 64])
def test_bslab_spmv_matches_csr(name, make, sub):
    out = make()
    csr = out[0] if isinstance(out, tuple) else out
    A = BslabMatrix.from_csr(csr, F32, sub=sub)
    rng = np.random.default_rng(42)
    x = rng.standard_normal(csr.nc).astype(np.float32)
    y = np.asarray(jax.jit(lambda A, x: A.spmv(x))(A, jnp.asarray(x)))
    want = csr.spmv(x.astype(np.float64))
    scale = max(np.abs(want).max(), 1.0)
    assert y.shape == (csr.nr,)
    assert np.abs(y - want).max() / scale < 2e-2  # bf16 storage tolerance


@pytest.mark.parametrize("sub", [8, 16, 32])
def test_bslab_sub_heights_match_csr(sub):
    """Explicit slice heights (the perf lever) keep exactness."""
    csr, _ = random_csr(2100, 2100, 0.004, 7)
    A = BslabMatrix.from_csr(csr, F32, sub=sub)
    assert A.sub == sub
    x = np.random.default_rng(0).standard_normal(csr.nc).astype(np.float32)
    y = np.asarray(jax.jit(lambda A, x: A.spmv(x))(A, jnp.asarray(x)))
    want = csr.spmv(x.astype(np.float64))
    assert np.abs(y - want).max() / max(np.abs(want).max(), 1) < 2e-2


def test_bslab_uncompressed_matches_exactly():
    csr, _ = random_csr(300, 300, 0.02, 5)
    A = BslabMatrix.from_csr(csr, F32, compress=False)
    x = np.random.default_rng(0).standard_normal(csr.nc).astype(np.float32)
    y = np.asarray(A.spmv(jnp.asarray(x)))
    want = csr.spmv(x.astype(np.float64))
    assert np.abs(y - want).max() / max(np.abs(want).max(), 1) < 1e-5


def test_bslab_separated_diagonals_classify_affine():
    """Slices whose entries come from one diagonal share a single rotation
    r = (col - row) & 127 — classified affine, no stored index plane.
    (Dense multi-diagonal buckets legitimately classify general: the j-th
    occupant of a bucket varies per lane near boundaries.)"""
    n = 400
    from sparsebench.host.coo import COOMatrix

    rows = np.arange(n)
    r2 = rows[rows + 200 < n]
    coo = COOMatrix(
        row=np.concatenate([rows, r2]),
        col=np.concatenate([rows, r2 + 200]),
        val=np.ones(n + r2.size),
        nr=n, nc=n,
    )
    A = BslabMatrix.from_csr(HostCSR.from_coo(coo.sort_row_major()), F32)
    assert A.s_gen == 0
    assert A.lidx_gen.size == 0
    y = np.asarray(A.spmv(jnp.ones(n, jnp.float32)))
    want = HostCSR.from_coo(coo.sort_row_major()).spmv(np.ones(n))
    assert np.abs(y - want).max() < 1e-3


def test_bslab_from_stencil_matches_csr_build():
    csr = generate_stencil(6, 5, 9)  # > 1 tile (270 rows... pad to 1024)
    A_dev, counts = BslabMatrix.from_stencil(6, 5, 9, policy=F32)
    A_host = BslabMatrix.from_csr(csr, F32)
    assert A_dev.nnz == csr.nnz
    np.testing.assert_array_equal(np.asarray(counts), csr.row_lengths)
    x = np.random.default_rng(1).standard_normal(csr.nr).astype(np.float32)
    y_dev = np.asarray(A_dev.spmv(jnp.asarray(x)))
    y_host = np.asarray(A_host.spmv(jnp.asarray(x)))
    want = csr.spmv(x.astype(np.float64))
    scale = np.abs(want).max()
    assert np.abs(y_dev - want).max() / scale < 2e-2
    assert np.abs(y_host - want).max() / scale < 2e-2


def test_bslab_from_stencil_multi_tile_interpret():
    nx, ny, nz = 8, 8, 20  # 1280 rows -> 2 tiles
    csr = generate_stencil(nx, ny, nz)
    A, _ = BslabMatrix.from_stencil(nx, ny, nz, policy=F32, sub=8)
    assert A.n_tiles == 2
    x = np.random.default_rng(3).standard_normal(csr.nr).astype(np.float32)
    y = np.asarray(A.spmv(jnp.asarray(x)))
    want = csr.spmv(x.astype(np.float64))
    assert np.abs(y - want).max() / np.abs(want).max() < 2e-2


def test_bslab_cg_converges():
    csr = generate_stencil(8, 8, 8)
    x0, b, xexact = init_vectors(csr)
    A = from_csr("bslab", csr)
    res = solve_cg(A, b, itermax=200, eps=1e-9, verbose=False)
    assert check_residual(res.x, xexact) < 1e-5


def test_bslab_band_klein(data_dir):
    csr = HostCSR.from_coo(read_mm(str(data_dir / "matrix_band_klein.mtx")))
    A = BslabMatrix.from_csr(csr, F32)
    x = np.ones(csr.nc, np.float32)
    y = np.asarray(A.spmv(jnp.asarray(x)))
    want = csr.spmv(np.ones(csr.nc))
    assert np.abs(y - want).max() < 1e-3


@pytest.mark.parametrize("sub", [4, 12, 0 - 8])
def test_bslab_rejects_bad_sub(sub):
    csr = generate_stencil(3, 3, 3)
    with pytest.raises(ValueError, match="sub must be"):
        BslabMatrix.from_csr(csr, F32, sub=sub)


def test_bslab_empty_matrix():
    from sparsebench.host.coo import COOMatrix

    csr = HostCSR.from_coo(
        COOMatrix(row=np.zeros(0, np.int64), col=np.zeros(0, np.int64),
                  val=np.zeros(0), nr=10, nc=10)
    )
    A = BslabMatrix.from_csr(csr, F32)
    y = np.asarray(A.spmv(jnp.ones(10, jnp.float32)))
    assert np.all(y == 0)


def test_bslab_padding_ratio_reasonable_on_stencil():
    csr = generate_stencil(8, 8, 8)
    A = BslabMatrix.from_csr(csr, F32)
    assert A.padding_ratio < 4.0


def test_bslab_distributed_cg_matches_serial():
    """Sharded bslab: stacked shard pytrees (forced uniform slice counts
    + one chunk plan) reproduce the serial residual history."""
    from sparsebench.host.coo import COOMatrix
    from sparsebench.parallel.dist import build_distributed, dist_solve_cg
    from sparsebench.parallel.partition import slice_coo_rows

    gcsr = generate_stencil(5, 5, 5)
    rows = np.repeat(np.arange(gcsr.nr), gcsr.row_lengths)
    coo = COOMatrix(row=rows, col=gcsr.col, val=gcsr.val, nr=gcsr.nr,
                    nc=gcsr.nc)
    shards = [HostCSR.from_coo(slice_coo_rows(coo, r, 4)) for r in range(4)]
    _, b, xexact = init_vectors(gcsr)
    res_serial = solve_cg(from_csr("crs", gcsr), b, itermax=40, eps=0.0,
                          verbose=False)
    dm = build_distributed(shards, fmt="bslab")
    res = dist_solve_cg(dm, b, itermax=40, eps=0.0, verbose=False)
    n = min(len(res_serial.residual_history), len(res.residual_history))
    np.testing.assert_allclose(
        res.residual_history[:n], res_serial.residual_history[:n],
        rtol=2e-5, atol=1e-7 * res_serial.residual_history[0],
    )
    assert np.abs(res.x - xexact).max() < 1e-4


def test_bslab_unsorted_rows_guard():
    """Columns unsorted within a row must not collapse entries (builder
    sorts defensively)."""
    from sparsebench.host.coo import COOMatrix

    rows = np.array([0, 0, 0, 1, 1])
    cols = np.array([5, 2, 9, 7, 3])
    vals = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    row_ptr = np.array([0, 3, 5])
    csr = HostCSR(row_ptr=row_ptr, col=cols, val=vals, nr=2, nc=12)
    A = BslabMatrix.from_csr(csr, F32)
    x = np.arange(12, dtype=np.float32)
    y = np.asarray(A.spmv(jnp.asarray(x)))
    want = np.array([1 * 5 + 2 * 2 + 3 * 9, 4 * 7 + 5 * 3], np.float64)
    np.testing.assert_allclose(y, want, rtol=1e-2)
