"""Stencil generator tests against an independent scalar oracle
(reference behavior: src/matrix.c:30-121)."""

import numpy as np
import pytest

from sparsebench.host import generate_stencil


def _oracle(nx, ny, nz, rank, size, use_7pt):
    """Scalar triple-loop oracle, written independently from the module."""
    local = nx * ny * nz
    total = local * size
    start = local * rank
    rows, cols, vals = [], [], []
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                r = start + iz * nx * ny + iy * nx + ix
                for sz in (-1, 0, 1):
                    for sy in (-1, 0, 1):
                        for sx in (-1, 0, 1):
                            c = r + sz * nx * ny + sy * nx + sx
                            if not (0 <= ix + sx < nx and 0 <= iy + sy < ny):
                                continue
                            if not (0 <= c < total):
                                continue
                            if use_7pt and sz * sz + sy * sy + sx * sx > 1:
                                continue
                            rows.append(r)
                            cols.append(c)
                            vals.append(27.0 if c == r else -1.0)
    return np.array(rows), np.array(cols), np.array(vals)


@pytest.mark.parametrize("dims", [(3, 3, 3), (4, 3, 2), (1, 5, 2), (5, 1, 1)])
@pytest.mark.parametrize("use_7pt", [False, True])
def test_matches_oracle_serial(dims, use_7pt):
    nx, ny, nz = dims
    csr = generate_stencil(nx, ny, nz, use_7pt=use_7pt)
    r, c, v = _oracle(nx, ny, nz, 0, 1, use_7pt)
    flat_rows = np.repeat(np.arange(csr.nr), csr.row_lengths)
    assert np.array_equal(flat_rows, r)
    assert np.array_equal(csr.col, c)
    assert np.array_equal(csr.val, v)
    assert csr.model_total_nnz == 27 * csr.total_nr


@pytest.mark.parametrize("rank,size", [(0, 3), (1, 3), (2, 3)])
def test_matches_oracle_ranked(rank, size):
    nx, ny, nz = 3, 4, 2
    csr = generate_stencil(nx, ny, nz, rank=rank, size=size)
    r, c, v = _oracle(nx, ny, nz, rank, size, False)
    flat_rows = csr.start_row + np.repeat(
        np.arange(csr.nr, dtype=np.int64), csr.row_lengths
    )
    assert csr.start_row == nx * ny * nz * rank
    assert np.array_equal(flat_rows, r)
    assert np.array_equal(csr.col, c)
    assert np.array_equal(csr.val, v)


def test_ranked_blocks_tile_the_global_matrix():
    """Stacked per-rank blocks == the single global generation."""
    nx, ny, nz, size = 3, 3, 2, 4
    parts = [generate_stencil(nx, ny, nz, rank=k, size=size) for k in range(size)]
    glob = generate_stencil(nx, ny, nz * size)
    cols = np.concatenate([p.col for p in parts])
    vals = np.concatenate([p.val for p in parts])
    assert np.array_equal(cols, glob.col)
    assert np.array_equal(vals, glob.val)


def test_row_sums_give_exact_rhs():
    """b = A @ 1 must equal 27 - (nnzrow - 1) (reference initVectors,
    src/CGSolver.c:25-36: exact solution x == 1)."""
    csr = generate_stencil(4, 4, 4)
    b = csr.spmv(np.ones(csr.nr))
    expect = 27.0 - (csr.row_lengths - 1)
    assert np.allclose(b, expect)
