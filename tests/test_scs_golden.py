"""SELL-C-sigma conversion golden tests.

Validates the exact flat layout against the reference's golden files
(tests/data/expected/test{0,8}_C_{1,2,4}_sigma_1.in), which are the
authoritative behavioral spec for the format (SURVEY.md §4) — chunk
lengths, padding, column-major-in-chunk order, permutation vectors.
"""

import numpy as np
import pytest

from sparsebench.formats.scs_host import (
    dump_reference_format,
    sell_convert,
    sell_spmv_host,
)
from sparsebench.host import HostCSR, read_mm


@pytest.mark.parametrize("name", ["test0", "test8"])
@pytest.mark.parametrize("C", [1, 2, 4])
def test_golden_layout(test_matrices_dir, expected_dir, name, C):
    csr = HostCSR.from_coo(read_mm(str(test_matrices_dir / f"{name}.mtx")))
    m = sell_convert(csr, C=C, sigma=1)
    got = dump_reference_format(m)
    expected = (expected_dir / f"{name}_C_{C}_sigma_1.in").read_text()
    assert got.splitlines() == expected.splitlines()


@pytest.mark.parametrize("name", ["test0", "test8"])
@pytest.mark.parametrize("C,sigma", [(1, 1), (2, 2), (4, 8), (8, 8), (3, 5)])
def test_spmv_matches_csr_oracle(test_matrices_dir, name, C, sigma):
    """Beyond the goldens: any (C, sigma) must produce the same SpMV as CSR
    once the row permutation is inverted (the reference's own CG forgets
    this; see SURVEY.md §7 'reference bugs')."""
    csr = HostCSR.from_coo(read_mm(str(test_matrices_dir / f"{name}.mtx")))
    m = sell_convert(csr, C=C, sigma=sigma)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(csr.nc)
    y_perm = sell_spmv_host(m, x)
    y = y_perm[m.old_to_new]  # un-permute: y[old] = y_perm[new]
    assert np.allclose(y, csr.spmv(x))


def test_spmv_x1_golden(test_matrices_dir, expected_dir):
    """SpMV with x == 1 against the golden vector (tests/solver/spmvSCS.c)."""
    csr = HostCSR.from_coo(read_mm(str(test_matrices_dir / "test0.mtx")))
    expected_line = (expected_dir / "test0_spmv_x_1.in").read_text().strip()
    want = [float(t) for t in expected_line.split("=")[1].replace(",", " ").split()]
    for C, sigma in [(1, 1), (2, 1), (4, 1)]:
        m = sell_convert(csr, C=C, sigma=sigma)
        y = sell_spmv_host(m, np.ones(csr.nc))[m.old_to_new]
        assert np.allclose(y, want)
    assert np.allclose(csr.spmv(np.ones(csr.nc)), want)


def test_sigma_sorting_reduces_padding():
    """sigma sorting exists to cut padding (arXiv:1307.6209): with a full
    sort the padded element count must not exceed the unsorted one."""
    rng = np.random.default_rng(1)
    nr = 64
    lens = rng.integers(1, 20, nr)
    row_ptr = np.zeros(nr + 1, dtype=np.int64)
    np.cumsum(lens, out=row_ptr[1:])
    nnz = int(row_ptr[-1])
    col = rng.integers(0, nr, nnz).astype(np.int64)
    # make columns unique per row to be well-formed (not required, but tidy)
    val = rng.standard_normal(nnz)
    csr = HostCSR(row_ptr=row_ptr, col=col, val=val, nr=nr, nc=nr)
    unsorted = sell_convert(csr, C=8, sigma=1)
    fully = sell_convert(csr, C=8, sigma=nr)
    assert fully.n_elems <= unsorted.n_elems
    x = rng.standard_normal(nr)
    for m in (unsorted, fully):
        assert np.allclose(sell_spmv_host(m, x)[m.old_to_new], csr.spmv(x))
