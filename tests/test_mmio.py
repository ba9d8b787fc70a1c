"""Matrix Market ingest tests (reference behavior: src/matrix.c:123-269)."""

import numpy as np
import pytest

from sparsebench.host import HostCSR, read_mm
from sparsebench.host.mmio import MMFormatError, read_mm_string


def test_read_test0(test_matrices_dir):
    m = read_mm(str(test_matrices_dir / "test0.mtx"))
    assert m.nr == 10 and m.nc == 10 and m.nnz == 18
    csr = HostCSR.from_coo(m)
    d = csr.to_dense()
    assert d[0, 0] == 11 and d[0, 3] == 14 and d[0, 4] == 15
    assert d[5, 9] == 610 and d[9, 9] == 1010
    # row-major sorted with column tie-break
    assert np.all(np.diff(m.row) >= 0)


def test_all_fixtures_parse(test_matrices_dir):
    for p in sorted(test_matrices_dir.glob("*.mtx")):
        m = read_mm(str(p))
        assert m.nnz > 0
        assert m.row.min() >= 0 and m.row.max() < m.nr
        assert m.col.min() >= 0 and m.col.max() < m.nc
        order = np.lexsort((m.col, m.row))
        assert np.array_equal(order, np.arange(m.nnz))


def test_symmetric_expansion():
    txt = """%%MatrixMarket matrix coordinate real symmetric
3 3 4
1 1 2.0
2 1 -1.0
3 2 -1.0
3 3 2.0
"""
    m = read_mm_string(txt)
    # 2 off-diagonal entries mirrored (src/matrix.c:204-208)
    assert m.nnz == 6
    d = HostCSR.from_coo(m).to_dense()
    assert d[0, 1] == -1.0 and d[1, 0] == -1.0
    assert d[1, 2] == -1.0 and d[2, 1] == -1.0
    assert np.allclose(d, d.T)


def test_pattern_values_are_one():
    txt = """%%MatrixMarket matrix coordinate pattern general
2 2 3
1 1
1 2
2 2
"""
    m = read_mm_string(txt)
    assert np.all(m.val == 1.0)


def test_rejects_complex_and_dense():
    with pytest.raises(MMFormatError):
        read_mm_string("%%MatrixMarket matrix coordinate complex general\n1 1 1\n1 1 1 1\n")
    with pytest.raises(MMFormatError):
        read_mm_string("%%MatrixMarket matrix array real general\n1 1\n1.0\n")


def test_band_klein(data_dir):
    m = read_mm(str(data_dir / "matrix_band_klein.mtx"))
    assert m.nr == 100 and m.nnz == 298
