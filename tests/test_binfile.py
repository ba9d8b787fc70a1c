"""Binary .bmx file round-trip and sharded-read tests
(reference src/matrixBinfile.{c,h})."""

import numpy as np

from sparsebench.host import HostCSR, generate_stencil, read_mm
from sparsebench.host.binfile import (
    HEADER,
    HEADER_SIZE,
    rank_row_range,
    read_bmx,
    read_bmx_header,
    size_of_rank,
    write_bmx,
)


def test_roundtrip(tmp_path, data_dir):
    csr = HostCSR.from_coo(read_mm(str(data_dir / "matrix_band_klein.mtx")))
    path = str(tmp_path / "klein.bmx")
    write_bmx(csr, path)
    back = read_bmx(path)
    assert back.nr == csr.nr and back.nnz == csr.nnz
    np.testing.assert_array_equal(back.row_ptr, csr.row_ptr)
    np.testing.assert_array_equal(back.col, csr.col)
    # values go through f32 (reference narrows on write, matrixBinfile.c:92-95)
    np.testing.assert_allclose(back.val, csr.val, rtol=1e-6)


def test_header_layout(tmp_path):
    csr = generate_stencil(3, 3, 3)
    path = str(tmp_path / "g.bmx")
    write_bmx(csr, path)
    raw = open(path, "rb").read()
    assert raw.startswith(HEADER)
    nr, nnz = np.frombuffer(raw[HEADER_SIZE : HEADER_SIZE + 8], dtype="<u4")
    assert nr == csr.nr and nnz == csr.nnz
    assert read_bmx_header(path) == (csr.nr, csr.nnz)
    expected_size = HEADER_SIZE + 8 + 4 * (csr.nr + 1) + 8 * csr.nnz
    assert len(raw) == expected_size


def test_sharded_read_covers_everything(tmp_path):
    csr = generate_stencil(4, 4, 5)
    path = str(tmp_path / "g.bmx")
    write_bmx(csr, path)
    size = 3
    parts = [
        read_bmx(path, row_range=rank_row_range(r, size, csr.nr)) for r in range(size)
    ]
    assert sum(p.nr for p in parts) == csr.nr
    cols = np.concatenate([p.col for p in parts])
    np.testing.assert_array_equal(cols, csr.col)
    for r, p in enumerate(parts):
        start, stop = rank_row_range(r, size, csr.nr)
        assert p.start_row == start and p.stop_row == stop - 1
        # localized rowPtr starts at 0
        assert p.row_ptr[0] == 0


def test_size_of_rank_matches_reference_split():
    # N=10 over 3 ranks -> 4,3,3 (reference sizeOfRank, comm.c:35-38)
    assert [size_of_rank(r, 3, 10) for r in range(3)] == [4, 3, 3]
    assert sum(size_of_rank(r, 7, 100) for r in range(7)) == 100
