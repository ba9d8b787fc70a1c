"""Device-format SpMV correctness vs the host CSR oracle.

Every registered format must reproduce ``HostCSR.spmv`` exactly (f64 on the
CPU test backend) on the Matrix-Market fixtures and generated stencils —
the device analog of the reference's golden SpMV tests
(tests/solver/solverTests.c, SURVEY.md §4).
"""

import jax
import numpy as np
import pytest

from sparsebench.config import DTypePolicy
from sparsebench.formats import FORMATS, from_csr
from sparsebench.formats.dia import DiaMatrix, DiaUnsuitableError
from sparsebench.host import HostCSR, generate_stencil, read_mm

jax.config.update("jax_enable_x64", True)

POLICY = DTypePolicy.from_names("f64", "i32")
GENERAL_FORMATS = ["crs", "ccrs", "sell", "ell", "bslab"]


def _fixtures(test_matrices_dir):
    for p in sorted(test_matrices_dir.glob("*.mtx")):
        yield p.name, HostCSR.from_coo(read_mm(str(p)))


@pytest.mark.parametrize("fmt", GENERAL_FORMATS)
def test_spmv_fixtures(test_matrices_dir, fmt):
    rng = np.random.default_rng(0)
    for name, csr in _fixtures(test_matrices_dir):
        dm = from_csr(fmt, csr, POLICY)
        x = rng.standard_normal(csr.nc)
        y = np.asarray(jax.jit(dm.spmv)(x))
        np.testing.assert_allclose(y, csr.spmv(x), rtol=1e-12, err_msg=f"{fmt}:{name}")


@pytest.mark.parametrize("fmt", GENERAL_FORMATS + ["dia"])
def test_spmv_stencil(fmt):
    csr = generate_stencil(5, 4, 3)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(csr.nc)
    dm = from_csr(fmt, csr, POLICY)
    y = np.asarray(jax.jit(dm.spmv)(x))
    np.testing.assert_allclose(y, csr.spmv(x), rtol=1e-12)


@pytest.mark.parametrize("C,sigma", [(1, 1), (8, 1), (32, 0), (4, 16)])
def test_sell_params(test_matrices_dir, C, sigma):
    csr = HostCSR.from_coo(read_mm(str(test_matrices_dir / "test8.mtx")))
    dm = from_csr("sell", csr, POLICY, C=C, sigma=sigma)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(csr.nc)
    np.testing.assert_allclose(np.asarray(dm.spmv(x)), csr.spmv(x), rtol=1e-12)


def test_sell_permutation_roundtrip():
    csr = generate_stencil(3, 3, 3)
    dm = from_csr("sell", csr, POLICY, C=4, sigma=0)
    v = np.arange(csr.nr, dtype=np.float64)
    vp = dm.permute_vector(v)
    np.testing.assert_array_equal(np.asarray(dm.unpermute_vector(vp)), v)
    # permuted-space spmv consistency
    x = np.linspace(0, 1, csr.nc)
    y1 = np.asarray(dm.spmv(x))
    y2 = np.asarray(dm.unpermute_vector(dm.spmv_permuted(dm.permute_vector(x))))
    np.testing.assert_allclose(y1, y2, rtol=1e-14)


def test_dia_band_klein(data_dir):
    csr = HostCSR.from_coo(read_mm(str(data_dir / "matrix_band_klein.mtx")))
    dm = DiaMatrix.from_csr(csr, POLICY)
    x = np.linspace(-1, 1, csr.nc)
    np.testing.assert_allclose(np.asarray(dm.spmv(x)), csr.spmv(x), rtol=1e-12)


def test_dia_rejects_wide_matrices(test_matrices_dir):
    csr = HostCSR.from_coo(read_mm(str(test_matrices_dir / "test0.mtx")))
    with pytest.raises(DiaUnsuitableError):
        DiaMatrix.from_csr(csr, POLICY, max_diags=2)


def test_registry_contents():
    for name in ("crs", "ccrs", "sell", "ell", "dia", "bslab", "stencil"):
        assert name in FORMATS
    assert "bsell" not in FORMATS


def test_dia_from_stencil_matches_from_csr():
    """The analytic stencil->DIA builder must reproduce the CSR-built DIA
    exactly (offsets, data, nnz, row counts) including the 7-pt variant,
    boundary ranks of a stacked multi-rank grid, and the degenerate-grid
    CSR fallback."""
    import numpy as np

    from sparsebench.config import DTypePolicy
    from sparsebench.formats.dia import DiaMatrix
    from sparsebench.host import generate_stencil

    policy = DTypePolicy.from_names("f32", "i32")
    cases = [
        dict(dims=(5, 6, 7), use_7pt=False, rank=0, size=1),
        dict(dims=(5, 6, 7), use_7pt=True, rank=0, size=1),
        dict(dims=(1, 2, 3), use_7pt=False, rank=0, size=1),  # CSR fallback
        dict(dims=(4, 5, 3), use_7pt=False, rank=0, size=3),
        dict(dims=(4, 5, 3), use_7pt=False, rank=2, size=3),
    ]
    for case in cases:
        dims = case.pop("dims")
        csr = generate_stencil(*dims, dtype=np.float64, **case)
        B, counts = DiaMatrix.from_stencil(
            *dims, policy=policy, **case
        )
        assert np.array_equal(counts, csr.row_lengths)
        assert B.nnz == csr.nnz
        A = DiaMatrix.from_csr(csr, policy)
        x = np.random.default_rng(7).standard_normal(A.nc).astype(np.float32)
        ya, yb = np.asarray(A.spmv(x)), np.asarray(B.spmv(x))
        np.testing.assert_allclose(ya, yb, rtol=1e-6, atol=1e-6)
        if case.get("size", 1) == 1:
            assert A.offsets == B.offsets
            assert np.array_equal(
                np.asarray(A.data, np.float32), np.asarray(B.data, np.float32)
            )


def test_init_vectors_from_row_counts():
    import numpy as np

    from sparsebench.host import generate_stencil
    from sparsebench.solvers.cg import init_vectors

    csr = generate_stencil(4, 4, 4, dtype=np.float64)
    x1, b1, e1 = init_vectors(csr, dtype=np.float64)
    x2, b2, e2 = init_vectors(
        None, dtype=np.float64, row_lengths=csr.row_lengths
    )
    assert np.array_equal(b1, b2) and np.array_equal(e1, e2)


def test_sell_bridge_cg_solve():
    """A CG solve on SELL runs in the format's permuted row order and
    returns x in the original order."""
    from sparsebench.formats.sell import SellMatrix
    from sparsebench.solvers.cg import init_vectors, solve_cg

    policy = DTypePolicy.from_names("f32", "i32")
    csr = generate_stencil(6, 6, 6, dtype=np.float32)
    A = SellMatrix.from_csr(csr, policy)
    assert A.permuted_output
    _, b, xexact = init_vectors(csr, dtype=np.float32)
    res = solve_cg(A, b, itermax=60, eps=0.0, verbose=False)
    assert np.abs(res.x - xexact).max() < 1e-4


def _shifted(csr: HostCSR, s: int) -> HostCSR:
    """The same entries moved s diagonals to the right (dropping those
    that leave the square): the offset pattern of a rank's block whose
    columns are shifted by its start row."""
    from sparsebench.host.coo import COOMatrix

    rows = np.repeat(np.arange(csr.nr), csr.row_lengths)
    col = csr.col + s
    keep = (col >= 0) & (col < csr.nc)
    return HostCSR.from_coo(COOMatrix(row=rows[keep], col=col[keep],
                                      val=csr.val[keep], nr=csr.nr,
                                      nc=csr.nc))


def _diag_pattern(n: int, offsets, value: float) -> HostCSR:
    from sparsebench.host.coo import COOMatrix

    r, c = [], []
    for off in offsets:
        i = np.arange(max(0, -off), min(n, n - off))
        r.append(i)
        c.append(i + off)
    r, c = np.concatenate(r), np.concatenate(c)
    return HostCSR.from_coo(COOMatrix(row=r, col=c,
                                      val=np.full(r.size, value), nr=n,
                                      nc=n))


DIA_CASES = {
    "stencil27": lambda: generate_stencil(5, 6, 7),
    "stencil7": lambda: generate_stencil(6, 5, 4, use_7pt=True),
    "thin": lambda: generate_stencil(1, 5, 6),
    "planes": lambda: generate_stencil(16, 16, 4),
    "band_klein": lambda: HostCSR.from_coo(read_mm(
        str(__import__("pathlib").Path(__file__).parent / "data"
            / "matrix_band_klein.mtx"))),
    "shift+1": lambda: _diag_pattern(300, [1], 2.0),
    "shift-3": lambda: _diag_pattern(300, [-3], -1.0),
    "identity": lambda: _diag_pattern(300, [0], 27.0),
}
# storage -> (policy, compress, rtol of max|y| against the f64 oracle)
DIA_STORAGE = {
    "f32-bf16": ("f32", True, 1e-5),
    "f32": ("f32", False, 1e-5),
    "f64": ("f64", False, 1e-12),
}


@pytest.mark.parametrize("shift", [0, 5])
@pytest.mark.parametrize("storage", sorted(DIA_STORAGE))
@pytest.mark.parametrize("case", sorted(DIA_CASES))
def test_dia_matches_csr_oracle(case, storage, shift):
    """DIA's gather-free shifted-slice SpMV against the CSR oracle, for
    stencils, the band matrix and pure-shift patterns, in each storage
    (bf16 diagonals are used only where lossless), serial and with every
    offset shifted as in a rank's block."""
    csr = DIA_CASES[case]()
    if shift:
        csr = _shifted(csr, shift)
    value, compress, rtol = DIA_STORAGE[storage]
    policy = DTypePolicy.from_names(value, "i32")
    A = DiaMatrix.from_csr(csr, policy, compress=compress)
    stored = np.dtype(A.data.dtype).name
    if storage == "f32-bf16" and case != "band_klein":
        assert stored == "bfloat16"  # exact 27 / -1 / 2 values
    elif storage != "f32-bf16":
        assert stored == ("float64" if value == "f64" else "float32")
    x = np.random.default_rng(5).standard_normal(csr.nc)
    x = x.astype(np.float64 if value == "f64" else np.float32)
    y = np.asarray(jax.jit(A.spmv)(x))
    want = csr.spmv(x.astype(np.float64))
    assert y.shape == want.shape
    assert np.abs(y - want).max() <= rtol * max(np.abs(want).max(), 1.0)
