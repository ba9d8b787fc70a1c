"""Head-to-head parity vs the actual C reference binary.

Builds the reference (serial, GCC, .bmx stubbed — no MPI in this image)
from /root/reference into a temp dir and compares its printed residual
history and exact-solution check against our solver on the same problems.
This is the strongest form of the BASELINE.md correctness target
("residual histories match the C reference").

Skipped when /root/reference or a C toolchain is unavailable.
"""

import pathlib
import re
import subprocess

import numpy as np
import pytest

import jax

from sparsebench.formats import from_csr
from sparsebench.host import HostCSR, generate_stencil, read_mm
from sparsebench.solvers.cg import init_vectors, solve_cg

jax.config.update("jax_enable_x64", True)

REFERENCE = pathlib.Path("/root/reference")


@pytest.fixture(scope="session")
def reference_binary(tmp_path_factory):
    """Build logic shared with tools/hpcg_parity.py (tools/refbuild.py):
    GCC, MPI off, serial MPI-IO shim, totalNr/totalNnz bug fix."""
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
    from tools.refbuild import RefBuildError, build_reference

    build = tmp_path_factory.mktemp("refbuild")
    try:
        return build_reference(build)
    except RefBuildError as e:
        pytest.skip(str(e))


def _run_reference(exe, args):
    r = subprocess.run(
        [str(exe), *args], cwd=exe.parent, capture_output=True, text=True,
        timeout=300,
    )
    assert r.returncode == 0, r.stderr
    hist = {}
    initial = None
    diff = None
    for line in r.stdout.splitlines():
        m = re.match(r"Initial Residual = (\S+)", line)
        if m:
            initial = float(m.group(1))
        m = re.match(r"Iteration = (\d+) Residual = (\S+)", line)
        if m:
            hist[int(m.group(1))] = float(m.group(2))
        m = re.match(r"Difference between computed and exact\s+= (\S+)", line)
        if m:
            diff = float(m.group(1))
    return initial, hist, diff


def test_generated_residual_history(reference_binary):
    """itermax=10 -> printFreq=1: every iteration printed and compared."""
    nx = ny = nz = 12
    initial, hist, diff = _run_reference(
        reference_binary, ["-x", str(nx), "-y", str(ny), "-z", str(nz), "-i", "10"]
    )
    csr = generate_stencil(nx, ny, nz)
    _, b, xexact = init_vectors(csr)
    res = solve_cg(from_csr("crs", csr), b, itermax=10, verbose=False)

    assert initial is not None and hist
    # the reference prints %E (6 significant digits) -> parse error ~5e-7
    np.testing.assert_allclose(res.residual_history[0], initial, rtol=1e-6)
    for k, v in hist.items():
        np.testing.assert_allclose(
            res.residual_history[k], v, rtol=5e-6,
            err_msg=f"iteration {k}",
        )
    assert diff is not None
    ours = np.abs(res.x - xexact).max()
    # at least as accurate as the reference (its print has 6 decimals)
    assert ours <= diff + 1e-5


def test_generated_long_run_printed_subset(reference_binary):
    """150-iteration default: compare the printed every-15th residuals."""
    initial, hist, _ = _run_reference(
        reference_binary, ["-x", "8", "-y", "8", "-z", "8", "-i", "60"]
    )
    csr = generate_stencil(8, 8, 8)
    _, b, _ = init_vectors(csr)
    res = solve_cg(from_csr("sell", csr), b, itermax=60, verbose=False)
    np.testing.assert_allclose(res.residual_history[0], initial, rtol=1e-6)
    for k, v in hist.items():
        if k < len(res.residual_history) and v > 1e-14:
            np.testing.assert_allclose(
                res.residual_history[k], v, rtol=1e-4, err_msg=f"iter {k}"
            )


def test_mm_matrix_residual_history(reference_binary, data_dir):
    """Matrix-Market path on the bundled band matrix (b = 1)."""
    initial, hist, _ = _run_reference(
        reference_binary,
        ["-m", "./data/matrix_band_klein.mtx", "-i", "10"],
    )
    csr = HostCSR.from_coo(read_mm(str(data_dir / "matrix_band_klein.mtx")))
    x0, b, _ = init_vectors(csr, generated=False)
    res = solve_cg(from_csr("crs", csr), b, itermax=10, verbose=False)
    np.testing.assert_allclose(res.residual_history[0], initial, rtol=1e-6)
    for k, v in hist.items():
        if k < len(res.residual_history):
            np.testing.assert_allclose(
                res.residual_history[k], v, rtol=1e-6, atol=1e-12,
                err_msg=f"iter {k}",
            )


def test_bmx_write_byte_parity(reference_binary, data_dir, tmp_path):
    """The reference's matrixBinWrite (real code via the serial MPI shim,
    src/matrixBinfile.c:37-105) and our write_bmx must produce IDENTICAL
    bytes for the same matrix."""
    from sparsebench.host.binfile import write_bmx

    # reference: -c converts data/matrix_band_klein.mtx -> .bmx in its tree
    ref_bmx = reference_binary.parent / "data" / "matrix_band_klein.bmx"
    if ref_bmx.exists():
        ref_bmx.unlink()
    subprocess.run(
        [str(reference_binary), "-c", "./data/matrix_band_klein.mtx"],
        cwd=reference_binary.parent, capture_output=True, text=True,
        timeout=120,
    )  # exits via commAbort after writing — rc is nonzero by design
    assert ref_bmx.exists(), "reference did not write the .bmx file"

    csr = HostCSR.from_coo(read_mm(str(data_dir / "matrix_band_klein.mtx")))
    ours = tmp_path / "ours.bmx"
    write_bmx(csr, str(ours))

    assert ours.read_bytes() == ref_bmx.read_bytes()


def test_bmx_reference_reads_ours(reference_binary, data_dir, tmp_path):
    """The reference's matrixBinRead (src/matrixBinfile.c:107-236) must
    accept a file written by our write_bmx and solve to the same residual
    history as our CG on the same matrix."""
    from sparsebench.host.binfile import read_bmx, write_bmx

    csr = HostCSR.from_coo(read_mm(str(data_dir / "matrix_band_klein.mtx")))
    bmx = reference_binary.parent / "ours_klein.bmx"
    write_bmx(csr, str(bmx))

    # note: .par `filename` lines hit a reference tokenizer quirk (strtok
    # on " " keeps the trailing newline, parameter.c:40-41) — use -m,
    # which takes the name from optarg
    initial, hist, _ = _run_reference(
        reference_binary, ["-m", f"./{bmx.name}", "-i", "10", "-e", "0.0"]
    )

    # our solve on the round-tripped matrix
    rt = read_bmx(str(bmx))
    np.testing.assert_array_equal(rt.row_ptr, csr.row_ptr)
    np.testing.assert_array_equal(rt.col, csr.col)
    np.testing.assert_allclose(rt.val, csr.val)  # klein values are f32-exact
    x0, b, _ = init_vectors(rt, generated=False)
    res = solve_cg(from_csr("crs", rt), b, itermax=10, verbose=False)
    assert initial is not None
    np.testing.assert_allclose(res.residual_history[0], initial, rtol=1e-6)
    for k, v in hist.items():
        if k < len(res.residual_history):
            np.testing.assert_allclose(
                res.residual_history[k], v, rtol=1e-6, atol=1e-12,
                err_msg=f"iter {k}",
            )
