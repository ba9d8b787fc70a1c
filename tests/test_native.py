"""Native C++ host library parity tests (native/ingest.cc vs the numpy
behavioral spec in sparsebench/host)."""

import os

import numpy as np
import pytest

from sparsebench.host import generate_stencil, read_mm
from sparsebench.host.native import available

pytestmark = pytest.mark.skipif(
    not available(), reason="native library unavailable (no toolchain?)"
)


@pytest.mark.parametrize("dims,use_7pt", [((5, 4, 3), False), ((4, 4, 4), True)])
def test_generator_parity(dims, use_7pt):
    nat = generate_stencil(*dims, use_7pt=use_7pt)
    ref = generate_stencil(*dims, use_7pt=use_7pt, use_native=False)
    np.testing.assert_array_equal(nat.row_ptr, ref.row_ptr)
    np.testing.assert_array_equal(nat.col, ref.col)
    np.testing.assert_array_equal(nat.val, ref.val)


def test_generator_parity_ranked():
    nat = generate_stencil(3, 3, 2, rank=1, size=3)
    ref = generate_stencil(3, 3, 2, rank=1, size=3, use_native=False)
    np.testing.assert_array_equal(nat.col, ref.col)
    assert nat.start_row == ref.start_row


def test_mm_parity(test_matrices_dir, data_dir):
    paths = sorted(test_matrices_dir.glob("*.mtx")) + [
        data_dir / "matrix_band_klein.mtx"
    ]
    for p in paths:
        nat = read_mm(str(p))
        os.environ["SB_NO_NATIVE"] = "1"
        try:
            ref = read_mm(str(p))
        finally:
            del os.environ["SB_NO_NATIVE"]
        np.testing.assert_array_equal(nat.row, ref.row, err_msg=p.name)
        np.testing.assert_array_equal(nat.col, ref.col, err_msg=p.name)
        np.testing.assert_array_equal(nat.val, ref.val, err_msg=p.name)
        assert (nat.nr, nat.nc) == (ref.nr, ref.nc)


def test_pool_allocator_clean_exit(tmp_path):
    """Regression (r4): pool_shutdown runs from .fini_array AFTER the
    __cxa_atexit static destructors, so iterating an ordinarily-declared
    g_blocks map walked a destroyed rb-tree — every process that pooled
    more than one file segment spun forever at interpreter exit (observed
    at 100% CPU in _Rb_tree_increment). The allocator state is now leaked
    on purpose; a pooled-allocation process must exit promptly."""
    import subprocess
    import sys

    so = os.path.join(
        os.path.dirname(__file__), "..", "sparsebench", "native",
        "sb_npalloc.so",
    )
    if not os.path.exists(so):
        pytest.skip("native allocator not built")
    script = (
        "import sys; sys.path.insert(0, %r)\n"
        "from sparsebench import _malloc_tuning\n"
        "assert _malloc_tuning.install_pool_allocator()\n"
        "import numpy as np\n"
        # several distinct >=1MB size classes -> multiple pool segments
        "bufs = [np.zeros((i + 1) * 300_000) for i in range(6)]\n"
        "print('allocated', sum(b.nbytes for b in bufs))\n"
    ) % os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["SB_POOL_FILE"] = str(tmp_path / "pool")
    out = subprocess.run(
        [sys.executable, "-c", script], env=env, capture_output=True,
        text=True, timeout=60,
    )
    assert out.returncode == 0, out.stderr
    assert "allocated" in out.stdout
