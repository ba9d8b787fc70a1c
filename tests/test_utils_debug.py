"""Utils + debug-dump module tests (reference timing/affinity/util/VERBOSE
dump analogs, SURVEY §2 rows 14-18 and §5 observability)."""

import io
import os

import numpy as np
import pytest

from sparsebench import debug, utils
from sparsebench.host import generate_stencil
from sparsebench.parallel.partition import partition


def test_timestamp_and_resolution():
    t0 = utils.get_timestamp()
    t1 = utils.get_timestamp()
    assert t1 >= t0
    assert utils.get_timer_resolution() > 0


def test_change_file_ending():
    # reference changeFileEnding (util.c:11-31)
    assert utils.change_file_ending("m.mtx", ".bmx") == "m.bmx"
    assert utils.change_file_ending("a/b/c.mtx", "bmx") == "a/b/c.bmx"


def test_device_banner_mentions_devices():
    s = utils.device_banner()
    assert "device 0:" in s


def test_dump_csr_and_vector():
    csr = generate_stencil(2, 2, 2)
    f = io.StringIO()
    debug.dump_csr(csr, f, label="G")
    out = f.getvalue()
    assert "G: nr=8" in out and "rowPtr:" in out and "row 0:" in out
    f = io.StringIO()
    debug.dump_vector(np.asarray([1.0, 2.5]), f, label="v")
    assert "v[2]: 1.000000, 2.500000" in f.getvalue()


def test_dump_device_matrix():
    from sparsebench.formats import from_csr

    csr = generate_stencil(2, 2, 2)
    A = from_csr("crs", csr)
    f = io.StringIO()
    debug.dump_device_matrix(A, f)
    assert "CRSMatrix" in f.getvalue()


def test_partition_dump_files(tmp_path, monkeypatch):
    monkeypatch.setenv("SB_VERBOSE", "1")
    shards = [generate_stencil(2, 2, 2, rank=r, size=2) for r in range(2)]
    part = partition(shards)
    debug.maybe_dump_partition(part, directory=str(tmp_path))
    for s in range(2):
        p = tmp_path / f"out-{s}.txt"
        assert p.exists()
        assert "halo:" in p.read_text()


def test_dump_disabled_without_env(tmp_path, monkeypatch):
    monkeypatch.delenv("SB_VERBOSE", raising=False)
    shards = [generate_stencil(2, 2, 2, rank=r, size=2) for r in range(2)]
    debug.maybe_dump_partition(partition(shards), directory=str(tmp_path))
    assert not list(tmp_path.glob("out-*.txt"))


@pytest.mark.parametrize("platform,requested,ok", [
    ("gpu", None, True),
    ("gpu", "cuda", True),
    ("cpu", "cpu", True),
    ("cpu", "cuda,cpu", True),
    ("cpu", None, False),     # JAX fell back to the CPU: not a card run
    ("cpu", "", False),
    ("rocm", None, False),    # unknown platforms are errors
    ("METAL", None, False),
])
def test_check_platform(platform, requested, ok):
    if ok:
        assert utils.check_platform(platform, requested) == platform
    else:
        with pytest.raises(RuntimeError):
            utils.check_platform(platform, requested)


def test_device_platform_under_tests_is_cpu():
    # the test setup asks for the CPU explicitly (conftest.py)
    assert utils.device_platform() == "cpu"


def test_compile_cache_dir_env_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert utils.compile_cache_dir() == str(tmp_path)


def test_compile_cache_off_for_cpu_runs(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    import jax

    before = jax.config.jax_compilation_cache_dir
    assert utils.compile_cache_dir() is None
    assert utils.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_checkout_path_on_gpu(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(utils, "device_platform", lambda: "gpu")
    path = utils.compile_cache_dir()
    assert path == os.path.join(utils.CHECKOUT, ".jax_cache")
    assert os.path.isfile(os.path.join(utils.CHECKOUT, "chip_smoke.py"))


def test_compile_cache_entries_land_in_env_dir(tmp_path):
    """A process with JAX_COMPILATION_CACHE_DIR set writes its entries
    there, and nothing into the checkout's own cache directory."""
    import subprocess
    import sys

    code = (
        "import jax, jax.numpy as jnp\n"
        "from sparsebench.utils import enable_compile_cache\n"
        "print(enable_compile_cache())\n"
        "jax.jit(lambda x: jnp.sin(x) * 2)(jnp.ones(8)).block_until_ready()\n"
    )
    own = os.path.join(utils.CHECKOUT, ".jax_cache")
    before = set(os.listdir(own)) if os.path.isdir(own) else set()
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "JAX_COMPILATION_CACHE_DIR": str(tmp_path),
           "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0",
           "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES": "-1"}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       cwd=utils.CHECKOUT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == str(tmp_path)
    assert list(tmp_path.iterdir()), "no cache entry written"
    after = set(os.listdir(own)) if os.path.isdir(own) else set()
    assert after == before


def test_package_public_api_lazy():
    """Package-level re-exports resolve lazily (PEP 562): the host-only
    names must not pull jax in (the CLI's -c conversion path depends on
    import sparsebench staying backend-free)."""
    import importlib
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import sparsebench as sb\n"
        "sb.Parameter(); sb.generate_stencil(3, 3, 3)\n"
        "assert 'jax' not in sys.modules, 'jax leaked into host-only API'\n"
        "assert callable(sb.solve_cg)\n"
    )
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_package_import_applies_malloc_tuning():
    """Importing the package must run _malloc_tuning.apply() (the
    reference `allocate` analog for the lazy-memory dev VM). A package
    __init__ rewrite once dropped the call silently — pin it."""
    import importlib
    import sys

    sys.modules.pop("sparsebench", None)
    mt = importlib.import_module("sparsebench._malloc_tuning")
    importlib.import_module("sparsebench")
    # inspect the latch BEFORE touching apply() ourselves: on this glibc
    # image mallopt succeeds, so __init__'s call must have set it
    assert mt._applied, "__init__ did not run _malloc_tuning.apply()"
