"""chip_smoke.py on the CPU: its phase functions at tiny sizes (the card
runs them at full size), and its refusal of anything but a GPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_four_refuses_cpu(capsys):
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.main(["--four"])
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("platforms", ["cpu", None])
def test_script_exits_nonzero_without_a_gpu(platforms):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    if platforms:
        env["JAX_PLATFORMS"] = platforms
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_lone_copy_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ""}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_phase_device_cpu_when_not_required():
    info = chip_smoke.phase_device(require_gpu=False)
    assert info["platform"] == "cpu" and info["count"] >= 1


@pytest.mark.parametrize("argv,bound", [
    (["-x", "8", "-y", "8", "-z", "8", "-t", "cg"], 1e-4),
    (["-x", "8", "-y", "8", "-z", "8", "-t", "cg", "--dtype", "f64"], 1e-8),
    (["-x", "8", "-y", "8", "-z", "8", "-t", "cg", "--fmt", "dia",
      "-i", "50"], 1e-2),
])
def test_phase_main_path_tiny(argv, bound):
    diffs = chip_smoke.run_cli(argv, bound)
    assert len(diffs) == 1 and diffs[0] <= bound


def test_run_cli_enforces_bound():
    with pytest.raises(AssertionError, match="max"):
        chip_smoke.run_cli(["-x", "8", "-y", "8", "-z", "8", "-t", "cg",
                            "-i", "3"], 1e-12)


def test_phase_replacements_tiny():
    recs = chip_smoke.phase_replacements(n=8, rgl_n=3000, rgl_rows=3,
                                         timed=True)
    paths = [r["path"] for r in recs]
    assert paths == ["dia f32", "dia f64", "bslab f32", "sell f32",
                     "crs f32", "stencil f32", "stencil f64",
                     "bslab rgl f32"]
    for r in recs:
        tol = chip_smoke.SPMV_TOL["f64" if "f64" in r["path"] else "f32"]
        assert r["err"] <= tol
        assert r["spmv_GBps"] > 0 and r["copy_GBps"] > 0


def test_check_close_rejects():
    want = np.ones(4)
    with pytest.raises(AssertionError, match="max"):
        chip_smoke.check_close("x", want * (1 + 1e-3), want, 1e-5)
    with pytest.raises(AssertionError, match="non-finite"):
        chip_smoke.check_close("x", np.full(4, np.nan), want, 1e-5)


def test_rgl_reference_rows_match_spec_csr():
    from sparsebench.host.rgl import rgl_csr

    n, band, deg, seed = 900, 64, 8.0, 3
    x = np.random.default_rng(0).standard_normal(n)
    rows = np.arange(100, 700, 7)
    want = rgl_csr(n, band=band, deg=deg, seed=seed).spmv(x)[rows]
    got = chip_smoke.rgl_reference_rows(x, rows, n, band, deg, seed)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-12)


def test_phase_family_tiny():
    """Same code on both sides of the comparison: this process (here the
    CPU) and the child, which must agree to the stated bound."""
    worst = chip_smoke.phase_family(6, 30, cli_n=8)
    assert set(worst) == {"cg", "cg-cs", "cg-sstep", "cg-pipe", "cg-jacobi",
                          "cg-cheb", "gmres-cgs", "gmres-cgs2", "bicgstab",
                          "minres", "cheb"}
    assert max(worst.values()) <= chip_smoke.HISTORY_RTOL


def test_compare_histories_flags_deviation():
    h = [1.0, 0.5, 0.25]
    cpu = {"cg": {"history": h, "r0": 1.0, "seconds": 0.0,
                  "iterations": 3}}
    gpu = {"cg": {"history": [1.0, 0.5, 0.26], "r0": 1.0, "seconds": 0.0,
                  "iterations": 3}}
    with pytest.raises(AssertionError, match="deviation"):
        chip_smoke.compare_histories(gpu, cpu)
    assert chip_smoke.compare_histories(cpu, cpu) == {"cg": 0.0}


@pytest.mark.parametrize("name,flagged", [("cg", True), ("bicgstab", False)])
def test_compare_histories_floor_per_solver(name, flagged):
    """A deviation at 1e-5 ||r0|| is compared for CG (floor 1e-8) and not
    for BiCGStab, whose history is compared above 1e-4 ||r0|| only."""
    def run(h):
        return {name: {"history": h, "r0": 1.0, "seconds": 0.0,
                       "iterations": 3}}

    cpu, gpu = run([1.0, 1e-3, 1e-5]), run([1.0, 1e-3, 3e-5])
    if flagged:
        with pytest.raises(AssertionError, match="deviation"):
            chip_smoke.compare_histories(gpu, cpu)
    else:
        assert chip_smoke.compare_histories(gpu, cpu) == {name: 0.0}


def test_cpu_child_prints_histories():
    import tempfile

    with tempfile.TemporaryFile() as out, tempfile.TemporaryFile() as err:
        proc = chip_smoke.start_cpu_child(4, 8, out, err)
        got = chip_smoke.finish_cpu_child(proc, out, err, timeout=600)
    assert len(got["cg"]["history"]) == 8
    json.dumps(got)


def test_memory_report_tiny():
    chip_smoke.memory_report(8, 5)


def test_phase_four_on_virtual_devices():
    """The --four legs on 4 of the test setup's virtual CPU devices."""
    legs = chip_smoke.phase_four(stencil_n=4, stored_n=4, itermax=20)
    assert set(legs) == {"stencil/blocking", "stencil/overlap",
                         "stencil/cs", "stencil/pipe", "stencil/sstep",
                         "dia/allgather", "gmres/dia", "sell/ppermute",
                         "bslab/ppermute", "crs/auto"}
    assert max(legs.values()) <= chip_smoke.PARITY_BAR


@pytest.fixture
def gpu():
    """Skip unless this process computes on a GPU (decided at run time,
    never at import, so every xdist worker collects the same tests)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs this on the card")


@pytest.mark.gpu
def test_phases_on_the_card(gpu):
    info = chip_smoke.phase_device()
    assert info["platform"] == "gpu"
    chip_smoke.phase_replacements(n=32, rgl_n=20000, rgl_rows=2)
