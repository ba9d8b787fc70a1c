"""CLI driver tests (reference src/main.c flag surface) — run in-process."""

import numpy as np
import pytest

from sparsebench.cli import apply_args, build_argparser, main
from sparsebench.config import Parameter


def run_cli(argv):
    return main(argv)


def test_help_flags():
    ap = build_argparser()
    with pytest.raises(SystemExit):
        ap.parse_args(["--bogus"])


def test_par_file_then_cli_override(tmp_path):
    par = tmp_path / "t.par"
    par.write_text("filename generate # comment\nnx 8\nny 9\nnz 10\nitermax 22\neps 0.5\n")
    args = build_argparser().parse_args(["-f", str(par), "-x", "5", "-i", "7"])
    p = apply_args(Parameter(), args)
    assert (p.nx, p.ny, p.nz) == (5, 9, 10)  # -x overrides the .par value
    assert p.itermax == 7 and p.eps == 0.5


def test_cg_run(capsys):
    rc = run_cli(["-t", "cg", "-x", "6", "-y", "6", "-z", "6", "-i", "15"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Initial Residual" in out
    assert "Difference between computed and exact" in out


def test_spmv_run(capsys):
    rc = run_cli(["-t", "spmv", "-x", "5", "-y", "5", "-z", "5", "-i", "5",
                  "--fmt", "crs"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Rate(MB/s)" in out and "spMVM" in out


def test_convert_and_load_bmx(tmp_path, data_dir, capsys):
    src = tmp_path / "m.mtx"
    src.write_text((data_dir / "matrix_band_klein.mtx").read_text())
    rc = run_cli(["-c", str(src)])
    assert rc == 0
    bmx = tmp_path / "m.bmx"
    assert bmx.exists()
    rc = run_cli(["-t", "cg", "-m", str(bmx), "-i", "10", "--fmt", "dia"])
    assert rc == 0


def test_sharded_cli_run(capsys):
    rc = run_cli(["-t", "cg", "-x", "4", "-y", "4", "-z", "2", "-i", "10",
                  "--shards", "4", "--fmt", "sell"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Partition: 4 shards" in out
    assert "Total data volume" in out


@pytest.mark.parametrize("bench", ["gmres", "cheb"])
def test_sharded_cli_other_solvers(capsys, bench):
    rc = run_cli(["-t", bench, "-x", "4", "-y", "4", "-z", "2", "-i", "40",
                  "-e", "1e-8", "--shards", "4", "--fmt", "crs"])
    out = capsys.readouterr().out
    assert rc == 0
    assert ("GMRES" if bench == "gmres" else "CHEBFD") in out


def test_cg_variant_cs_cli(capsys):
    rc = run_cli(["-t", "cg", "-x", "6", "-y", "6", "-z", "6", "-i", "15",
                  "--cg-variant", "cs"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Solve aggregate (fused)" in out
    assert "Difference between computed and exact  = 0.000" in out


def test_cg_variant_cs_sharded_cli(capsys):
    rc = run_cli(["-t", "cg", "-x", "4", "-y", "4", "-z", "2", "-i", "10",
                  "--shards", "4", "--fmt", "sell", "--cg-variant", "cs"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Solve aggregate (fused)" in out


def test_cg_variant_sstep_cli(capsys):
    rc = run_cli(["-t", "cg", "-x", "6", "-y", "6", "-z", "6", "-i", "30",
                  "-e", "1e-8", "--cg-variant", "sstep", "--sstep", "4"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Difference between computed and exact  = 0.000" in out


def test_cg_variant_sstep_sharded_cli(capsys):
    rc = run_cli(["-t", "cg", "-x", "4", "-y", "4", "-z", "2", "-i", "13",
                  "--shards", "4", "--fmt", "crs", "--cg-variant", "sstep",
                  "--sstep", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Solve aggregate (fused)" in out


@pytest.mark.parametrize("bench", ["gmres", "cheb"])
def test_precond_jacobi_other_solvers_cli(capsys, bench):
    """--precond jacobi must reach GMRES and Chebyshev, not be silently
    dropped (the reference has no such flag asymmetry)."""
    rc = run_cli(["-t", bench, "-x", "5", "-y", "5", "-z", "4", "-i", "40",
                  "-e", "1e-8", "--precond", "jacobi"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Preconditioner: Jacobi" in out


def test_gmres_restart_cli(capsys):
    rc = run_cli(["-t", "gmres", "-x", "5", "-y", "5", "-z", "4", "-i", "40",
                  "-e", "1e-8", "--restart", "10"])
    out = capsys.readouterr().out
    assert rc == 0
    # with m=10 a 40-iteration budget takes > 1 restart cycle
    assert "GMRES cycle 2" in out


def test_gmres_restart_rejects_bad():
    with pytest.raises(SystemExit, match="restart"):
        run_cli(["-t", "gmres", "-x", "4", "-y", "4", "-z", "2", "-i", "5",
                 "--restart", "0"])


def test_flag_validation_reaches_sharded_runs():
    """--restart/--sstep value checks must fire BEFORE the --shards
    dispatch (they previously sat after it and sharded runs surfaced raw
    tracebacks instead of the SystemExit)."""
    with pytest.raises(SystemExit, match="restart"):
        run_cli(["-t", "gmres", "-x", "4", "-y", "4", "-z", "2", "-i", "5",
                 "--shards", "4", "--restart", "0"])
    with pytest.raises(SystemExit, match="sstep"):
        run_cli(["-t", "cg", "-x", "4", "-y", "4", "-z", "2", "-i", "5",
                 "--shards", "4", "--cg-variant", "sstep", "--sstep", "0"])


def test_irrelevant_flag_warnings(capsys):
    """Solver-specific flags that cannot reach the chosen bench type
    warn on stderr instead of being silently ignored."""
    rc = run_cli(["-t", "cg", "-x", "4", "-y", "4", "-z", "4", "-i", "5",
                  "--orth", "cgs2", "--restart", "10"])
    err = capsys.readouterr().err
    assert rc == 0
    assert "--orth has no effect" in err
    assert "--restart has no effect" in err
    rc = run_cli(["-t", "gmres", "-x", "4", "-y", "4", "-z", "4", "-i", "5",
                  "--cg-variant", "cs", "--sstep", "2"])
    err = capsys.readouterr().err
    assert rc == 0
    assert "--cg-variant has no effect" in err
    assert "--sstep has no effect" in err


def test_precond_refused_for_device_built_rgl():
    """--precond jacobi with serial generateRGL has no host diagonal; it
    must refuse loudly, never precondition with a wrong constant."""
    with pytest.raises(SystemExit, match="diagonal"):
        run_cli(["-t", "cg", "-m", "generateRGL", "-x", "4096", "-y", "1",
                 "-z", "1", "-i", "5", "--band", "64", "--deg", "4",
                 "--precond", "jacobi"])


@pytest.mark.parametrize("bench", ["gmres", "cheb"])
def test_precond_jacobi_other_solvers_sharded_cli(capsys, bench):
    rc = run_cli(["-t", bench, "-x", "4", "-y", "4", "-z", "2", "-i", "30",
                  "-e", "1e-8", "--shards", "4", "--fmt", "crs",
                  "--precond", "jacobi"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Preconditioner: Jacobi" in out


def test_cg_variant_rejects_profile():
    with pytest.raises(SystemExit, match="plain CG path"):
        run_cli(["-t", "cg", "-x", "4", "-y", "4", "-z", "4", "-i", "5",
                 "--cg-variant", "cs", "--profile"])


def test_sharded_checkpoint_resume(tmp_path, capsys):
    """--checkpoint under --shards: whole-mesh snapshots; an interrupted
    run resumes and reproduces the uninterrupted history."""
    ck = tmp_path / "dist.ck.npz"
    args = ["-t", "cg", "-x", "4", "-y", "4", "-z", "2", "-i", "12",
            "--shards", "4", "--fmt", "sell",
            "--checkpoint", str(ck), "--checkpoint-every", "5"]
    rc = run_cli(args)
    out_full = capsys.readouterr().out
    assert rc == 0
    assert "checkpoint @ iteration" in out_full
    assert ck.exists()
    # resume: the completed checkpoint restarts at its recorded iteration
    rc = run_cli(args)
    out_resumed = capsys.readouterr().out
    assert rc == 0
    assert "Resuming from" in out_resumed


def test_sharded_checkpoint_wrong_mesh_rejected(tmp_path, capsys):
    ck = tmp_path / "dist.ck.npz"
    rc = run_cli(["-t", "cg", "-x", "4", "-y", "4", "-z", "2", "-i", "10",
                  "--shards", "4", "--fmt", "sell",
                  "--checkpoint", str(ck), "--checkpoint-every", "4"])
    assert rc == 0
    capsys.readouterr()
    with pytest.raises(SystemExit, match="same mesh size"):
        run_cli(["-t", "cg", "-x", "4", "-y", "4", "-z", "2", "-i", "10",
                 "--shards", "2", "--fmt", "sell", "--checkpoint", str(ck)])


def test_sharded_trace_flag(tmp_path, capsys):
    """--trace under --shards captures an XLA profiler trace."""
    tdir = tmp_path / "trace"
    rc = run_cli(["-t", "cg", "-x", "4", "-y", "4", "-z", "2", "-i", "5",
                  "--shards", "2", "--fmt", "crs", "--trace", str(tdir)])
    assert rc == 0
    assert any(tdir.rglob("*"))  # trace files were written


@pytest.mark.parametrize("flag", [["--impl", "pallas"],
                                  ["--cg-variant", "fused"],
                                  ["--cg-variant", "vmem"],
                                  ["--fmt", "bsell"]])
def test_removed_kernel_options_rejected(flag):
    """The options that chose a kernel are gone: argparse refuses them
    (exit code 2) instead of silently running another path."""
    with pytest.raises(SystemExit) as e:
        run_cli(["-t", "cg", "-x", "4", "-y", "4", "-z", "2", "-i", "4",
                 *flag])
    assert e.value.code == 2


def test_sharded_rcm_flag(tmp_path, data_dir, capsys, monkeypatch):
    """--rcm under --shards applies a GLOBAL reordering before slicing,
    and the .mtx is parsed exactly once for all shards."""
    import sparsebench.host as host_pkg
    import sparsebench.parallel.driver as drv

    calls = {"n": 0}
    real_read = host_pkg.read_mm

    def counting_read(fn):
        calls["n"] += 1
        return real_read(fn)

    monkeypatch.setattr(host_pkg, "read_mm", counting_read)
    rc = run_cli(["-t", "cg", "-m", str(data_dir / "matrix_band_klein.mtx"),
                  "-i", "10", "--shards", "4", "--fmt", "crs", "--rcm"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "RCM reordering applied" in out
    assert calls["n"] == 1, "the .mtx must be parsed once for all shards"
    # rcm on generated matrices is rejected loudly
    with pytest.raises(SystemExit, match="rcm"):
        drv.init_shards(Parameter(), 2, rcm=True)


def test_rgl_cli_cg(capsys):
    """generateRGL: on-device irregular random-graph Laplacian, solved
    through the standard CG path with the x == 1 exact-solution oracle."""
    rc = run_cli(["-t", "cg", "-m", "generateRGL", "-x", "3000", "-y", "1",
                  "-z", "1", "--band", "96", "--deg", "8.0", "-i", "120",
                  "-e", "1e-7"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "RGL: n=3000" in out
    assert "Difference between computed and exact  = 0.000" in out


def test_rgl_cli_sharded(capsys):
    """generateRGL under --shards: host-spec shards through the standard
    partition/exchange pipeline, exact-solution check."""
    rc = run_cli(["-t", "cg", "-m", "generateRGL", "-x", "2000", "-y", "1",
                  "-z", "1", "--band", "64", "--deg", "6.0", "-i", "80",
                  "-e", "1e-8", "--shards", "4", "--fmt", "bslab"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Difference between computed and exact  = 0.000" in out


def test_rgl_cli_rejects_host_formats():
    with pytest.raises(SystemExit, match="bslab"):
        run_cli(["-t", "cg", "-m", "generateRGL", "-x", "1000", "-y", "1",
                 "-z", "1", "--fmt", "crs", "-i", "5"])


def test_generated_auto_picks_by_size_and_bslab_path_works(capsys):
    """--fmt auto on generated problems picks dia at every size (the
    generated matrix is banded); --fmt bslab forces the analytic bslab
    device build."""
    rc = run_cli(["-t", "cg", "-x", "6", "-y", "6", "-z", "6", "-i", "15"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "format dia" in out
    assert "Difference between computed and exact  = 0.000" in out
    rc = run_cli(["-t", "cg", "-x", "6", "-y", "6", "-z", "6", "-i", "15",
                  "--fmt", "bslab"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "format bslab" in out
    assert "Difference between computed and exact  = 0.000" in out


def test_bslab_cli_sharded(capsys):
    rc = run_cli(["-t", "cg", "-x", "4", "-y", "4", "-z", "2", "-i", "10",
                  "--shards", "4", "--fmt", "bslab"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Difference between computed and exact  = 0.000" in out


def test_cg_profile_cli(capsys):
    """--profile runs the separately-jitted region kernels
    (solvers/profiled.py) and prints the reference per-region table."""
    rc = run_cli(["-t", "cg", "-x", "6", "-y", "6", "-z", "6", "-i", "15",
                  "--profile", "--fmt", "crs"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Rate(MB/s)" in out and "waxpby:" in out and "ddot:" in out
    assert "Difference between computed and exact  = 0.000" in out


def test_gmres_orth_cli(capsys, data_dir):
    rc = run_cli(["-t", "gmres", "-m",
                  str(data_dir / "testMatrices" / "test0.mtx"),
                  "-i", "40", "-e", "1e-10", "--fmt", "crs",
                  "--orth", "cgs2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "GMRES cycle" in out


def test_graft_entry_single_and_multi():
    import jax

    import __graft_entry__ as ge

    fn, args = ge.entry()
    x, hist = jax.jit(fn)(*args)
    assert np.isfinite(np.asarray(hist)[0])
    ge.dryrun_multichip(8)


def test_sharded_rgl_cli(capsys):
    """--shards x generateRGL: the irregular matrix
    through the any-matrix partition path — non-ring offsets, uneven
    halos — with the allgather exchange backend, solved to the exact
    x == 1 solution."""
    rc = run_cli(["-t", "cg", "-m", "generateRGL", "-x", "12", "-y", "10",
                  "-z", "10", "--band", "96", "--deg", "8", "-i", "60",
                  "-e", "1e-9", "--shards", "4", "--fmt", "bslab",
                  "--exchange", "allgather"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Partition: 4 shards" in out
    assert "Difference between computed and exact  = 0.000" in out


def test_sharded_rgl_matches_serial(capsys):
    """Sharded RGL CG must reproduce the serial device-built RGL solve
    (same spec, same iterates up to reduction order)."""
    import jax.numpy as jnp

    from sparsebench.formats.rgl_build import rgl_bslab
    from sparsebench.config import DTypePolicy
    from sparsebench.host.rgl import rgl_csr
    from sparsebench.parallel.dist import build_distributed, dist_solve_cg
    from sparsebench.parallel.partition import slice_coo_rows
    from sparsebench.host import HostCSR
    from sparsebench.host.coo import COOMatrix
    from sparsebench.solvers.cg import solve_cg

    n, band, deg, seed = 1100, 96, 8.0, 11
    policy = DTypePolicy.from_names("f64", "i32")
    csr = rgl_csr(n, band=band, deg=deg, seed=seed)
    rows = np.repeat(np.arange(csr.nr, dtype=np.int64), csr.row_lengths)
    coo = COOMatrix(row=rows, col=csr.col, val=csr.val, nr=n, nc=n)
    shards = [HostCSR.from_coo(slice_coo_rows(coo, r, 4)) for r in range(4)]
    dm = build_distributed(shards, fmt="bslab", policy=policy,
                           exchange_backend="allgather")
    b = np.ones(n)
    res_d = dist_solve_cg(dm, b, itermax=50, eps=0.0, verbose=False)
    # serial oracle: the on-device builder of the same spec
    A, _ = rgl_bslab(n, band=band, deg=deg, seed=seed, policy=policy,
                     sub=8)
    res_s = solve_cg(A, b, itermax=50, eps=0.0, verbose=False)
    np.testing.assert_allclose(res_d.x, res_s.x, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(
        res_d.residual_history, res_s.residual_history, rtol=1e-8
    )
