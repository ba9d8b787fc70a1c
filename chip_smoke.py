#!/usr/bin/env python3
"""Smoke test of the solver path on NVIDIA GPUs: the quickest proof that
the system still starts on the card and computes the right answers.

    python3 chip_smoke.py          # one card: phases 1-4
    python3 chip_smoke.py --four   # four cards: the sharded legs only

Phases (each prints its own lines; the first failure raises and the script
exits non-zero):

  1. device        refuses anything but a GPU; prints the card, its power
                   limit and the compile-cache directory in use.
  2. main path     the CLI's own main() on the reference workloads, each
                   held to the exact solution x == 1 with a bound per dtype.
  3. replacements  every SpMV path at 200^3 (and bslab on the RGL matrix)
                   against a plain numpy f64 reference, timed beside a
                   device copy of the same byte count.
  4. solver family every solver, CG variant and preconditioner at 100^3 in
                   f64, each residual history checked against the same
                   solver run on the host CPU by one child process that
                   never opens the card; plus the CLI's remaining modes.
  --four           the sharded legs on four cards against the single-card
                   solve of the stacked problem (residual parity <= 1e-9).

The last line of stdout is one JSON object: {"ok": true, "device": ...}.
The phase functions take their sizes, so tests run them on the CPU at tiny
sizes; main() itself refuses the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

import sparsebench  # noqa: F401 — a lone copy of this script must fail here

# ---------------------------------------------------------------- tolerances
# Phase 2: max|x - 1| after the CLI's solve. f32: 150 CG iterations reach
# the f32 rounding floor of x ~ 1 (a few 1e-6); f64 reaches ~1e-12 on the
# same iterations; the 50-iteration run is bounded by convergence, not
# rounding (the error contracts by ~0.75 per iteration on this operator).
EXACT_BOUND = {"f32": 1e-4, "f64": 1e-8, "f32_50it": 1e-2}
# Phase 3: max|y - y_ref| <= tol * max|y_ref|. f32 storage is exact for the
# stencil and RGL values (bf16 diagonals hold 27/-1 and integers <= 255
# exactly), so the error is f32 accumulation of <= 27 products: ~27 ulp of
# the largest term, below 1e-5 of max|y|. f64: the same count of f64 ulps.
# CRS sums with atomics on the GPU, so its order changes from run to run;
# the bound covers any order.
SPMV_TOL = {"f32": 1e-5, "f64": 1e-12}
# Phase 4: GPU vs host CPU f64 residual histories, max|h - h_cpu| / ||r0||
# over the iterations whose residual is above 1e-8 ||r0|| (r0 = b, x0 = 0).
# The two machines reduce in different orders, and the recurrences amplify
# those last-bit differences; measured on an H100 at 100^3 they stay below
# 2e-13 ||r0|| for every solver (1.5e-13 for s-step CG, the largest), so
# 1e-10 flags any real divergence and no rounding noise.
HISTORY_RTOL = 1e-10
HISTORY_FLOOR = 1e-8
# BiCGStab at 100^3 is chaotic past ~1e-4 ||r0||: on the CPU alone, a
# one-ulp change of b moves its history by 3e-7 ||r0|| by iteration 40,
# while the entries above 1e-4 ||r0|| (about 22 iterations) move by under
# 1e-12 ||r0||. It is compared over those entries only.
HISTORY_FLOOR_OF = {"bicgstab": 1e-4}
# --four: the distributed residual history against the single-card one,
# max|h - h_ref| / h_ref[0] (the bar of __graft_entry__.dryrun_multichip).
PARITY_BAR = 1e-9


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------- references
def stencil_reference(x: np.ndarray, nx: int, ny: int, nz: int,
                      use_7pt: bool = False) -> np.ndarray:
    """y = A x for the generated 27/7-point matrix (reference
    src/matrix.c:30-121: 27 on the diagonal, -1 for every in-domain
    neighbour), as an explicit neighbour sum in numpy f64 — independent
    of the factorized form the matrix-free operator uses."""
    v = np.asarray(x, np.float64).reshape(nz, ny, nx)
    p = np.pad(v, 1)
    y = 27.0 * v
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if (dz, dy, dx) == (0, 0, 0):
                    continue
                if use_7pt and abs(dz) + abs(dy) + abs(dx) != 1:
                    continue
                y -= p[1 + dz:1 + dz + nz, 1 + dy:1 + dy + ny,
                       1 + dx:1 + dx + nx]
    return y.reshape(-1)


def rgl_reference_rows(x: np.ndarray, rows: np.ndarray, n: int, band: int,
                       deg: float, seed: int) -> np.ndarray:
    """(A x)[rows] for the RGL matrix straight from its spec
    (host/rgl.py): -1 on each edge, degree + 1 on the diagonal."""
    from sparsebench.host.rgl import rgl_edges_for_rows

    mask, j, edge = rgl_edges_for_rows(rows, n, band, deg, seed)
    degree = edge.sum(axis=1)
    xj = np.asarray(x, np.float64)[np.clip(j, 0, n - 1)]
    return (degree + 1.0) * np.asarray(x, np.float64)[rows] - np.where(
        edge, xj, 0.0).sum(axis=1)


def check_close(name: str, y, want, tol: float) -> float:
    y = np.asarray(y, np.float64)
    if y.shape != want.shape or not np.isfinite(y).all():
        raise AssertionError(f"{name}: shape {y.shape} (want {want.shape}) "
                             f"or non-finite values")
    err = float(np.abs(y - want).max() / max(np.abs(want).max(), 1e-300))
    if err > tol:
        raise AssertionError(f"{name}: max|y - y_ref| / max|y_ref| = "
                             f"{err:.3e} > {tol:g}")
    return err


# ---------------------------------------------------------------- timing
def device_seconds(fn, *args, reps: int = 20) -> float:
    """Mean seconds per call of a jitted ``fn``: one warm-up, then ``reps``
    calls queued back to back and one wait for the last."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def copy_rate(nbytes: int) -> float:
    """GB/s of a device copy of ``nbytes`` (read + write counted), the
    yardstick each SpMV path is measured beside."""
    import jax
    import jax.numpy as jnp

    a = jnp.ones(max(nbytes // 4, 1), jnp.float32)
    f = jax.jit(lambda v: v * jnp.float32(1.0001))
    dt = device_seconds(f, a)
    del a
    return 2.0 * nbytes / dt / 1e9


# ---------------------------------------------------------------- phases
def phase_device(require_gpu: bool = True, count: int = 1) -> dict:
    """Phase 1: the card. Refuses any platform but the GPU (no fallback to
    the CPU) and fewer than ``count`` devices."""
    import jax

    from sparsebench.utils import device_platform, enable_compile_cache

    platform = device_platform()
    devs = jax.devices()
    if require_gpu and platform != "gpu":
        raise SystemExit("chip_smoke: JAX found no GPU (platform "
                         f"{platform!r}); this script runs on the card only")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: need {count} devices, JAX found "
                         f"{len(devs)}")
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    log(f"[device] {len(devs)} x {info['kind']} (platform {info['platform']})")
    if platform == "gpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        for line in smi.stdout.strip().splitlines():
            log(f"[device] nvidia-smi: {line.strip()}")
    log(f"[device] compile cache: {enable_compile_cache()}")
    return info


@contextlib.contextmanager
def _recorded_residuals():
    """Record every check_residual value the CLI computes (its printed
    'Difference' line keeps only six decimals)."""
    import sparsebench.solvers.cg as cg

    seen = []
    orig = cg.check_residual

    def record(*a, **k):
        v = orig(*a, **k)
        seen.append(v)
        return v

    cg.check_residual = record
    try:
        yield seen
    finally:
        cg.check_residual = orig


_KEEP = re.compile(r"Setup took|SpMV streams|Solution performed|Difference|"
                   r"Test type|GMRES cycle|Chebyshev performed|Blocked CG|"
                   r"Refinement|Preconditioner|Partition:|Solve aggregate|"
                   r"sweeps /")


def run_cli(argv, bound=None) -> list:
    """The CLI's main() on ``argv``; prints its key lines, returns the
    max|x - xexact| values it computed, each checked against ``bound``."""
    from sparsebench.cli import main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with _recorded_residuals() as diffs, contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    wall = time.perf_counter() - t0
    log(f"[cli] {' '.join(argv)}  (rc {rc}, {wall:.1f} s wall)")
    for line in buf.getvalue().splitlines():
        if _KEEP.search(line):
            log(f"      {line.strip()}")
    if rc != 0:
        raise AssertionError(f"cli {argv}: exit code {rc}")
    for d in diffs:
        log(f"      max|x - 1| = {d:.3e}"
            + (f" (bound {bound:g})" if bound is not None else ""))
        if bound is not None and not d <= bound:
            raise AssertionError(f"cli {argv}: max|x - 1| = {d:.3e} > "
                                 f"{bound:g}")
    return diffs


def phase_main_path(runs) -> None:
    """Phase 2: ``runs`` is a list of (argv, bound) for the CLI."""
    for argv, bound in runs:
        run_cli(argv, bound)


def memory_report(n: int, itermax: int) -> None:
    """Peak device memory of the process so far, and the compiled CG
    step's own memory analysis for the analytic n^3 DIA problem."""
    import jax
    import jax.numpy as jnp

    from sparsebench.config import DTypePolicy
    from sparsebench.formats.dia import DiaMatrix
    from sparsebench.solvers.cg import cg_loop

    stats = jax.devices()[0].memory_stats() or {}
    log(f"[memory] peak_bytes_in_use after the {n}^3 run: "
        f"{stats.get('peak_bytes_in_use', 'n/a')}")
    policy = DTypePolicy.from_names("f32", "i32")
    A, counts = DiaMatrix.from_stencil(n, n, n, policy=policy)
    b = jnp.asarray(27.0 - (counts - 1), jnp.float32)
    loop = jax.jit(functools.partial(cg_loop, itermax=itermax))
    ma = loop.lower(A, b, jnp.zeros_like(b),
                    eps=jnp.float32(0.0)).compile().memory_analysis()
    log(f"[memory] {n}^3 CG step memory_analysis: {ma}")


def _spmv_record(rec: dict, spmv, A, x, timed: bool) -> dict:
    """Add to ``rec`` the SpMV's time and physical rate beside a device
    copy of the same bytes (when ``timed``), and print it."""
    from sparsebench.formats.base import physical_spmv_bytes

    if timed:
        nbytes = physical_spmv_bytes(A, x.dtype.itemsize)
        rec["spmv_ms"] = device_seconds(spmv, A, x) * 1e3
        rec["spmv_GBps"] = nbytes / rec["spmv_ms"] / 1e6
        rec["copy_GBps"] = copy_rate(nbytes)
        rec["share_of_copy"] = rec["spmv_GBps"] / rec["copy_GBps"]
    log("[replace] " + ", ".join(
        f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
        for k, v in rec.items()))
    return rec


def phase_replacements(n: int = 200, rgl_n: int = 2_000_000,
                       rgl_rows: int = 64, timed: bool = True) -> list:
    """Phase 3: every SpMV path at n^3 (f32, plus f64 for DIA and the
    stencil) against numpy f64, and bslab on the RGL matrix against its
    spec on ``rgl_rows`` chunks of 4096 rows spread over all rows. With
    ``timed`` each path is timed beside a device copy of its bytes.
    Returns one record per path."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    from sparsebench.config import DTypePolicy
    from sparsebench.formats import from_csr
    from sparsebench.formats.bslab import BslabMatrix
    from sparsebench.formats.dia import DiaMatrix
    from sparsebench.formats.rgl_build import rgl_bslab
    from sparsebench.formats.stencil import StencilOperator
    from sparsebench.host import generate_stencil

    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    csr = generate_stencil(n, n, n, dtype=np.float64)
    x64 = rng.standard_normal(csr.nc)
    x32 = x64.astype(np.float32)
    want32 = csr.spmv(x32.astype(np.float64))
    want64 = csr.spmv(x64)
    np.testing.assert_allclose(stencil_reference(x64, n, n, n), want64,
                               rtol=1e-12, atol=1e-9)
    log(f"[replace] host {n}^3 CSR + numpy f64 references: "
        f"{time.perf_counter() - t0:.1f} s ({csr.nnz} nnz)")

    f32 = DTypePolicy.from_names("f32", "i32")
    f64 = DTypePolicy.from_names("f64", "i32")
    builds = [
        ("dia", "f32", lambda: DiaMatrix.from_stencil(n, n, n, policy=f32)[0]),
        ("dia", "f64", lambda: DiaMatrix.from_stencil(n, n, n, policy=f64)[0]),
        ("bslab", "f32",
         lambda: BslabMatrix.from_stencil(n, n, n, policy=f32)[0]),
        ("sell", "f32", lambda: from_csr("sell", csr, f32)),
        ("crs", "f32", lambda: from_csr("crs", csr, f32)),
        ("stencil", "f32",
         lambda: StencilOperator.from_stencil(n, n, n, policy=f32)[0]),
        ("stencil", "f64",
         lambda: StencilOperator.from_stencil(n, n, n, policy=f64)[0]),
    ]
    spmv = jax.jit(lambda A, x: A.spmv(x))
    records = []
    for fmt, dt, build in builds:
        t0 = time.perf_counter()
        A = build()
        jax.block_until_ready(jax.tree_util.tree_leaves(A))
        setup = time.perf_counter() - t0
        x = jnp.asarray(x32 if dt == "f32" else x64)
        err = check_close(f"{fmt} {dt} {n}^3", spmv(A, x),
                          want32 if dt == "f32" else want64, SPMV_TOL[dt])
        records.append(_spmv_record(
            {"path": f"{fmt} {dt}", "n": n, "err": err, "setup_s": setup},
            spmv, A, x, timed))
        del A
    del csr

    # bslab on the irregular RGL matrix (-m generateRGL -x rgl_n --band
    # 512 --deg 16 --seed 1), built on the device
    band, deg, seed = 512, 16.0, 1
    t0 = time.perf_counter()
    A, nnz = rgl_bslab(rgl_n, band=band, deg=deg, seed=seed, policy=f32)
    jax.block_until_ready(jax.tree_util.tree_leaves(A))
    setup = time.perf_counter() - t0
    xr = rng.standard_normal(rgl_n).astype(np.float32)
    y = np.asarray(spmv(A, jnp.asarray(xr)))
    chunk = min(4096, rgl_n)
    starts = np.unique(np.linspace(0, rgl_n - chunk, max(rgl_rows, 1))
                       .astype(np.int64))
    rows = np.concatenate([np.arange(s, s + chunk) for s in starts])
    rows = np.unique(rows)
    want = rgl_reference_rows(xr.astype(np.float64), rows, rgl_n, band, deg,
                              seed)
    err = check_close(f"bslab rgl n={rgl_n}", y[rows], want, SPMV_TOL["f32"])
    records.append(_spmv_record(
        {"path": "bslab rgl f32", "n": rgl_n, "nnz": nnz, "err": err,
         "rows_checked": int(rows.size), "setup_s": setup},
        spmv, A, jnp.asarray(xr), timed))
    return records


def family_histories(n: int, itermax: int) -> dict:
    """Residual histories of every solver, CG variant and preconditioner
    on the analytic n^3 DIA problem in f64, on whatever platform this
    process computes on. The same code runs on the card and, for the
    comparison, on the host CPU."""
    import jax

    jax.config.update("jax_enable_x64", True)
    from sparsebench.config import DTypePolicy
    from sparsebench.formats.dia import DiaMatrix
    from sparsebench.solvers.bicgstab import solve_bicgstab
    from sparsebench.solvers.cg import init_vectors, solve_cg
    from sparsebench.solvers.chebyshev import solve_chebyshev
    from sparsebench.solvers.gmres import solve_gmres
    from sparsebench.solvers.minres import solve_minres
    from sparsebench.solvers.precond import cheb_precond_for

    policy = DTypePolicy.from_names("f64", "i32")
    A, counts = DiaMatrix.from_stencil(n, n, n, policy=policy)
    _, b, _ = init_vectors(row_lengths=np.asarray(counts), dtype=np.float64)
    inv_d = np.full(A.nr, 1.0 / 27.0)
    pc = cheb_precond_for(A, A.nr, np.float64, degree=3)
    kw = {"itermax": itermax, "eps": 0.0, "verbose": False}
    runs = {
        "cg": lambda: solve_cg(A, b, **kw),
        "cg-cs": lambda: solve_cg(A, b, variant="cs", **kw),
        "cg-sstep": lambda: solve_cg(A, b, variant="sstep", sstep=4, **kw),
        "cg-pipe": lambda: solve_cg(A, b, variant="pipe", **kw),
        "cg-jacobi": lambda: solve_cg(A, b, inv_diag=inv_d, **kw),
        "cg-cheb": lambda: solve_cg(A, b, precond=pc, **kw),
        "gmres-cgs": lambda: solve_gmres(A, b, orth="cgs", **kw),
        "gmres-cgs2": lambda: solve_gmres(A, b, orth="cgs2", **kw),
        "bicgstab": lambda: solve_bicgstab(A, b, **kw),
        "minres": lambda: solve_minres(A, b, **kw),
        "cheb": lambda: solve_chebyshev(A, b, **kw),
    }
    r0 = float(np.linalg.norm(b))
    out = {}
    for name, run in runs.items():
        res = run()
        out[name] = {"history": [float(h) for h in res.residual_history],
                     "r0": r0, "seconds": float(res.solve_seconds),
                     "iterations": int(res.iterations)}
    return out


def compare_histories(gpu: dict, cpu: dict,
                      rtol: float = HISTORY_RTOL) -> dict:
    """Per solver: max|h_gpu - h_cpu| / ||r0|| over the entries whose CPU
    residual is above the solver's floor times ||r0|| (GMRES records one
    entry per restart cycle; NaN slots, the s-step variant's between-block
    entries, are skipped on both sides)."""
    worst = {}
    for name, ref in cpu.items():
        h_ref = np.asarray(ref["history"])
        h = np.asarray(gpu[name]["history"])
        r0 = ref["r0"]
        n = min(h.size, h_ref.size)
        h, h_ref = h[:n], h_ref[:n]
        if not np.array_equal(np.isnan(h), np.isnan(h_ref)):
            raise AssertionError(f"{name}: history NaN slots differ")
        floor = HISTORY_FLOOR_OF.get(name, HISTORY_FLOOR)
        keep = ~np.isnan(h_ref) & (h_ref > floor * r0)
        dev = float(np.abs(h[keep] - h_ref[keep]).max() / r0) \
            if keep.any() else 0.0
        worst[name] = dev
        log(f"[family] {name}: {int(keep.sum())} of {n} entries above "
            f"{floor:g} ||r0|| compared, "
            f"max|h_gpu - h_cpu| / ||r0|| = {dev:.2e} (bound {rtol:g}); "
            f"{gpu[name]['seconds']:.4f} s on the card for "
            f"{gpu[name]['iterations']} iterations")
        if not dev <= rtol:
            raise AssertionError(f"{name}: GPU vs CPU history deviation "
                                 f"{dev:.2e} > {rtol:g}")
    return worst


def start_cpu_child(n: int, itermax: int, out_file, err_file):
    """The one child process: family_histories on the host CPU. It is told
    to see no GPU at all, so it never opens the card."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-histories",
         str(n), str(itermax)],
        env=env, stdout=out_file, stderr=err_file,
        cwd=os.path.dirname(os.path.abspath(__file__)))


def finish_cpu_child(proc, out_file, err_file, timeout: float) -> dict:
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out_file.seek(0)
    err_file.seek(0)
    if rc != 0:
        raise AssertionError("CPU history child failed (rc "
                             f"{rc}):\n{err_file.read().decode()[-4000:]}")
    return json.loads(out_file.read().decode().strip().splitlines()[-1])


def phase_family(n: int, itermax: int, cli_n: int, child=None,
                 child_timeout: float = 900.0) -> dict:
    """Phase 4: the f64 family on this process's device against the host
    CPU's histories (``child`` = (proc, out, err) started earlier, or None
    to compute them here), then the CLI's remaining modes at cli_n^3."""
    gpu = family_histories(n, itermax)
    if child is None:
        cpu = gpu_free_histories(n, itermax)
    else:
        cpu = finish_cpu_child(*child, timeout=child_timeout)
    worst = compare_histories(gpu, cpu)

    g = ["-x", str(cli_n), "-y", str(cli_n), "-z", str(cli_n)]
    bound = EXACT_BOUND["f32"]
    with tempfile.TemporaryDirectory() as tmp:
        for extra, b in (
            (["-t", "cg", "--precond", "jacobi"], bound),
            (["-t", "cg", "--precond", "cheb"], bound),
            (["-t", "cg", "--nrhs", "8"], bound),
            (["-t", "cg", "--refine"], bound),
            (["-t", "cg", "--checkpoint", os.path.join(tmp, "cg.ckpt")],
             bound),
            (["-t", "cg", "--profile"], bound),
            (["-t", "spmv"], None),
        ):
            run_cli(g + extra, b)
    return worst


def gpu_free_histories(n: int, itermax: int) -> dict:
    """family_histories in a child on the host CPU, run to completion."""
    with tempfile.TemporaryFile() as out, tempfile.TemporaryFile() as err:
        proc = start_cpu_child(n, itermax, out, err)
        return finish_cpu_child(proc, out, err, timeout=3600)


# ---------------------------------------------------------------- --four
def _parity(name: str, h, h_ref, legs: dict, scale=None) -> None:
    """Record max|h - h_ref| / scale (default: the initial residual)."""
    h, h_ref = np.asarray(h), np.asarray(h_ref)
    n = min(h.size, h_ref.size)
    keep = ~np.isnan(h_ref[:n])
    if not np.array_equal(keep, ~np.isnan(h[:n])):
        raise AssertionError(f"{name}: history NaN slots differ")
    scale = h_ref[0] if scale is None else scale
    err = float(np.abs(h[:n][keep] - h_ref[:n][keep]).max() / scale)
    legs[name] = err
    log(f"[four] {name}: {n} iterations, residual parity vs the "
        f"single-card solve {err:.2e} (bar {PARITY_BAR:g})")
    if not err <= PARITY_BAR:
        raise AssertionError(f"{name}: parity {err:.2e} > {PARITY_BAR:g}")


def phase_four(stencil_n: int, stored_n: int, itermax: int,
               size: int = 4) -> dict:
    """The sharded legs over ``size`` devices, f64, weak-scaled: the
    matrix-free z-slab stencil (blocking, --overlap, and the cs / sstep /
    pipe CG variants) at stencil_n^3 per card, and the stored formats
    (dia/allgather, sell/ppermute, bslab/ppermute, crs, GMRES on dia) at
    stored_n^3 per card. Every leg against the single-card solve of the
    stacked problem."""
    import jax

    jax.config.update("jax_enable_x64", True)
    from sparsebench.config import DTypePolicy
    from sparsebench.formats.dia import DiaMatrix
    from sparsebench.host import generate_stencil
    from sparsebench.parallel.dist import (
        build_distributed,
        dist_solve_cg,
        dist_solve_gmres,
        make_mesh,
    )
    from sparsebench.parallel.stencil_dist import (
        build_halo_stencil,
        dist_solve_cg_stencil,
    )
    from sparsebench.solvers.cg import init_vectors, solve_cg
    from sparsebench.solvers.gmres import solve_gmres

    policy = DTypePolicy.from_names("f64", "i32")
    mesh = make_mesh(size)
    legs: dict = {}
    kw = {"itermax": itermax, "eps": 0.0, "verbose": False}

    def serial(m):
        A, counts = DiaMatrix.from_stencil(m, m, m * size, policy=policy)
        _, b, _ = init_vectors(row_lengths=np.asarray(counts),
                               dtype=np.float64)
        return A, b

    # -- matrix-free z-slab stencil at stencil_n^3 per card
    m = stencil_n
    A1, b = serial(m)
    ref = {v: solve_cg(A1, b, variant=v, **kw)
           for v in ("standard", "sstep")}
    del A1
    Ah, _ = build_halo_stencil(m, m, m, size)
    for name, variant, overlap in (
        ("stencil/blocking", "standard", False),
        ("stencil/overlap", "standard", True),
        ("stencil/cs", "cs", False),
        ("stencil/pipe", "pipe", False),
        ("stencil/sstep", "sstep", False),
    ):
        t0 = time.perf_counter()
        res = dist_solve_cg_stencil(Ah, size, b, variant=variant,
                                    overlap=overlap, mesh=mesh, **kw)
        want = ref["sstep" if variant == "sstep" else "standard"]
        _parity(name, res.residual_history, want.residual_history, legs)
        log(f"[four] {name}: solve {res.solve_seconds:.4f} s "
            f"({time.perf_counter() - t0:.1f} s with compile)")

    # -- stored formats at stored_n^3 per card, host-partitioned shards
    m = stored_n
    A1, b = serial(m)
    ref = solve_cg(A1, b, **kw)
    ref_gm = solve_gmres(A1, b, **kw)
    del A1
    t0 = time.perf_counter()
    shards = [generate_stencil(m, m, m, rank=r, size=size,
                               dtype=np.float64) for r in range(size)]
    log(f"[four] host shards {m}^3 x {size}: "
        f"{time.perf_counter() - t0:.1f} s")
    for fmt, backend in (("dia", "allgather"), ("sell", "ppermute"),
                         ("bslab", "ppermute"), ("crs", "auto")):
        t0 = time.perf_counter()
        dm = build_distributed(shards, fmt=fmt, policy=policy, mesh=mesh,
                               exchange_backend=backend)
        build_s = time.perf_counter() - t0
        res = dist_solve_cg(dm, b, **kw)
        _parity(f"{fmt}/{backend}", res.residual_history,
                ref.residual_history, legs)
        log(f"[four] {fmt}/{backend}: build {build_s:.1f} s, solve "
            f"{res.solve_seconds:.4f} s")
        if fmt == "dia":
            # GMRES records one residual per restart cycle, the first of
            # them already far below ||b||: scale by ||b|| = ||r_0||
            res = dist_solve_gmres(dm, b, **kw)
            _parity("gmres/dia", res.residual_history,
                    ref_gm.residual_history, legs,
                    scale=float(np.linalg.norm(b)))
        del dm
    return legs


# ---------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the sharded legs on four cards, nothing else")
    ap.add_argument("--cpu-histories", nargs=2, type=int,
                    metavar=("N", "ITERS"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.cpu_histories:
        # the child of phase 4: host CPU only (JAX_PLATFORMS=cpu)
        n, iters = args.cpu_histories
        print(json.dumps(family_histories(n, iters)))
        return 0

    if args.four:
        info = phase_device(count=4)
        legs = phase_four(stencil_n=200, stored_n=100, itermax=150)
        log(f"[four] {len(legs)} legs, worst parity {max(legs.values()):.2e}")
    else:
        info = phase_device()
        with tempfile.TemporaryFile() as out, \
                tempfile.TemporaryFile() as err:
            child = start_cpu_child(100, 100, out, err)
            try:
                phase_main_path([
                    (["-t", "cg"], EXACT_BOUND["f32"]),
                    (["-f", "hpcg.par", "-t", "cg"], EXACT_BOUND["f32"]),
                    (["-f", "hpcg.par", "-t", "cg", "--dtype", "f64"],
                     EXACT_BOUND["f64"]),
                    (["-x", "512", "-y", "512", "-z", "512", "-t", "cg",
                      "--fmt", "dia", "-i", "50"], EXACT_BOUND["f32_50it"]),
                ])
                memory_report(512, 50)
                phase_replacements(200)
                phase_family(100, 100, cli_n=100,
                             child=(child, out, err))
            finally:
                if child.poll() is None:
                    child.kill()
                    child.wait()
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
