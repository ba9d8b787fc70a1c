"""Profiled distributed drivers: per-region attribution for mesh-sharded
runs (reference multi-rank profiler, src/profiler.c:47-124).

The fused distributed solve (parallel/dist.py) compiles the whole CG loop
into one shard_map program — fastest, but regions are unattributable by
design. This module runs the same iteration as a host loop over
separately-jitted shard_map region kernels (WAXPBY / COMM / SPMVM / DDOT),
exactly mirroring the single-device profiled mode
(solvers/profiled.py) and the reference's PROFILE call sites
(src/CGSolver.c:94-128, src/main.c:213-215).

One host clock drives the whole mesh, so per-shard walltimes coincide
(min == max == avg in the report) — the honest translation of MPI
per-rank timers for a lockstep SPMD program.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from sparsebench.parallel.dist import AXIS, DistMatrix, P
from sparsebench.profiler import Profiler, Region
from sparsebench.solvers.cg import CGResult


def _timed(prof: Profiler, region: Region, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    prof.times[region] += time.perf_counter() - t0
    return out


def _region_kernels(dm: DistMatrix, vdt):
    """Separately-jitted shard_map kernels, one per profiler region."""
    plan = dm.part.plan
    halo = plan.halo_max
    nrm = plan.nr_max
    mesh = dm.mesh

    def smap(f, in_specs, out_specs):
        return jax.jit(
            jax.shard_map(
                f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                check_vma=False,
            )
        )

    # w = alpha*x + beta*y on (size, n) stacked vectors (reference waxpby,
    # src/solver.c:16-39). alpha/beta ride as replicated scalars.
    waxpby = smap(
        lambda a, x, be, y: a * x + be * y,
        (P(), P(AXIS), P(), P(AXIS)), P(AXIS),
    )

    # p = widen(r) + beta*p — the fused p-update producing the halo-tailed
    # working vector (reference allocates p at ncol, src/CGSolver.c:70)
    def _upd_p(r, be, p):
        loc = jnp.concatenate([r[0], jnp.zeros(halo, vdt)]) + be * p[0]
        return loc[None]

    update_p = smap(_upd_p, (P(AXIS), P(), P(AXIS)), P(AXIS))

    exch = smap(lambda ps: dm.exchange(ps[0])[None], (P(AXIS),), P(AXIS))

    def _spmv(A_st, ps):
        A = jax.tree_util.tree_map(lambda l: l[0], A_st)
        f = A.spmv_permuted if dm.permuted else A.spmv
        return f(ps[0])[None]

    spmv = smap(_spmv, (P(AXIS), P(AXIS)), P(AXIS))

    # global dot: local partial + allsum (psum over the mesh axis) — the
    # reference's ddot with the embedded MPI_Allreduce (src/solver.c:41-62)
    def _dot(u, v):
        return dm.allsum(jnp.sum(u[0][:nrm] * v[0][:nrm]))

    dot = smap(_dot, (P(AXIS), P(AXIS)), P())
    return waxpby, update_p, exch, spmv, dot


def dist_solve_cg_profiled(
    dm: DistMatrix,
    b_global: np.ndarray,
    prof: Profiler,
    *,
    itermax: int = 150,
    eps: float = 0.0,
    verbose: bool = True,
) -> CGResult:
    """Distributed CG with per-region attribution (reference solveCG under
    MPI with PROFILE instrumentation, src/CGSolver.c:62-136)."""
    plan = dm.part.plan
    halo = plan.halo_max
    b = jnp.asarray(dm.shard_vector(np.asarray(b_global)))
    vdt = b.dtype
    size, nrm = b.shape
    waxpby, update_p, exch, spmv, dot = _region_kernels(dm, vdt)

    one = jnp.asarray(1.0, vdt)
    zero = jnp.asarray(0.0, vdt)

    x = jnp.zeros_like(b)
    # init sequence (src/CGSolver.c:94-98): p = widen(x0), exchange, Ap, r
    p = _timed(prof, Region.WAXPBY, update_p,
               x, zero, jnp.zeros((size, nrm + halo), vdt))
    p = _timed(prof, Region.COMM, exch, p)
    Ap = _timed(prof, Region.SPMVM, spmv, dm.A, p)
    r = _timed(prof, Region.WAXPBY, waxpby, one, b, -one, Ap)
    rtrans = float(_timed(prof, Region.DDOT, dot, r, r))
    normr = float(np.sqrt(rtrans))
    if verbose:
        print(f"Initial Residual = {normr:E}")

    print_freq = min(max(itermax // 10, 1), 50)
    hist = [normr]
    t_start = time.perf_counter()
    k = 1
    while k < itermax and normr > eps:
        if k == 1:
            p = _timed(prof, Region.WAXPBY, update_p, r, zero, p)
        else:
            oldrtrans = rtrans
            rtrans = float(_timed(prof, Region.DDOT, dot, r, r))
            beta = jnp.asarray(rtrans / oldrtrans, vdt)
            p = _timed(prof, Region.WAXPBY, update_p, r, beta, p)
        normr = float(np.sqrt(rtrans))
        hist.append(normr)
        if verbose and (k % print_freq == 0 or k + 1 == itermax):
            print(f"Iteration = {k} Residual = {normr:E}")

        p = _timed(prof, Region.COMM, exch, p)
        Ap = _timed(prof, Region.SPMVM, spmv, dm.A, p)
        pAp = float(_timed(prof, Region.DDOT, dot, p[:, :nrm], Ap))
        alpha = jnp.asarray(rtrans / pAp if pAp != 0 else 0.0, vdt)
        x = waxpby(one, x, alpha, p[:, :nrm])
        r = waxpby(one, r, -alpha, Ap)
        # the two update waxpbys are timed as one block (one sync)
        t0 = time.perf_counter()
        jax.block_until_ready(r)
        prof.times[Region.WAXPBY] += time.perf_counter() - t0
        k += 1
    solve_seconds = time.perf_counter() - t_start

    if verbose:
        print(f"Solution performed {k} iterations and took {solve_seconds:.2f}s")
    return CGResult(
        x=dm.unshard_vector(np.asarray(x)),
        iterations=k,
        residual_history=np.asarray(hist),
        final_normr=float(normr),
        solve_seconds=solve_seconds,
    )


def dist_bench_spmv(
    dm: DistMatrix,
    prof: Profiler,
    *,
    itermax: int = 150,
    verbose: bool = True,
) -> float:
    """Distributed SpMV benchmark through the profiler (reference -t spmv
    under MPI, src/main.c:200-216: itermax-1 PROFILE(SPMVM, ...) reps).

    Unlike the reference — which skips the halo exchange in this path and
    reads stale externals under MPI (bug, SURVEY §7) — the exchange runs
    every rep and is attributed to the COMM region.
    """
    plan = dm.part.plan
    halo = plan.halo_max
    vdt = np.float32
    for leaf in jax.tree_util.tree_leaves(dm.A):
        if jnp.issubdtype(leaf.dtype, jnp.floating):
            vdt = leaf.dtype
            break
    waxpby, update_p, exch, spmv, dot = _region_kernels(dm, vdt)

    size, nrm = plan.size, plan.nr_max
    p = jnp.ones((size, nrm + halo), vdt)
    # compile warm-ups outside the timed region
    jax.block_until_ready(exch(p))
    jax.block_until_ready(spmv(dm.A, p))

    for _ in range(1, itermax):
        # the exchange overwrites the halo tail each rep — no reset needed
        p = _timed(prof, Region.COMM, exch, p)
        y = _timed(prof, Region.SPMVM, spmv, dm.A, p)
    iters = max(itermax - 1, 1)
    per_iter = prof.times[Region.SPMVM] / iters
    if verbose:
        print(f"spMVM per-iteration time: {per_iter * 1e3:.3f} ms "
              f"(+ {prof.times[Region.COMM] / iters * 1e3:.3f} ms halo "
              f"exchange)")
    return per_iter
