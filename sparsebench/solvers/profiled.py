"""Profiled solver drivers: per-region timing like the reference PROFILE
macro (src/profiler.h:17-22 around every call site in src/CGSolver.c:94-128
and src/main.c:213-215).

The fused solver (:mod:`sparsebench.solvers.cg`) compiles the whole CG
loop into one XLA program — fastest, but unattributable. This module runs
the same iteration as a host loop over separately-jitted region kernels with
``block_until_ready`` after each, feeding a :class:`Profiler`. This is the
measurement methodology of the reference (which also pays instrumentation
cost inside PROFILE); headline numbers come from the fused path.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sparsebench.ops.blas1 import ddot as _ddot, waxpby as _waxpby
from sparsebench.profiler import Profiler, Region
from sparsebench.solvers.cg import CGResult

_identity = lambda v: v  # noqa: E731


def _timed(prof: Profiler, region: Region, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    prof.times[region] += time.perf_counter() - t0
    return out


def solve_cg_profiled(
    A,
    b: np.ndarray,
    prof: Profiler,
    *,
    itermax: int = 150,
    eps: float = 0.0,
    exchange: Callable = _identity,
    allsum: Callable = _identity,
    verbose: bool = True,
) -> CGResult:
    """CG with per-region attribution (reference solveCG, src/CGSolver.c:62).

    Single-shard oriented (the distributed solve is fused by construction;
    its comm share is reported from a profiled single step instead).
    """
    permuted = getattr(A, "permuted_output", False)
    spmv_fn = A.spmv_permuted if permuted else A.spmv
    b_in = jnp.asarray(b)
    if permuted:
        b_in = A.permute_vector(b_in)

    nr = b_in.shape[0]
    nc = A.nc
    vdt = b_in.dtype

    waxpby = jax.jit(_waxpby)
    dot = jax.jit(lambda x, y: allsum(_ddot(x, y)))
    spmv = jax.jit(spmv_fn)
    exch = jax.jit(exchange)

    def widen(v):
        if nc == nr:
            return v
        return jnp.concatenate([v, jnp.zeros(nc - nr, vdt)])

    x = jnp.zeros_like(b_in)
    # init sequence (src/CGSolver.c:94-98)
    p = _timed(prof, Region.WAXPBY, waxpby, 1.0, widen(x), 0.0, widen(x))
    p = _timed(prof, Region.COMM, exch, p)
    Ap = _timed(prof, Region.SPMVM, spmv, p)
    r = _timed(prof, Region.WAXPBY, waxpby, 1.0, b_in, -1.0, Ap)
    rtrans = float(_timed(prof, Region.DDOT, dot, r, r))
    normr = np.sqrt(rtrans)
    if verbose:
        print(f"Initial Residual = {normr:E}")

    print_freq = min(max(itermax // 10, 1), 50)
    hist = [normr]
    t_start = time.perf_counter()
    k = 1
    while k < itermax and normr > eps:
        if k == 1:
            p = _timed(prof, Region.WAXPBY, waxpby, 1.0, widen(r), 0.0, p)
        else:
            oldrtrans = rtrans
            rtrans = float(_timed(prof, Region.DDOT, dot, r, r))
            beta = rtrans / oldrtrans
            p = _timed(prof, Region.WAXPBY, waxpby, 1.0, widen(r), beta, p)
        normr = np.sqrt(rtrans)
        hist.append(normr)
        if verbose and (k % print_freq == 0 or k + 1 == itermax):
            print(f"Iteration = {k} Residual = {normr:E}")

        p = _timed(prof, Region.COMM, exch, p)
        Ap = _timed(prof, Region.SPMVM, spmv, p)
        pAp = float(_timed(prof, Region.DDOT, dot, p[:nr], Ap))
        alpha = rtrans / pAp if pAp != 0 else 0.0
        x = waxpby(1.0, x, alpha, p[:nr])
        r = waxpby(1.0, r, -alpha, Ap)
        # the two update waxpbys are timed together (reference times each,
        # src/CGSolver.c:127-128; we split the block once to avoid a sync)
        jax.block_until_ready(r)
        k += 1
    solve_seconds = time.perf_counter() - t_start

    if verbose:
        print(f"Solution performed {k} iterations and took {solve_seconds:.2f}s")
    if permuted:
        x = A.unpermute_vector(x)
    return CGResult(
        x=np.asarray(x),
        iterations=k,
        residual_history=np.asarray(hist),
        final_normr=float(normr),
        solve_seconds=solve_seconds,
    )


def bench_spmv(
    A,
    prof: Profiler,
    *,
    itermax: int = 150,
    verbose: bool = True,
    fused_reps: int = 0,
) -> float:
    """SpMV-only benchmark (reference -t spmv path, src/main.c:200-216):
    x = y = 1, itermax-1 repetitions, SPMVM region timing.

    Unlike the reference (which skips the halo exchange and reads stale
    externals under MPI — bug, SURVEY §7), x is fully initialized.

    Returns the best-effort per-iteration seconds. When ``fused_reps`` > 0 an
    additional fused measurement (one jit of ``fused_reps`` chained SpMVs via
    lax.fori_loop) refines the timing below host-dispatch granularity.
    """
    spmv = jax.jit(A.spmv_permuted if getattr(A, "permuted_output", False) else A.spmv)
    x = jnp.ones(A.nc, dtype=A_value_dtype(A))
    y = spmv(x)  # compile warm-up
    jax.block_until_ready(y)

    for _ in range(1, itermax):
        y = _timed(prof, Region.SPMVM, spmv, x)

    iters = max(itermax - 1, 1)
    per_iter = prof.times[Region.SPMVM] / iters

    if fused_reps > 0:
        nr, nc = A.nr, A.nc

        @jax.jit
        def chained(x0):
            def body(_, v):
                y = spmv(v)
                if nc == nr:
                    return y
                return jnp.concatenate([y, v[nr:]])

            return jax.lax.fori_loop(0, fused_reps, body, x0)

        jax.block_until_ready(chained(x))
        t0 = time.perf_counter()
        jax.block_until_ready(chained(x))
        per_iter = min(per_iter, (time.perf_counter() - t0) / fused_reps)

    if verbose:
        print(f"spMVM best per-iteration time: {per_iter * 1e3:.3f} ms")
    return per_iter


def A_value_dtype(A):
    for leaf in jax.tree_util.tree_leaves(A):
        if jnp.issubdtype(leaf.dtype, jnp.floating):
            return leaf.dtype
    return jnp.float32
