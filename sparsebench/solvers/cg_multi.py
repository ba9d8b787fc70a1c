"""Blocked (multi-RHS) Conjugate Gradient: k independent systems, one A.

Beyond the reference (src/CGSolver.c solves a single right-hand side):
a capability that amortizes the dominant device-memory stream. SpMV is
bandwidth-bound and the matrix bytes dwarf the vector bytes (27
diagonals x 8 B vs 2 x 8 B per row for the stencil problem); solving k
right-hand sides in one loop reads the matrix ONCE per iteration for
all k columns, so per-RHS matrix traffic drops k-fold. The BLAS-1 work
becomes (k, n) slabs, and the 2 reductions per iteration reduce k
scalars in one pass (one fused allreduce of a (2, k) block in the
distributed layer's terms).

LAYOUT: the public API is (nr, k) column blocks (numpy convention), but
every device slab inside the loop is **(k, n) slab-major**: each RHS is
a contiguous row, so DIA's shifted slices stay contiguous and every
elementwise op streams unit-stride rows.

This is *simultaneous* CG — each column runs the reference's exact
iteration (src/CGSolver.c:94-129) independently, with per-column
alpha/beta scalars; it is NOT block-CG with a shared Krylov space (no
cross-column coupling, so per-column iterates match k separate
``cg_loop`` runs to reduction-order rounding; for bf16 this holds on
the format's own accumulation discipline — formats/dia.py spmm_kn).
Columns that converge (normr <= eps) or break down freeze in place
(alpha = 0) while the rest keep iterating, mirroring the single-RHS
loop's exit semantics per column. Known cost of the masked-SIMD design:
frozen columns still ride every slab op and reduction until the last
active column finishes — at very uneven per-column convergence the
tail iterations waste their share of bandwidth (accepted: a compacting
design would need data-dependent shapes, which XLA cannot compile).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sparsebench.solvers._jitcache import jit_loop
from sparsebench.solvers.cg import (
    CGResult,
    default_acc_dtype,
    print_residual_history,
    safe_div,
)

_identity = lambda v: v  # noqa: E731


def make_spmm(A) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """(nc, k) -> (nr, k) multi-RHS apply for any device format
    (column-block convention; thin transpose over :func:`make_spmm_kn`)."""
    kn = make_spmm_kn(A)
    return lambda X: kn(X.T).T


def make_spmm_kn(A) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """(k, nc) -> (k, nr) slab-major multi-RHS apply.

    Formats with a native ``spmm_kn`` (DIA: one XLA broadcast pass per
    diagonal, formats/dia.py) use it; a native column-block ``spmm`` is
    wrapped in transposes; everything else vmaps the format's
    single-vector ``spmv`` over the leading axis — functionally
    identical, though without matrix-stream amortization. Row-permuting
    formats (SELL) are applied in permuted space, matching the
    single-RHS solvers' convention (solvers/cg.py _make_helpers).
    """
    if hasattr(A, "spmm_kn"):
        return A.spmm_kn
    if hasattr(A, "spmm"):
        return lambda X: A.spmm(X.T).T
    spmv = A.spmv_permuted if getattr(A, "permuted_output", False) else A.spmv
    return jax.vmap(spmv, in_axes=0, out_axes=0)


def cg_multi_loop(
    A,
    B: jnp.ndarray,
    X0: jnp.ndarray,
    itermax: int,
    eps,
    allsum: Callable = _identity,
    acc_dtype=None,
):
    """Jittable simultaneous CG over the rows of ``B`` (k, nr) —
    slab-major layout (module docstring).

    Returns (X, iters, hist): X (k, nr) in the format's row order,
    iters (k,) per-column iteration counts (the reference's returned k,
    src/CGSolver.c:138, per column), hist (itermax, k) per-column
    ||r|| history (NaN where a column had already stopped).

    Per column this is the reference iteration exactly — beta, the two
    dots and alpha are (k,)-vectors, the axpys broadcast over the slab.
    Serial (single-device) only: the halo-exchange seam is per-vector;
    use the single-RHS distributed drivers for sharded solves.
    ``allsum`` is kept for (k,)-vector reductions (identity serially).
    """
    k_rhs, nr = B.shape
    vdt = B.dtype
    sdt = default_acc_dtype(vdt, acc_dtype)
    spmm = make_spmm_kn(A)
    nc = A.nc

    def widen(V):
        # (k, nc) working slab with halo tail (reference allocates p at
        # ncol, src/CGSolver.c:70)
        if nc == nr:
            return V
        return jnp.concatenate(
            [V, jnp.zeros((k_rhs, nc - nr), vdt)], axis=1
        )

    def dots(U, V):
        # per-column sum-reduction (solvers/cg.py dot: tree-sum, not a
        # matmul, for accuracy), one pass for all k columns
        return allsum(jnp.sum(U.astype(sdt) * V.astype(sdt), axis=1))

    R = B - spmm(widen(X0))
    rtrans0 = dots(R, R)
    normr0 = jnp.sqrt(rtrans0)
    hist0 = jnp.full((itermax, k_rhs), jnp.nan, dtype=sdt).at[0].set(normr0)
    eps_a = jnp.asarray(eps, sdt)
    active0 = normr0 > eps_a
    state = (
        jnp.asarray(1), X0, jnp.zeros((k_rhs, nc), vdt), R,
        rtrans0, normr0, hist0, active0,
        jnp.ones(k_rhs, dtype=jnp.int32),
    )

    def cond(state):
        k, _X, _P, _R, _rt, _normr, _hist, active, _iters = state
        return jnp.logical_and(k < itermax, jnp.any(active))

    def body(state):
        k, X, P, R, rtrans, normr, hist, active, iters = state
        # dots(R, R) runs every iteration including k == 1 (where the
        # init value is reused) — one wasted slab read on the first
        # trip only; a lax.cond here would split the fusion
        new_rtrans = jnp.where(k == 1, rtrans, dots(R, R))
        beta = jnp.where(k == 1, jnp.zeros_like(rtrans),
                         safe_div(new_rtrans, rtrans))
        P = jnp.where(active[:, None], widen(R) + beta[:, None].astype(vdt) * P, P)
        normr_k = jnp.sqrt(new_rtrans)
        hist = hist.at[k].set(jnp.where(active, normr_k, jnp.nan))
        AP = spmm(P)
        pAp = dots(P[:, :nr], AP)
        # per-column breakdown guard (see cg_run, solvers/cg.py): at
        # machine-zero residual alpha would blow up; freeze that column
        breakdown = pAp <= new_rtrans * 1e-30
        step = jnp.logical_and(active, jnp.logical_not(breakdown))
        alpha = jnp.where(step, safe_div(new_rtrans, pAp), 0).astype(vdt)
        X = X + alpha[:, None] * P[:, :nr]
        R = R - alpha[:, None] * AP
        iters = iters + active.astype(jnp.int32)
        normr = jnp.where(active, normr_k, normr)
        active = jnp.logical_and(step, normr_k > eps_a)
        return (k + 1, X, P, R, new_rtrans, normr, hist, active, iters)

    (_k, X, _P, _R, _rt, _normr, hist, _active, iters) = jax.lax.while_loop(
        cond, body, state
    )
    return X, iters, hist


def solve_cg_multi(
    A,
    B: np.ndarray,
    *,
    X0: Optional[np.ndarray] = None,
    itermax: int = 150,
    eps: float = 0.0,
    acc_dtype=None,
    verbose: bool = True,
) -> CGResult:
    """Host driver for the blocked solve. ``B`` is (nr, k) in original
    row order; returns a CGResult whose ``x`` is the (nr, k) solution
    slab, ``iterations`` the max per-column count, and
    ``residual_history`` the (iters, k) per-column history. The
    transposes into the internal (k, n) layout run once on device."""
    B = jnp.asarray(B)
    if B.ndim != 2:
        raise ValueError(f"B must be (nr, k), got shape {B.shape}")
    X0 = jnp.zeros_like(B) if X0 is None else jnp.asarray(X0)

    permuted = getattr(A, "permuted_output", False)
    if permuted:
        perm_rows = jax.vmap(A.permute_vector)
        B_in, X0_in = perm_rows(B.T), perm_rows(X0.T)
    else:
        B_in, X0_in = B.T, X0.T

    loop = jit_loop(cg_multi_loop, itermax=itermax, acc_dtype=acc_dtype)
    eps_arr = jnp.asarray(eps, dtype=acc_dtype or B.dtype)

    # warm-up compile outside the timed section (solve_cg convention)
    X_dev, iters_dev, hist_dev = loop(A, B_in, X0_in, eps=eps_arr)
    int(iters_dev[0])

    t0 = time.perf_counter()
    X_dev, iters_dev, hist_dev = loop(A, B_in, X0_in, eps=eps_arr)
    iters = np.asarray(iters_dev)  # sync: depends on the whole loop
    t1 = time.perf_counter()

    if permuted:
        X_dev = jax.vmap(A.unpermute_vector)(X_dev)
    hist = np.asarray(hist_dev)
    k = int(iters.max())
    if verbose:
        print(f"[cg-multi] {B.shape[1]} right-hand sides, per-column "
              f"iterations {iters.min()}..{iters.max()}")
        print_residual_history(hist[:, 0], int(iters[0]), itermax)
        print(f"Solution performed {k} iterations and took {t1 - t0:.2f}s")

    finals = hist[np.maximum(iters - 1, 0), np.arange(hist.shape[1])]
    return CGResult(
        x=np.asarray(X_dev).T,
        iterations=k,
        residual_history=hist[:k],
        final_normr=float(np.nanmax(finals)),
        solve_seconds=t1 - t0,
    )
