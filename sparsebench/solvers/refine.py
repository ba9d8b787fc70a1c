"""Mixed-precision iterative-refinement CG (beyond the reference, which
is single-precision-per-build: src/util.h:35-53 fixes CG_FLOAT at
compile time).

Rationale: SpMV is device-memory-bandwidth-bound, and bf16
halves every stored byte — diagonals, slabs, vectors — so a bf16 inner
solve streams ~2x faster than f32. bf16's 8-bit mantissa cannot carry a
CG recurrence to f32 accuracy, but classic iterative refinement
(Wilkinson; mixed-precision analysis: Carson & Higham 2018) restores
it: the OUTER loop computes the true residual in working precision and
the INNER solver only ever solves for the correction

    repeat:  r = b - A_hi x          (working precision, true residual)
             d ~= A_lo^-1 r          (low-precision CG, cheap)
             x += d

Each sweep multiplies the error by roughly the inner solve's relative
residual (5e-2 by default — comfortably above bf16's ~4e-3 attainable
floor), so f32 accuracy arrives in a handful of sweeps while >90% of the
FLOPs/bytes run at bf16 rates. bf16 shares f32's exponent range, so the
shrinking residuals never need rescaling.

The whole two-level iteration is ONE jitted program: the outer
lax.while_loop carries x in working precision and calls the standard
``cg_loop`` (itself a lax.while_loop) on the low-precision operator —
no host round-trips between sweeps. Distributed runs inject the same
``exchange``/``allsum`` as every other solver; per inner iteration the
communication structure is exactly standard CG's (2 psums + 1 halo
exchange), just on half-width payloads, plus one residual psum per
sweep.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sparsebench.solvers.cg import (
    CGResult,
    cg_loop,
    default_acc_dtype,
)

_identity = lambda v: v  # noqa: E731


def refine_lo_dtype(hi_dtype):
    """The one-step-down storage dtype for the inner solve: f64 -> f32,
    f32 -> bf16. bf16 itself has no headroom below it."""
    d = jnp.dtype(hi_dtype)
    if d == jnp.float64:
        return jnp.float32
    if d == jnp.float32:
        return jnp.bfloat16
    raise ValueError(
        f"iterative refinement needs precision headroom below {d.name}; "
        "run the inner precision directly instead"
    )


def refine_lo_policy(policy):
    """(lo_policy, lo_name) one value-dtype down from ``policy`` (index
    dtype unchanged) — the CLI/driver helper matching refine_lo_dtype."""
    from sparsebench.config import DTypePolicy

    name = {"float64": "f32", "float32": "bf16"}.get(
        np.dtype(policy.value).name
    )
    if name is None:
        refine_lo_dtype(policy.value)  # raises with the guidance
    idx = "i64" if policy.index == np.int64 else "i32"
    return DTypePolicy.from_names(name, idx), name


def cg_refine_loop(
    A_hi,
    A_lo,
    b: jnp.ndarray,
    x0: jnp.ndarray,
    outer_max: int,
    inner_iters: int,
    eps,
    exchange: Callable[[jnp.ndarray], jnp.ndarray] = _identity,
    allsum: Callable = _identity,
    acc_dtype=None,
    inner_eps_factor: float = 0.05,
    stall_factor: float = 0.9,
):
    """Jittable IR-CG. ``A_hi``/``A_lo`` are device formats over the SAME
    matrix in working/low precision and the SAME row order (for
    row-permuting formats both must share the permutation — the drivers
    build them from one spec). ``b``/``x0`` are working-precision
    vectors already in the format's row order.

    Returns ``(x, sweeps, total_inner, hist)`` where ``hist[j]`` is the
    TRUE residual norm entering sweep j (hist[0] = initial) and
    ``total_inner`` counts inner CG iterations across sweeps. Exits on
    ``normr <= eps``, on ``outer_max`` sweeps, or on stagnation (a sweep
    that shrank the residual by less than ``stall_factor`` — the inner
    precision's attainable floor; iterating past it cannot help).
    """
    nr = b.shape[0]
    nc = A_hi.nc
    vdt = b.dtype
    ldt = refine_lo_dtype(vdt)
    sdt = default_acc_dtype(vdt, acc_dtype)
    spmv = (A_hi.spmv_permuted
            if getattr(A_hi, "permuted_output", False) else A_hi.spmv)

    def widen(v):
        if nc == nr:
            return v
        return jnp.concatenate([v, jnp.zeros(nc - nr, vdt)])

    def true_normr(x):
        r = (b - spmv(exchange(widen(x)))).astype(vdt)
        rr = allsum(jnp.sum(r.astype(sdt) * r.astype(sdt)))
        return r, jnp.sqrt(jnp.maximum(rr, 0))

    inner = partial(
        cg_loop, itermax=inner_iters, exchange=exchange, allsum=allsum,
        acc_dtype=jnp.float32 if jnp.dtype(ldt) == jnp.bfloat16 else None,
    )

    r0, normr0 = true_normr(x0)
    hist0 = jnp.full(outer_max + 1, jnp.nan, dtype=sdt).at[0].set(normr0)
    zeros_lo = jnp.zeros(nr, ldt)

    # state: (sweep, x, r, normr, total_inner, hist, done)
    state = (jnp.asarray(0), x0, r0, normr0, jnp.asarray(0), hist0,
             jnp.asarray(False))

    def cond(st):
        sweep, _x, _r, normr, _ti, _hist, done = st
        return jnp.logical_and(
            jnp.logical_and(sweep < outer_max, normr > eps),
            jnp.logical_not(done),
        )

    def body(st):
        sweep, x, r, normr, total_inner, hist, _done = st
        eps_inner = (inner_eps_factor * normr).astype(
            jnp.float32 if jnp.dtype(ldt) == jnp.bfloat16 else ldt
        )
        d_lo, k_in, _ih = inner(A_lo, r.astype(ldt), zeros_lo,
                                eps=eps_inner)
        x = x + d_lo.astype(vdt)
        r_new, normr_new = true_normr(x)
        hist = hist.at[sweep + 1].set(normr_new)
        # stagnation = the inner precision's floor; a further sweep
        # re-solves the same system to the same floor
        done = normr_new >= normr * stall_factor
        return (sweep + 1, x, r_new, normr_new, total_inner + k_in,
                hist, done)

    sweep, x, _r, _normr, total_inner, hist, _done = jax.lax.while_loop(
        cond, body, state
    )
    return x, sweep, total_inner, hist


def solve_cg_refine(
    A_hi,
    b: np.ndarray,
    *,
    A_lo=None,
    x0: Optional[np.ndarray] = None,
    outer_max: int = 12,
    inner_iters: int = 100,
    eps: float = 0.0,
    exchange: Callable = _identity,
    allsum: Callable = _identity,
    acc_dtype=None,
    inner_eps_factor: float = 0.05,
    verbose: bool = True,
) -> CGResult:
    """Host driver (mirrors solve_cg): permutation handling, jit, timing,
    per-sweep residual printing. ``A_lo`` defaults to ``A_hi`` — correct
    for dtype-agnostic operators (the matrix-free stencil, whose apply
    adopts the vector dtype); matrix formats must pass a genuinely
    low-precision build for the bandwidth win to materialize.

    ``eps == 0`` runs to the stagnation floor (the low precision's
    attainable limit) — the analog of the reference's fixed-work mode.
    """
    if A_lo is None:
        A_lo = A_hi
    b = jnp.asarray(b)
    if jnp.dtype(b.dtype) == jnp.bfloat16:
        raise ValueError("iterative refinement needs b in f32/f64 — the "
                         "low precision is derived one step down")
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)

    permuted = getattr(A_hi, "permuted_output", False)
    if permuted != getattr(A_lo, "permuted_output", False):
        raise ValueError("A_hi and A_lo must share row order")
    if permuted:
        b_in = A_hi.permute_vector(b)
        x0_in = A_hi.permute_vector(x0)
    else:
        b_in, x0_in = b, x0

    from sparsebench.solvers._jitcache import jit_loop

    loop = jit_loop(cg_refine_loop, outer_max=outer_max,
                    inner_iters=inner_iters, exchange=exchange,
                    allsum=allsum, acc_dtype=acc_dtype,
                    inner_eps_factor=inner_eps_factor)
    eps_arr = jnp.asarray(eps, dtype=acc_dtype or b.dtype)

    # warm-up compile outside the timed section (see solve_cg)
    x_dev, s_dev, ti_dev, hist_dev = loop(A_hi, A_lo, b_in, x0_in,
                                          eps=eps_arr)
    int(s_dev)

    t0 = time.perf_counter()
    x_dev, s_dev, ti_dev, hist_dev = loop(A_hi, A_lo, b_in, x0_in,
                                          eps=eps_arr)
    sweeps = int(s_dev)
    t1 = time.perf_counter()

    if permuted:
        x_dev = A_hi.unpermute_vector(x_dev)
    total_inner = int(ti_dev)
    hist = np.asarray(hist_dev)
    if verbose:
        print(f"Initial Residual = {hist[0]:E}")
        for j in range(1, sweeps + 1):
            if not np.isnan(hist[j]):
                print(f"Refinement sweep = {j} Residual = {hist[j]:E}")
        print(f"Solution performed {sweeps} sweeps / {total_inner} "
              f"low-precision iterations and took {t1 - t0:.2f}s")

    final = hist[sweeps] if sweeps > 0 else hist[0]
    return CGResult(
        x=np.asarray(x_dev),
        iterations=total_inner,
        residual_history=hist[: sweeps + 1],
        final_normr=float(final),
        solve_seconds=t1 - t0,
    )
