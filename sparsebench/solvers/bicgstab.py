"""BiCGStab solver (van der Vorst 1992) — beyond the reference.

The reference's bench enum stops at {CG, SPMV, GMRES, CHEBFD}
(src/main.c:22); for non-symmetric systems it offers only the (empty)
GMRES slot. GMRES(m) — implemented in solvers/gmres.py — pays O(m·n)
basis memory and O(m) orthogonalization dots per cycle; BiCGStab is the
complementary short-recurrence method: constant memory (7 vectors),
2 matvecs + 3 allreduces (two fused) per iteration, no restart
parameter.

Design matches the CG family: one fused ``lax.while_loop`` under a
single jit, injected ``exchange``/``allsum`` hooks so the serial and
distributed solves are the same code, dots as elementwise-multiply +
tree-sum (see cg.py on XLA dot precision), and bf16 values accumulate
in f32 (default_acc_dtype).

Per iteration (right Jacobi preconditioning via ``inv_diag``; M = I
otherwise):

    [rho' = <rhat, r>, ||r||^2]                    } allreduce 1 (fused)
    beta = (rho'/rho)(alpha/omega)
    p = r + beta (p - omega v)
    v = A M^-1 p
    alpha = rho' / <rhat, v>                       } allreduce 2
    s = r - alpha v
    t = A M^-1 s
    [t.s, t.t]                                     } allreduce 3 (fused)
    omega = t.s / t.t
    x += alpha M^-1 p + omega M^-1 s
    r = s - omega t

The residual norm rides the rho reduction and is computed from the
ACTUAL r vector at iteration start (cg_run's history semantics; exit is
one iteration stale like standard CG). Deriving it algebraically from
the omega reduction (s.s - 2w t.s + w^2 t.t) was measured to
catastrophically cancel near the attainable floor — see the body.

Breakdown guards (all freeze-and-exit like cg_run's): rho' ~ 0 (rhat
deflation), <rhat, v> ~ 0, t.t = 0 (exact convergence at the s-step —
then x += alpha M^-1 p alone is the converged update, omega = 0).
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
    default_acc_dtype,
    print_residual_history,
    safe_div,
)
from sparsebench.solvers.precond import resolve_apply_m

_identity = lambda v: v  # noqa: E731


def bicgstab_loop(
    A,
    b: jnp.ndarray,
    x0: jnp.ndarray,
    itermax: int,
    eps,
    exchange: Callable[[jnp.ndarray], jnp.ndarray] = _identity,
    allsum: Callable = _identity,
    acc_dtype=None,
    inv_diag=None,
    precond=None,
):
    """Jittable BiCGStab; same contract as cg_loop (returns
    (x, k, history)). ``precond`` (solvers/precond.py ChebPrecond)
    switches the right preconditioner from Jacobi to the Chebyshev
    polynomial operator (scaled by ``inv_diag`` when both are given).

    Residual semantics match the CG family (and the reference's CG):
    the reported norm is the RECURRENCE residual's — computed from the
    actual maintained r vector, never derived algebraically from the
    omega reduction (see body) — and like every recurrence method it
    decays below the true ||b - A x|| floor in low precision; x accuracy
    is the oracle there (tests). Mid-stream replacement of r with the
    true residual was tried and REJECTED: it breaks the biorthogonality
    against the fixed rhat and the run destabilizes (measured f32 8^3:
    residual spiked 2.5e-7 -> 29.7 at the first replacement and x
    accuracy degraded 1000x). When the maintained r underflows to zero
    the rho breakdown guard exits the loop cleanly."""
    nr = b.shape[0]
    nc = A.nc
    vdt = b.dtype
    sdt = default_acc_dtype(vdt, acc_dtype)
    spmv = A.spmv_permuted if getattr(A, "permuted_output", False) else A.spmv

    def widen(v):
        if nc == nr:
            return v
        return jnp.concatenate([v, jnp.zeros(nc - nr, vdt)])

    def apply_a(v):
        return spmv(exchange(widen(v))).astype(vdt)

    _am = resolve_apply_m(precond, inv_diag, apply_a, vdt)

    def apply_minv(v):
        return _am(v) if _am is not None else v

    def matvec_minv(v):
        # A M^-1 v (right preconditioning: the residual stays true)
        return apply_a(apply_minv(v))

    def dot(u, v):
        return allsum(jnp.sum(u.astype(sdt) * v.astype(sdt)))

    r0 = (b - spmv(exchange(widen(x0)))).astype(vdt)
    rhat = r0  # fixed shadow residual
    rr0 = dot(r0, r0)
    normr0 = jnp.sqrt(jnp.maximum(rr0, 0))
    hist0 = jnp.full(itermax, jnp.nan, dtype=sdt).at[0].set(normr0)

    zeros = jnp.zeros(nr, vdt)
    one = jnp.ones((), sdt)
    # state: (k, x, r, p, v, rho, alpha, omega, normr, hist, done)
    state = (jnp.asarray(1), x0, r0, zeros, zeros, one, one, one,
             normr0, hist0, jnp.asarray(False))

    def cond(st):
        k, _x, _r, _p, _v, _rho, _al, _om, normr, _h, done = st
        return jnp.logical_and(
            jnp.logical_and(k < itermax, normr > eps), jnp.logical_not(done)
        )

    def body(st):
        k, x, r, p, v, rho, alpha, omega, _normr, hist, done = st

        # rho AND the true ||r||^2 in one fused reduction. The norm MUST
        # come from the actual r vector: deriving it algebraically from
        # the omega reduction (ss - 2w*ts + w^2*tt) catastrophically
        # cancels near the attainable floor — measured f32 8^3: reported
        # 5.1e-6 vs true 4.2e-5, decaying to an exact phantom 0.0 that
        # falsely satisfied any eps. Recording at iteration START gives
        # cg_run's exact history semantics (one-iteration-stale exit,
        # like standard CG) at zero extra allreduces.
        fused1 = allsum(jnp.stack([
            jnp.sum(rhat.astype(sdt) * r.astype(sdt)),
            jnp.sum(r.astype(sdt) * r.astype(sdt)),
        ]))
        rho_new, rr = fused1[0], fused1[1]
        normr = jnp.sqrt(jnp.maximum(rr, 0))
        hist = hist.at[k].set(normr)
        # Lanczos breakdown: the shadow residual deflated (rho ~ 0
        # while r is not small) — freeze and exit; a production caller
        # restarts with a new rhat, the benchmark reports the iterate
        tiny = jnp.asarray(1e-30, sdt)
        brk_rho = jnp.abs(rho_new) <= tiny * jnp.abs(rho)
        beta = safe_div(rho_new * alpha, rho * omega)
        p = r + beta.astype(vdt) * (p - omega.astype(vdt) * v)
        v = matvec_minv(p)
        rv = dot(rhat, v)
        brk_rv = jnp.abs(rv) <= tiny * jnp.abs(rho_new)
        bad = jnp.logical_or(brk_rho, brk_rv)
        # freeze the iterate on breakdown (cg_run's alpha-freeze): zero
        # step lengths keep x/r at their last good values this iteration
        alpha_new = jnp.where(bad, 0, safe_div(rho_new, rv))
        a_v = alpha_new.astype(vdt)
        s = r - a_v * v
        t = matvec_minv(s)
        fused = allsum(jnp.stack([
            jnp.sum(t.astype(sdt) * s.astype(sdt)),
            jnp.sum(t.astype(sdt) * t.astype(sdt)),
        ]))
        ts, tt = fused[0], fused[1]
        # tt == 0 <=> t == 0 <=> s is already the converged residual:
        # omega = 0 and the half-step update below is exact
        omega_new = jnp.where(bad, 0, safe_div(ts, tt))
        o_v = omega_new.astype(vdt)
        x = x + a_v * apply_minv(p) + o_v * apply_minv(s)
        r = s - o_v * t
        return (k + 1, x, r, p, v, rho_new, alpha_new, omega_new,
                normr, hist, jnp.logical_or(done, bad))

    k, x, *_mid, _normr, hist, _done = jax.lax.while_loop(cond, body, state)
    return x, k, hist


def solve_bicgstab(
    A,
    b: np.ndarray,
    *,
    x0: Optional[np.ndarray] = None,
    itermax: int = 150,
    eps: float = 0.0,
    inv_diag: Optional[np.ndarray] = None,
    precond=None,
    exchange: Callable = _identity,
    allsum: Callable = _identity,
    acc_dtype=None,
    verbose: bool = True,
) -> CGResult:
    """Host driver (mirrors solve_cg): permutation handling, jit,
    timing, residual printing. ``inv_diag`` enables right Jacobi
    preconditioning (true residual reported); ``precond`` (ChebPrecond)
    swaps in the Chebyshev polynomial operator — see resolve_apply_m."""
    b = jnp.asarray(b)
    if b.dtype == jnp.bfloat16:
        b = b.astype(jnp.float32)  # see solve_gmres: bf16 biorthogonal
        # recurrences collapse; matrix storage stays bf16
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, b.dtype)
    if inv_diag is not None:
        inv_diag = jnp.asarray(inv_diag, dtype=b.dtype)

    permuted = getattr(A, "permuted_output", False)
    if permuted:
        b_in = A.permute_vector(b)
        x0_in = A.permute_vector(x0)
        if inv_diag is not None:
            inv_diag = A.permute_vector(inv_diag)
    else:
        b_in, x0_in = b, x0

    from sparsebench.solvers._jitcache import jit_loop

    loop = jit_loop(bicgstab_loop, itermax=itermax, exchange=exchange,
                    allsum=allsum, acc_dtype=acc_dtype, precond=precond)
    eps_arr = jnp.asarray(eps, dtype=acc_dtype or b.dtype)
    x_dev, k_dev, hist_dev = loop(A, b_in, x0_in, eps=eps_arr,
                                  inv_diag=inv_diag)
    int(k_dev)  # warm-up + sync
    t0 = time.perf_counter()
    x_dev, k_dev, hist_dev = loop(A, b_in, x0_in, eps=eps_arr,
                                  inv_diag=inv_diag)
    k = int(k_dev)
    t1 = time.perf_counter()

    if permuted:
        x_dev = A.unpermute_vector(x_dev)
    hist = np.asarray(hist_dev)
    if verbose:
        print_residual_history(hist, k, itermax)
        print(f"Solution performed {k} iterations and took {t1 - t0:.2f}s")

    final = hist[k - 1] if k > 1 else hist[0]
    return CGResult(
        x=np.asarray(x_dev),
        iterations=k,
        residual_history=hist[:k],
        final_normr=float(final),
        solve_seconds=t1 - t0,
    )
