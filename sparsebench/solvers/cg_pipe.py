"""Pipelined CG (Ghysels & Vanroose 2014).

The third latency strategy in the CG family, alongside ``cs`` (fuse the
two allreduces into one) and ``sstep`` (amortize one allreduce over s
iterations): pipelined CG OVERLAPS its single fused allreduce with the
iteration's one matvec. The dots (gamma, delta) depend only on (u, w)
from the previous update, and the matvec q = A_hat w does not depend on
the dots — inside the one jitted program XLA is free to schedule the
psum concurrently with the SpMV, so on a mesh the reduction latency
hides behind local compute (the reference's blocking MPI_Allreduce
structure cannot do this, src/solver.c:41-62).

Formulated entirely in the preconditioned space (A_hat = M^-1 A,
u = M^-1 r, self-adjoint in <a,b>_M = a^T M b; M = I unpreconditioned),
which needs two fewer carried vectors than the textbook r-space form:

    u = M^-1 (b - A x);  w = A_hat u
    loop:
        gamma = <u, u>_M,  delta = <w, u>_M   } ONE fused allreduce
        q = A_hat w                           } overlapped matvec
        beta  = gamma / gamma_old        (0 on the first iteration)
        alpha = gamma / (delta - beta * gamma / alpha_old)
        z = q + beta z          # z tracks A_hat (w-direction)
        c = w + beta c          # c tracks A_hat p
        p = u + beta p
        x += alpha p;  u -= alpha c;  w -= alpha z

Per iteration: 1 matvec + 1 fused allreduce (2 scalars; +1 for the true
||r|| under Jacobi), independent of each other. Extra cost vs standard
CG: carries c, z, w in addition to p — more BLAS1 traffic, the
documented price of overlap; same matvec count. Identical Krylov
iterates in exact arithmetic (gamma/delta recurrences are the
Chronopoulos-Gear scalars, cf. cg_cs_loop). In floats the recurrently
maintained u and w drift earlier than standard CG's residual, so the
same drift-triggered replacement as cg_sstep.py repairs them
(recompute u, w from x when <u,u>_M rises drift_factor x above its
best-so-far; two matvecs on that iteration only).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from sparsebench.solvers.cg import default_acc_dtype, safe_div
from sparsebench.solvers.precond import resolve_apply_m

_identity = lambda v: v  # noqa: E731


def cg_pipe_loop(
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
    drift_factor: float = 256.0,
):
    """Jittable pipelined CG; same contract as cg_loop (returns
    (x, k, history)). ``inv_diag`` enables Jacobi preconditioning (the
    M-inner products are elementwise-weighted sums). ``precond``
    (solvers/precond.py ChebPrecond) switches to the general-operator
    r-space form (_pipe_prec_loop): a polynomial M^-1 has no cheap M
    apply, so the M-inner-product trick below does not reach it."""
    if precond is not None:
        return _pipe_prec_loop(
            A, b, x0, itermax, eps, exchange=exchange, allsum=allsum,
            acc_dtype=acc_dtype, inv_diag=inv_diag, precond=precond,
            drift_factor=drift_factor,
        )
    nr = b.shape[0]
    nc = A.nc
    vdt = b.dtype
    sdt = default_acc_dtype(vdt, acc_dtype)
    spmv = A.spmv_permuted if getattr(A, "permuted_output", False) else A.spmv
    precond = inv_diag is not None
    if precond:
        inv_diag = inv_diag.astype(vdt)
        wvec = jnp.where(inv_diag != 0,
                         1.0 / jnp.where(inv_diag != 0, inv_diag, 1), 0)
    else:
        wvec = None

    def widen(v):
        if nc == nr:
            return v
        return jnp.concatenate([v, jnp.zeros(nc - nr, vdt)])

    def matvec(v):
        Av = spmv(exchange(widen(v)))
        return ((inv_diag * Av) if precond else Av).astype(vdt)

    def fused_dots(u, w):
        # [gamma = <u,u>_M, delta = <w,u>_M] (+ ||M u||^2 = true ||r||^2
        # under preconditioning; == gamma when M = I) — one allsum
        us = u.astype(sdt)
        ws = w.astype(sdt)
        if wvec is not None:
            uw = us * wvec.astype(sdt)
            parts = [jnp.sum(us * uw), jnp.sum(ws * uw), jnp.sum(uw * uw)]
        else:
            parts = [jnp.sum(us * us), jnp.sum(ws * us)]
        return allsum(jnp.stack(parts))

    def fresh_uw(x):
        r = (b - spmv(exchange(widen(x)))).astype(vdt)
        u = (inv_diag * r).astype(vdt) if precond else r
        return u, matvec(u)

    u0, w0 = fresh_uw(x0)
    gd0 = fused_dots(u0, w0)
    gamma0 = gd0[0]
    rr0 = gd0[2] if precond else gamma0
    normr0 = jnp.sqrt(jnp.maximum(rr0, 0))
    hist0 = jnp.full(itermax, jnp.nan, dtype=sdt).at[0].set(normr0)

    zeros = jnp.zeros(nr, vdt)
    # state: (k, x, u, w, p, c, z, gamma, alpha, rr_best, need_rep,
    #         normr, hist, done)
    state = (jnp.asarray(1), x0, u0, w0, zeros, zeros, zeros,
             gamma0, jnp.zeros((), sdt), rr0, jnp.asarray(False),
             normr0, hist0, jnp.asarray(False))

    def cond(st):
        k, *_mid, normr, _hist, done = st
        return jnp.logical_and(
            jnp.logical_and(k < itermax, normr > eps), jnp.logical_not(done)
        )

    def body(st):
        (k, x, u, w, p, c, z, gamma, alpha, rr_best, need_rep, _normr,
         hist, done) = st

        repair = bool(drift_factor and drift_factor > 0)
        if repair:
            # replacement restart (see cg_sstep.py): recompute u, w from
            # x (two matvecs on that iteration only) and zero the
            # direction family — the iteration below then takes a fresh
            # steepest-descent step (beta = 0 via `fresh`)
            def do_replace(args):
                x_, _u, _w, _p, _c, _z = args
                u2, w2 = fresh_uw(x_)
                return u2, w2, zeros, zeros, zeros

            def keep(args):
                _x, u_, w_, p_, c_, z_ = args
                return u_, w_, p_, c_, z_

            u, w, p, c, z = jax.lax.cond(
                need_rep, do_replace, keep, (x, u, w, p, c, z)
            )

        gd = fused_dots(u, w)        # the ONE allreduce ...
        q = matvec(w)                # ... independent of it: overlaps
        g_new, delta = gd[0], gd[1]
        rr_new = gd[2] if precond else g_new
        normr = jnp.sqrt(jnp.maximum(rr_new, 0))
        hist = hist.at[k].set(normr)

        fresh = jnp.logical_or(k == 1, need_rep)
        beta = jnp.where(fresh, 0, safe_div(g_new, gamma))
        denom = jnp.where(fresh, delta,
                          delta - beta * safe_div(g_new, alpha))
        # positivity loss: denom is p.Ap in disguise (cg_cs_loop). The
        # pipelined recurrence loses it EARLIER than standard CG in low
        # precision (measured on the chip at 100^3 f32: iteration ~45);
        # with repair on it triggers a replacement restart instead of
        # exiting, and only a breakdown right after a fresh restart ends
        # the solve (the true floor, nothing left to repair).
        breakdown = denom <= g_new * 1e-30
        alpha_new = jnp.where(breakdown, 0, safe_div(g_new, denom))

        b_v = beta.astype(vdt)
        a_v = alpha_new.astype(vdt)
        z = q + b_v * z
        c = w + b_v * c
        p = u + b_v * p
        x = x + a_v * p
        u = u - a_v * c
        w = w - a_v * z

        if repair:
            trigger = jnp.logical_or(breakdown,
                                     rr_new > drift_factor * rr_best)
            need_rep_new = jnp.logical_and(trigger,
                                           jnp.logical_not(need_rep))
            done_new = jnp.logical_or(done,
                                      jnp.logical_and(breakdown, need_rep))
        else:
            need_rep_new = need_rep
            done_new = jnp.logical_or(done, breakdown)
        rr_best = jnp.minimum(rr_best, rr_new)

        return (k + 1, x, u, w, p, c, z, g_new, alpha_new, rr_best,
                need_rep_new, normr, hist, done_new)

    k, x, *_mid, _normr, hist, _done = jax.lax.while_loop(cond, body, state)
    return x, k, hist


def _pipe_prec_loop(
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
    drift_factor: float = 256.0,
):
    """General-operator preconditioned pipelined CG (Ghysels & Vanroose
    2014, Alg. 4 — the paper's preconditioned form).

    The M^-1-applied formulation in ``cg_pipe_loop`` needs M-inner
    products <a,b>_M = a^T M b, which only exist cheaply when M itself
    is cheap (Jacobi: elementwise). For an operator preconditioner like
    the Chebyshev polynomial (M^-1 = p_k(A), M = p_k(A)^-1 has no
    apply), the textbook r-space form carries the residual explicitly —
    two more vectors (r and the direction s tracking A p's r-update),
    the documented price:

        r = b - A x;  u = M^-1 r;  w = A u
        loop:
            gamma = <r, u>, delta = <w, u>, rr = <r, r> } ONE allreduce
            m = M^-1 w;  n = A m                        } overlapped
            beta  = gamma / gamma_old     (0 on a fresh start)
            alpha = gamma / (delta - beta * gamma / alpha_old)
            z = n + beta z;  q = m + beta q   # z, q track A_hat-family
            s = w + beta s;  p = u + beta p
            x += alpha p;  r -= alpha s;  u -= alpha q;  w -= alpha z

    The allreduce overlaps BOTH the preconditioner apply (degree halo
    exchanges for ChebPrecond, zero psums) and the matvec — more local
    work to hide the reduction latency behind than the unpreconditioned
    form has. Same drift-triggered replacement as the M^-1-space loop
    (all four recurrently-maintained vectors refresh from x).
    """
    nr = b.shape[0]
    nc = A.nc
    vdt = b.dtype
    sdt = default_acc_dtype(vdt, acc_dtype)
    spmv = A.spmv_permuted if getattr(A, "permuted_output", False) else A.spmv

    def widen(v):
        if nc == nr:
            return v
        return jnp.concatenate([v, jnp.zeros(nc - nr, vdt)])

    def matvec(v):
        return spmv(exchange(widen(v))).astype(vdt)

    apply_m = resolve_apply_m(precond, inv_diag, matvec, vdt)

    def fused_dots(r, u, w):
        # [gamma = <r,u>, delta = <w,u>, rr = <r,r>] — one allsum
        rs = r.astype(sdt)
        us = u.astype(sdt)
        return allsum(jnp.stack([
            jnp.sum(rs * us), jnp.sum(w.astype(sdt) * us), jnp.sum(rs * rs),
        ]))

    def fresh_ruw(x):
        r = (b - matvec(x)).astype(vdt)
        u = apply_m(r)
        return r, u, matvec(u)

    r0, u0, w0 = fresh_ruw(x0)
    gd0 = fused_dots(r0, u0, w0)
    gamma0, rr0 = gd0[0], gd0[2]
    normr0 = jnp.sqrt(jnp.maximum(rr0, 0))
    hist0 = jnp.full(itermax, jnp.nan, dtype=sdt).at[0].set(normr0)

    zeros = jnp.zeros(nr, vdt)
    # state: (k, x, r, u, w, p, s, q, z, gamma, alpha, rr_best, need_rep,
    #         normr, hist, done)
    state = (jnp.asarray(1), x0, r0, u0, w0, zeros, zeros, zeros, zeros,
             gamma0, jnp.zeros((), sdt), rr0, jnp.asarray(False),
             normr0, hist0, jnp.asarray(False))

    def cond(st):
        k, *_mid, normr, _hist, done = st
        return jnp.logical_and(
            jnp.logical_and(k < itermax, normr > eps), jnp.logical_not(done)
        )

    def body(st):
        (k, x, r, u, w, p, s, q, z, gamma, alpha, rr_best, need_rep,
         _normr, hist, done) = st

        repair = bool(drift_factor and drift_factor > 0)
        if repair:

            def do_replace(args):
                x_, _r, _u, _w, _p, _s, _q, _z = args
                r2, u2, w2 = fresh_ruw(x_)
                return r2, u2, w2, zeros, zeros, zeros, zeros

            def keep(args):
                _x, r_, u_, w_, p_, s_, q_, z_ = args
                return r_, u_, w_, p_, s_, q_, z_

            r, u, w, p, s, q, z = jax.lax.cond(
                need_rep, do_replace, keep, (x, r, u, w, p, s, q, z)
            )

        gd = fused_dots(r, u, w)     # the ONE allreduce ...
        m = apply_m(w)               # ... independent of it: the
        n = matvec(m)                # precond apply + matvec overlap
        g_new, delta, rr_new = gd[0], gd[1], gd[2]
        normr = jnp.sqrt(jnp.maximum(rr_new, 0))
        hist = hist.at[k].set(normr)

        fresh = jnp.logical_or(k == 1, need_rep)
        beta = jnp.where(fresh, 0, safe_div(g_new, gamma))
        denom = jnp.where(fresh, delta,
                          delta - beta * safe_div(g_new, alpha))
        breakdown = denom <= g_new * 1e-30
        alpha_new = jnp.where(breakdown, 0, safe_div(g_new, denom))

        b_v = beta.astype(vdt)
        a_v = alpha_new.astype(vdt)
        z = n + b_v * z
        q = m + b_v * q
        s = w + b_v * s
        p = u + b_v * p
        x = x + a_v * p
        r = r - a_v * s
        u = u - a_v * q
        w = w - a_v * z

        if repair:
            trigger = jnp.logical_or(breakdown,
                                     rr_new > drift_factor * rr_best)
            need_rep_new = jnp.logical_and(trigger,
                                           jnp.logical_not(need_rep))
            done_new = jnp.logical_or(done,
                                      jnp.logical_and(breakdown, need_rep))
        else:
            need_rep_new = need_rep
            done_new = jnp.logical_or(done, breakdown)
        rr_best = jnp.minimum(rr_best, rr_new)

        return (k + 1, x, r, u, w, p, s, q, z, g_new, alpha_new, rr_best,
                need_rep_new, normr, hist, done_new)

    k, x, *_mid, _normr, hist, _done = jax.lax.while_loop(cond, body, state)
    return x, k, hist
