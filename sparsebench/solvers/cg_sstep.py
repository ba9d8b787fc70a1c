"""s-step (communication-avoiding) CG.

The reference's CG pays 2 sequential scalar allreduces + 1 halo exchange
per iteration (src/CGSolver.c:107-129, SURVEY §3.1); the cs variant
(solvers/cg.py cg_cs_loop) fuses the two allreduces into one. This
variant goes further: it restructures CG so a mesh pays **one fused
allreduce per s iterations** (plus one scalar allreduce for the exit
check) — the classical s-step CG of Chronopoulos & Gear (1989,
"s-step iterative methods for symmetric linear systems"), built on a
bounded Chebyshev Krylov basis. Same Krylov iterates as standard CG in
exact arithmetic; same matvec count (s halo exchanges per outer step).

Per outer step (= s CG iterations):

    V = [T_0(S)u, ..., T_s(S)u]                    s matvecs + exchanges
    G = [V, W_prev]^T M [V, W_prev]                ONE psum: (2s+1)^2 gram
    C = W_prev^T M R           (from G)            R = V[:, 0:s]
    B = -D_prev^{-1} C                             s x s on-device algebra
    P = R + P_prev B
    W = A_hat R + W_prev B     (A_hat R = V T — see basis below)
    D = G[0:s, 0:s+1] T + C^T B + B^T C + B^T D_prev B
    a = D^{-1} g,  g = G[0:s, 0]                   (P_prev^T M u == 0)
    x += P a;  u -= W a
    rr = ||r_new||^2                               one scalar psum (exit)

Jacobi preconditioning folds in as the M-inner product: M = diag(A),
A_hat = M^{-1} A is self-adjoint w.r.t. <a,b>_M = a^T M b, and the same
recurrences run on u = M^{-1} r with M-weighted grams — still one fused
reduction per s iterations (the cs variant's Jacobi fold, one level up).

**The basis is Chebyshev, not monomial.** The Krylov block is built with
the shifted-scaled Chebyshev recurrence on S = (2/theta) A_hat - I,
where theta is a (padded) power-method estimate of lambda_max(A_hat):

    v_0 = u;  v_1 = S v_0;  v_{j+1} = 2 S v_j - v_{j-1}

Since spec(A_hat) lies in [0, theta] for SPD A, spec(S) lies in [-1, 1]
and |T_j| <= 1 there — so every basis column is bounded by ~||u||
REGARDLESS of s and of kappa(A). A scaled monomial basis (the naive
choice) diverges in f32 at the reference's own 100^3 workload: the
basis gram's conditioning grows like kappa^O(s), which f32 cannot
carry at real problem conditioning. The bounded Chebyshev basis is the
standard CA-CG fix (Hoemmen 2010; Carson & Demmel 2014). A_hat in the
stored basis is exact linear algebra from the same recurrence:
A_hat v_j = (theta/2)(S v_j + v_j) with S v_j = (v_{j+1} + v_{j-1})/2
(j >= 1) and S v_0 = v_1, giving the (s+1) x s basis-change matrix T
used above — no extra matvecs, no extra reductions.

Communication per s iterations: s halo exchanges (unavoidable — one per
matvec), 1 gram allreduce of (2s+1)^2 scalars, 1 scalar allreduce.
Standard CG: s exchanges + 2s sequential scalar allreduces. On a mesh
where each psum costs fixed latency, the allreduce count drops 2s x.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from sparsebench.solvers.cg import default_acc_dtype

_identity = lambda v: v  # noqa: E731

# every product below runs at full precision: f32 matmuls may otherwise
# run in TF32 on the GPU
_HI = jax.lax.Precision.HIGHEST


def _cheb_basis_change(s: int) -> np.ndarray:
    """C[(s+1), s] with A_hat v_j = theta * sum_i C[i, j] v_i for the
    Chebyshev basis v_j = T_j(S) u, S = (2/theta) A_hat - I (exact
    recurrence algebra, see module docstring)."""
    C = np.zeros((s + 1, s))
    C[0, 0] += 0.5
    C[1, 0] += 0.5
    for j in range(1, s):
        C[j, j] += 0.5
        C[j + 1, j] += 0.25
        C[j - 1, j] += 0.25
    return C


def _gram(U, wvec, sdt):
    """Weighted gram G[i,j] = sum_n U[i,n] * w[n] * U[j,n] in sdt.

    dot_general with HIGHEST precision: on the GPU this keeps f32 products
    out of TF32; on CPU it is a plain accurate matmul. The gram is the one
    fused allreduce payload.
    """
    Us = U.astype(sdt)
    Uw = Us if wvec is None else Us * wvec.astype(sdt)[None, :]
    return jax.lax.dot_general(
        Uw, Us, (((1,), (1,)), ((), ())), precision=_HI
    )


def cg_sstep_loop(
    A,
    b: jnp.ndarray,
    x0: jnp.ndarray,
    itermax: int,
    eps,
    exchange: Callable[[jnp.ndarray], jnp.ndarray] = _identity,
    allsum: Callable = _identity,
    acc_dtype=None,
    inv_diag=None,
    s: int = 4,
    power_iters: int = 6,
    drift_factor: float = 256.0,
):
    """Jittable s-step CG; same contract as solvers.cg.cg_loop
    (returns (x, k, history)). ``s`` is static (basis size). ``inv_diag``
    switches to the M-inner-product (Jacobi) formulation. History is
    recorded at outer-step boundaries (k = 1, 1+s, 1+2s, ...) and at the
    final iterate; other slots stay NaN (printers skip them).

    Drift repair: once the residual reaches the dtype's attainable floor
    the recurrence drifts upward (measured on the chip at 100^3 f32:
    1.2 -> 26 over the 100 post-convergence iterations). When the
    recurrence ||r||^2 rises above ``drift_factor`` x its best-so-far (squared norms:
    the default 256 = 16x in ||r||, far above CG's transient non-
    monotone spikes — an 11x-in-norm early spike was measured on a
    badly-scaled PCG system — and far below the unbounded floor drift),
    the next outer step REPLACES the residual with the true
    M^-1 (b - A x) and restarts the conjugacy block (one extra matvec on
    that step only — zero cost during healthy convergence; Carson-style
    residual replacement, trigger simplified to the drift signature).
    Set drift_factor <= 0 to disable."""
    if s < 1:
        raise ValueError(f"s must be >= 1, got {s}")
    nr = b.shape[0]
    nc = A.nc
    vdt = b.dtype
    sdt = default_acc_dtype(vdt, acc_dtype)
    spmv = A.spmv_permuted if getattr(A, "permuted_output", False) else A.spmv
    precond = inv_diag is not None
    if precond:
        inv_diag_v = inv_diag.astype(vdt)
        # M = diag(A): the gram weight. Guard zeros (a zero diagonal would
        # be a broken Jacobi preconditioner anyway; keep the math finite).
        wvec = jnp.where(inv_diag_v != 0, 1.0 / jnp.where(inv_diag_v != 0,
                                                          inv_diag_v, 1), 0)
    else:
        inv_diag_v = None
        wvec = None

    def widen(v):
        if nc == nr:
            return v
        return jnp.concatenate([v, jnp.zeros(nc - nr, vdt)])

    def matvec(v):
        # A_hat v = M^{-1} A v (A v when unpreconditioned)
        Av = spmv(exchange(widen(v)))
        return (inv_diag_v * Av).astype(vdt) if precond else Av

    def wdot(u, v):
        uu = u.astype(sdt)
        vv = v.astype(sdt)
        if wvec is not None:
            vv = vv * wvec.astype(sdt)
        return allsum(jnp.sum(uu * vv))

    def true_rr(u):
        # ||r||^2 with r = M u: sum((w*u)^2) weighted, sum(u^2) plain
        us = u.astype(sdt)
        if wvec is not None:
            us = us * wvec.astype(sdt)
        return allsum(jnp.sum(us * us))

    # --- init: u0 = M^{-1}(b - A x0) --------------------------------------
    r0 = b - spmv(exchange(widen(x0)))
    u0 = ((inv_diag_v * r0) if precond else r0).astype(vdt)
    rr0 = true_rr(u0)
    normr0 = jnp.sqrt(rr0)

    # Basis scale theta ~ ||A_hat||_M via a few power iterations (setup
    # cost: power_iters matvecs + allsums, outside the solve loop).
    def power_body(_i, carry):
        q, _th = carry
        z = matvec(q)
        th = jnp.sqrt(wdot(z, z))
        q = (z / jnp.where(th > 0, th, 1).astype(vdt)).astype(vdt)
        return q, th

    q0 = u0 / jnp.where(normr0 > 0, normr0, 1).astype(vdt)
    _q, theta = jax.lax.fori_loop(
        0, power_iters, power_body, (q0, jnp.ones((), sdt))
    )
    theta = jnp.where(jnp.logical_and(theta > 0, jnp.isfinite(theta)),
                      theta, 1)
    # pad: the Chebyshev basis is bounded as long as spec(A_hat) stays
    # inside [0, theta]; a power-method UNDERestimate would let |T_j|
    # grow at the top of the spectrum
    theta = 1.05 * theta
    two_over_theta = (2.0 / theta).astype(vdt)
    Tmat = theta * jnp.asarray(_cheb_basis_change(s), sdt)  # (s+1, s)
    Tmat_v = Tmat.astype(vdt)

    hist0 = jnp.full(itermax, jnp.nan, dtype=sdt).at[0].set(normr0)
    eye = jnp.eye(s, dtype=sdt)
    state = (
        jnp.asarray(1),                 # k
        x0,                             # x
        x0,                             # x_best (iterate at rr_best)
        u0,                             # u = M^{-1} r
        jnp.zeros((s, nr), vdt),        # P_prev (row-stacked directions)
        jnp.zeros((s, nr), vdt),        # W_prev = A_hat P_prev
        eye,                            # D_prev (identity: B = 0 first step)
        rr0,                            # ||r||^2 entering this outer step
        rr0,                            # best ||r||^2 seen (drift baseline)
        jnp.asarray(False),             # replace residual this step?
        normr0,                         # exit-check residual norm
        hist0,
        jnp.asarray(False),             # done (breakdown)
    )

    def cond(st):
        (k, _x, _xb, _u, _P, _W, _D, _rr, _rb, _rep, normr, _h, done) = st
        return jnp.logical_and(
            jnp.logical_and(k < itermax, normr > eps), jnp.logical_not(done)
        )

    def body(st):
        (k, x, x_best, u, Pprev, Wprev, Dprev, rr, rr_best, need_rep,
         _normr, hist, done) = st
        hist = hist.at[k].set(jnp.sqrt(rr))

        if drift_factor and drift_factor > 0:
            # drift-triggered residual replacement + conjugacy restart
            def do_replace(args):
                x_, _u, _P, _W, _D = args
                r_true = b - spmv(exchange(widen(x_)))
                u2 = ((inv_diag_v * r_true) if precond
                      else r_true).astype(vdt)
                return (u2, jnp.zeros((s, nr), vdt),
                        jnp.zeros((s, nr), vdt), eye)

            def keep(args):
                _x, u_, P_, W_, D_ = args
                return u_, P_, W_, D_

            u, Pprev, Wprev, Dprev = jax.lax.cond(
                need_rep, do_replace, keep, (x, u, Pprev, Wprev, Dprev)
            )

        # Chebyshev basis: v_0 = u, v_1 = S v_0, v_{j+1} = 2 S v_j - v_{j-1}
        # with S = (2/theta) A_hat - I  (columns bounded by ~||u||)
        def s_apply(v):
            return (matvec(v) * two_over_theta).astype(vdt) - v

        vs = [u, s_apply(u)]
        for _ in range(2, s + 1):
            vs.append(2.0 * s_apply(vs[-1]) - vs[-2])
        V = jnp.stack(vs)                       # (s+1, nr)

        U = jnp.concatenate([V, Wprev], axis=0)  # (2s+1, nr)
        G = allsum(_gram(U, wvec, sdt))          # ONE fused allreduce

        C = G[s + 1:, 0:s]                       # W_prev^T M R
        B = -jnp.linalg.solve(Dprev, C)          # s x s
        Bv = B.astype(vdt)
        R = V[0:s]
        P = R + jnp.matmul(Bv.T, Pprev, precision=_HI)
        # A_hat R = V Tmat (exact basis-change algebra, no extra matvec)
        AhatR = jnp.einsum("is,in->sn", Tmat_v, V,
                           precision=_HI)
        W = AhatR + jnp.matmul(Bv.T, Wprev, precision=_HI)

        Gh = jnp.einsum("ij,jk->ik", G[0:s, 0:s + 1], Tmat,
                        precision=_HI)  # R^T M A_hat R
        D = (Gh + jnp.matmul(C.T, B, precision=_HI)
             + jnp.matmul(B.T, C, precision=_HI)
             + jnp.matmul(jnp.matmul(B.T, Dprev, precision=_HI), B,
                          precision=_HI))
        D = 0.5 * (D + D.T)                      # symmetrize float residue
        g = G[0:s, 0]                            # P^T M r  (P_prev^T r = 0)
        a = jnp.linalg.solve(D, g)

        # breakdown guard (cg_run's alpha freeze, one level up): at
        # machine-zero residual D collapses and the solve returns
        # inf/nan — freeze the converged state and exit.
        bad = jnp.logical_not(jnp.all(jnp.isfinite(a)))
        a = jnp.where(bad, 0, a)
        av = a.astype(vdt)

        x = x + jnp.matmul(av, P, precision=_HI)
        u = u - jnp.matmul(av, W, precision=_HI)
        rr_new = true_rr(u)                      # one scalar allreduce
        bad = jnp.logical_or(bad, jnp.logical_not(jnp.isfinite(rr_new)))
        normr_new = jnp.sqrt(jnp.maximum(rr_new, 0))
        if drift_factor and drift_factor > 0:
            # trigger a replacement NEXT step when the recurrence residual
            # rose well above its best (drift signature); never two in a
            # row (if the true floor sits above the trigger level, back-
            # to-back replacements would buy nothing and cost a matvec
            # per block)
            drift = rr_new > drift_factor * rr_best
            need_rep_new = jnp.logical_and(drift, jnp.logical_not(need_rep))
        else:
            need_rep_new = need_rep
        # best-iterate snapshot: past the attainable floor the
        # drift/replacement cycle makes the residual non-monotone; the
        # best-ever iterate is what the solver should hand back (one
        # vector select per OUTER step — negligible next to s matvecs)
        better = rr_new < rr_best
        x_best = jnp.where(better, x, x_best)
        rr_best = jnp.minimum(rr_best, rr_new)

        return (k + s, x, x_best, u, P, W, D, rr_new, rr_best,
                need_rep_new, normr_new, hist, jnp.logical_or(done, bad))

    (k, x, x_best, _u, _P, _W, _D, rr, rr_best, _rep, normr, hist,
     _done) = jax.lax.while_loop(cond, body, state)
    k = jnp.minimum(k, itermax)
    # Return the best-residual iterate when the final one is worse
    # (floor cycling); pair the reported final residual with it.
    pick_best = rr > rr_best
    x = jnp.where(pick_best, x_best, x)
    normr = jnp.where(pick_best, jnp.sqrt(rr_best), normr)
    # The body records the residual entering each outer step (hist[k] at
    # k = 1, 1+s, ...); the exit-triggering post-block residual lands in
    # slot k-1 here so the driver's final_normr is the fresh value for
    # every s (for s == 1 this overwrites the last entry slot with the
    # value one update fresher — the one the exit check actually used).
    hist = hist.at[k - 1].set(normr)
    return x, k, hist
