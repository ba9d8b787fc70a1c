"""MINRES solver (Paige & Saunders 1975) — beyond the reference.

The reference bench enum {CG, SPMV, GMRES, CHEBFD} (src/main.c:22) has no
method for SYMMETRIC INDEFINITE systems: CG's p.Ap steps break down off
the SPD cone, and GMRES(m) pays O(m.n) basis memory for symmetry it never
exploits. MINRES is the canonical gap-filler — the three-term Lanczos
recurrence (constant memory, like CG) with a QR-minimised residual that
is well-defined for any symmetric A. This completes the Krylov family:
CG (SPD), MINRES (symmetric indefinite), GMRES/BiCGStab (general).

Design matches the CG family (solvers/cg.py): ONE fused
``lax.while_loop`` under a single jit, injected ``exchange``/``allsum``
hooks shared by the serial and distributed drivers, dots as
elementwise-multiply + tree-sum, bf16 values accumulate in f32.

Per iteration: 1 matvec + 2 scalar allreduces (alfa = v.Av', then
beta = sqrt(r.M^-1 r) — sequentially dependent through the Lanczos
orthogonalisation, exactly standard CG's collective count). The Givens
QR update is all scalar recurrence work that XLA folds into the loop
carry for free.

Preconditioning: ``inv_diag`` applies Jacobi M^-1 = D^-1, which MINRES
requires to be SPD — the host drivers validate diag > 0 and refuse
otherwise (an indefinite diagonal makes sqrt(r.M^-1 r) meaningless).
Polynomial (Chebyshev) preconditioning is deliberately NOT offered:
p_k(A) for indefinite A is not SPD, so the preconditioned Lanczos
inner product is undefined (use GMRES for that regime).

Residual semantics: the recurrence norm phibar == ||r_k|| in the
M^-1/2 norm (the 2-norm when unpreconditioned), recorded AFTER each
update with hist[0] = ||r_0|| — the same one-iteration-stale exit
contract as cg_run. Like every short-recurrence method it can decay
below the true-residual floor in low precision; x accuracy is the
oracle there (tests/test_minres.py).
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

_identity = lambda v: v  # noqa: E731


def minres_loop(
    A,
    b: jnp.ndarray,
    x0: jnp.ndarray,
    itermax: int,
    eps,
    exchange: Callable[[jnp.ndarray], jnp.ndarray] = _identity,
    allsum: Callable = _identity,
    acc_dtype=None,
    inv_diag=None,
):
    """Jittable MINRES; same contract as cg_loop (returns (x, k, hist)).

    The Lanczos vectors are carried unnormalised as (r1, r2) with the
    norms in scalar state (Paige-Saunders' memory-minimal form: 6
    vectors total — x, r1, r2, y, w, w2). Breakdown beta == 0 means the
    Krylov space is exhausted (exact solution reached) — freeze and
    exit, matching cg_run's guard semantics.
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

    def apply_a(v):
        return spmv(exchange(widen(v))).astype(vdt)

    def apply_minv(v):
        return (inv_diag * v).astype(vdt) if inv_diag is not None else v

    def dot(u, v):
        return allsum(jnp.sum(u.astype(sdt) * v.astype(sdt)))

    r0 = (b - spmv(exchange(widen(x0)))).astype(vdt)
    y0 = apply_minv(r0)
    beta1 = jnp.sqrt(jnp.maximum(dot(r0, y0), 0))
    hist0 = jnp.full(itermax, jnp.nan, dtype=sdt).at[0].set(beta1)

    zeros = jnp.zeros(nr, vdt)
    szero = jnp.zeros((), sdt)
    sone = jnp.ones((), sdt)
    # state: (k, x, r1, r2, y, w, w2,
    #         beta, oldb, dbar, epsln, phibar, cs, sn, normr, hist, done)
    state = (
        jnp.asarray(1), x0, r0, r0, y0, zeros, zeros,
        beta1, sone, szero, szero, beta1, -sone, szero, beta1, hist0,
        beta1 == 0,
    )

    def cond(st):
        k = st[0]
        normr = st[14]
        done = st[16]
        return jnp.logical_and(
            jnp.logical_and(k <= itermax - 1, normr > eps),
            jnp.logical_not(done),
        )

    def body(st):
        (k, x, r1, r2, y, w, w2,
         beta, oldb, dbar, epsln, phibar, cs, sn, _normr, hist, done) = st

        # ---- Lanczos step on the preconditioned operator M^-1 A
        v = safe_div(sone, beta).astype(vdt) * y
        ynew = apply_a(v)
        # the three-term recurrence: subtract the previous two directions.
        # k == 1 has no k-1 term (oldb init = 1 keeps the division safe;
        # the where() zeroes the coefficient).
        c_prev = jnp.where(k > 1, safe_div(beta, oldb), szero)
        ynew = ynew - c_prev.astype(vdt) * r1
        alfa = dot(v, ynew)                       # allreduce 1
        ynew = ynew - safe_div(alfa, beta).astype(vdt) * r2
        r1n, r2n = r2, ynew
        yn = apply_minv(r2n)
        oldb_n = beta
        beta2 = dot(r2n, yn)                      # allreduce 2
        # beta2 < 0 <=> M indefinite (host drivers prevent this); clamp
        # keeps the jit total, the done flag below exits on exhaustion
        beta_n = jnp.sqrt(jnp.maximum(beta2, 0))

        # ---- Givens QR of the tridiagonal, one rotation per iteration
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln_n = sn * beta_n
        dbar_n = -cs * beta_n
        gamma = jnp.sqrt(gbar * gbar + beta_n * beta_n)
        tiny = jnp.asarray(np.finfo(np.dtype(sdt)).tiny, sdt)
        gamma = jnp.maximum(gamma, tiny)
        cs_n = gbar / gamma
        sn_n = beta_n / gamma
        phi = cs_n * phibar
        phibar_n = sn_n * phibar

        # ---- solution update along the newest conjugate direction
        wn = (v - oldeps.astype(vdt) * w2 - delta.astype(vdt) * w) / \
            gamma.astype(vdt)
        xn = x + phi.astype(vdt) * wn
        normr = jnp.abs(phibar_n)
        hist_n = hist.at[k].set(normr)
        # Krylov exhaustion: beta == 0 -> the residual has no new
        # component; the update above is the exact final step
        return (k + 1, xn, r1n, r2n, yn, wn, w,
                beta_n, oldb_n, dbar_n, epsln_n, phibar_n, cs_n, sn_n,
                normr, hist_n, jnp.logical_or(done, beta_n == 0))

    out = jax.lax.while_loop(cond, body, state)
    k, x, hist = out[0], out[1], out[15]
    return x, k, hist


def solve_minres(
    A,
    b: np.ndarray,
    *,
    x0: Optional[np.ndarray] = None,
    itermax: int = 150,
    eps: float = 0.0,
    inv_diag: Optional[np.ndarray] = None,
    exchange: Callable = _identity,
    allsum: Callable = _identity,
    acc_dtype=None,
    verbose: bool = True,
) -> CGResult:
    """Host driver (mirrors solve_bicgstab): permutation handling, jit,
    timing, residual printing. ``inv_diag`` = Jacobi preconditioning;
    MINRES requires M SPD, so every entry must be positive."""
    b = jnp.asarray(b)
    if b.dtype == jnp.bfloat16:
        b = b.astype(jnp.float32)  # see solve_gmres: bf16 three-term
        # recurrences collapse; matrix storage stays bf16
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, b.dtype)
    if inv_diag is not None:
        inv_np = np.asarray(inv_diag, dtype=np.float64)
        if not np.all(inv_np > 0):
            raise ValueError(
                "MINRES Jacobi preconditioning requires a positive "
                "diagonal (M must be SPD); this matrix has "
                f"min(diag^-1) = {inv_np.min():g}"
            )
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

    loop = jit_loop(minres_loop, itermax=itermax, exchange=exchange,
                    allsum=allsum, acc_dtype=acc_dtype)
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
