"""Chebyshev semi-iteration solver (the reference's CHEBFD bench type).

The reference lists CHEBFD in its bench-type enum but has no implementation
at all — not even an empty case (src/main.c:22, switch at 192-224). This is
a real implementation: Chebyshev iteration is the communication-optimal
iterative method (no inner products -> no per-iteration allreduce), which on
a device mesh removes 2 of the 3 collectives a CG iteration needs (SURVEY
§3.1) — only the halo exchange remains.

Needs spectral bounds [lmin, lmax]; if absent they are estimated with a
short Lanczos process (device matvecs, tiny tridiagonal eigensolve on host)
with safety margins.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_identity = lambda v: v  # noqa: E731


@dataclasses.dataclass
class ChebyshevResult:
    x: np.ndarray
    iterations: int
    residual_history: np.ndarray
    final_normr: float
    solve_seconds: float
    bounds: Tuple[float, float]


def lanczos_tridiag(A, v0, steps: int, exchange=_identity, allsum=_identity,
                    inv_diag=None):
    """Jittable Lanczos recurrence: the WHOLE ``steps``-step process is one
    ``lax.fori_loop`` (one dispatch — the round-2 version drove one mesh
    dispatch per step from the host).
    Returns (alphas[steps], betas[steps], count): entries past the
    breakdown step (beta < 1e-12) are masked out and ``count`` tells the
    host how many are valid.

    With ``inv_diag`` the recurrence runs on the Jacobi-preconditioned
    operator M^-1 A (M = diag(A)), which is self-adjoint in the M-inner
    product — so the dots are M-weighted and the tridiagonal's
    eigenvalues estimate spec(M^-1 A)."""
    nr = v0.shape[0]
    nc = A.nc
    dtype = v0.dtype
    spmv = A.spmv_permuted if getattr(A, "permuted_output", False) else A.spmv
    precond = inv_diag is not None
    if precond:
        inv_diag = inv_diag.astype(dtype)
        wvec = jnp.where(inv_diag != 0,
                         1.0 / jnp.where(inv_diag != 0, inv_diag, 1), 0)
    else:
        wvec = None

    def widen(v):
        if nc == nr:
            return v
        return jnp.concatenate([v, jnp.zeros(nc - nr, dtype)])

    def matvec(v):
        # astype keeps the recurrence carry dtype-stable when the format's
        # value dtype differs from the working dtype (f64 matrix probed in
        # f32, bf16 storage with f32 accumulation)
        Av = spmv(exchange(widen(v))).astype(dtype)
        return (inv_diag * Av).astype(dtype) if precond else Av

    def wdot(u, v):
        return allsum(jnp.sum(u * (v if wvec is None else wvec * v)))

    v = v0 / jnp.sqrt(wdot(v0, v0))

    def body(i, carry):
        v_prev, v, beta, alphas, betas, count, active = carry
        w = matvec(v)
        alpha = wdot(v, w)
        w = w - alpha * v - beta * v_prev
        beta_new = jnp.sqrt(wdot(w, w))
        alphas = jnp.where(active, alphas.at[i].set(alpha), alphas)
        betas = jnp.where(active, betas.at[i].set(beta_new), betas)
        count = count + active.astype(jnp.int32)
        go_on = jnp.logical_and(active, beta_new >= 1e-12)
        safe = jnp.where(beta_new > 0, beta_new, 1)
        v_prev = jnp.where(go_on, v, v_prev)
        v = jnp.where(go_on, w / safe, v)
        beta = jnp.where(go_on, beta_new, beta)
        return v_prev, v, beta, alphas, betas, count, go_on

    init = (
        jnp.zeros_like(v), v, jnp.zeros((), dtype),
        jnp.zeros(steps, dtype), jnp.zeros(steps, dtype),
        jnp.zeros((), jnp.int32), jnp.asarray(True),
    )
    *_x, alphas, betas, count, _a = jax.lax.fori_loop(0, steps, body, init)
    return alphas, betas, count


def bounds_from_tridiag(
    alphas, betas, count: int, mode: str = "solver"
) -> Tuple[float, float]:
    """Host-side tridiagonal eigensolve + defensive margins.

    Margins are MULTIPLICATIVE on both ends and asymmetric because the
    risks are asymmetric. For an SPD operator, eigenvalues BELOW lmin are
    safe for both uses: the scaled Chebyshev polynomial satisfies
    |p_k(x)| = T_k((theta-x)/delta) / T_k(theta/delta) < 1 for all
    x in (0, lmin) (the argument is in (1, theta/delta) where T_k is
    increasing), so those modes still contract — just slower than the
    bound — and in preconditioner form 1 - q(x) stays in (0, 1) (M stays
    SPD). Eigenvalues ABOVE lmax flip the polynomial's sign for even
    degrees (solver amplifies those modes; preconditioned M goes
    indefinite and CG breaks), so only lmax gets a cushion against
    Lanczos' underestimate of the top Ritz value.

    A previous revision used additive solver margins
    (lmin - 0.1*(lmax - lmin), floored at 1e-8*lmax). For any matrix with
    lmin << lmax — every stencil problem here — the subtraction went
    negative and the floor produced an interval of effective condition
    ~1e8: the iteration contracted by (1 - 2e-4)/iter, i.e. stagnated
    (measured 48^3: residual 1229 -> 922 after 150 iters; with
    multiplicative margins 1229 -> 9.9e-3 in the same 150)."""
    alphas = np.asarray(alphas, dtype=np.float64)[:count]
    betas = np.asarray(betas, dtype=np.float64)[:count]
    T = np.diag(alphas)
    off = betas[: len(alphas) - 1]
    T += np.diag(off, 1) + np.diag(off, -1)
    ev = np.linalg.eigvalsh(T)
    lmin, lmax = float(ev[0]), float(ev[-1])
    if mode == "precond":
        return max(lmin * 0.9, 1e-10 * lmax), lmax * 1.1
    # Solver mode: Lanczos' lowest Ritz value overestimates the true
    # lmin on few steps, so take a bigger haircut below (still safe per
    # the contraction argument above); 1.05x above covers the top end.
    return max(lmin * 0.5, 1e-10 * lmax), lmax * 1.05


def estimate_bounds(
    A, nr: int, dtype, exchange=_identity, allsum=_identity, steps: int = 25,
    seed: int = 0, permute=None, inv_diag=None, mode: str = "solver",
) -> Tuple[float, float]:
    """Lanczos extreme-eigenvalue estimate with safety margins (one fused
    device dispatch + a tiny host eigensolve). For permuted-space
    operators pass ``permute`` (e.g. ``A.permute_vector``): the seed is
    lifted into the operator's working space."""
    rng = np.random.default_rng(seed)
    v0 = jnp.asarray(rng.standard_normal(nr).astype(dtype))
    if permute is not None:
        v0 = permute(v0)
        if inv_diag is not None:
            inv_diag = permute(inv_diag)
    from sparsebench.solvers._jitcache import jit_loop

    fn = jit_loop(lanczos_tridiag, steps=min(steps, nr), exchange=exchange,
                  allsum=allsum)
    alphas, betas, count = fn(A, v0, inv_diag=inv_diag)
    return bounds_from_tridiag(alphas, betas, int(count), mode=mode)


def cheby_loop(A, b, x0, itermax, eps, lmin, lmax, exchange=_identity,
               allsum=_identity, inv_diag=None):
    """Jittable Chebyshev iteration (standard 3-term recurrence). With
    ``inv_diag`` the recurrence runs on the Jacobi-preconditioned
    operator (z = M^-1 r feeds the direction update; ``lmin``/``lmax``
    must then bound spec(M^-1 A) — estimate_bounds(inv_diag=...)). The
    tracked/reported residual stays the TRUE ||b - A x||."""
    nr = b.shape[0]
    nc = A.nc
    vdt = b.dtype
    spmv = A.spmv_permuted if getattr(A, "permuted_output", False) else A.spmv
    precond = inv_diag is not None
    if precond:
        inv_diag = inv_diag.astype(vdt)

    def widen(v):
        if nc == nr:
            return v
        return jnp.concatenate([v, jnp.zeros(nc - nr, vdt)])

    def matvec(v):
        return spmv(exchange(widen(v)))

    def apply_m(r):
        return (inv_diag * r).astype(vdt) if precond else r

    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma1 = theta / delta

    r0 = b - matvec(x0)
    normr0 = jnp.sqrt(allsum(jnp.sum(r0 * r0)))
    hist0 = jnp.full(itermax, jnp.nan, vdt).at[0].set(normr0)

    p0 = apply_m(r0) / theta
    x1 = x0 + p0
    r1 = r0 - matvec(p0)
    rho0 = jnp.asarray(1.0 / sigma1, vdt)

    def cond(state):
        k, _x, _r, _p, _rho, normr, _h = state
        return jnp.logical_and(k < itermax, normr > eps)

    def body(state):
        k, x, r, p, rho, _normr, h = state
        # residual norm tracked for parity/reporting only — note this is the
        # single remaining allreduce; production Chebyshev can drop it.
        normr = jnp.sqrt(allsum(jnp.sum(r * r)))
        h = h.at[k].set(normr)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        p = rho_new * rho * p + (2.0 * rho_new / delta) * apply_m(r)
        x = x + p
        r = r - matvec(p)
        return k + 1, x, r, p, rho_new, normr, h

    state = (jnp.asarray(1), x1, r1, p0, rho0, normr0, hist0)
    k, x, r, p, rho, normr, h = jax.lax.while_loop(cond, body, state)
    return x, k, h


def solve_chebyshev(
    A,
    b: np.ndarray,
    *,
    x0: Optional[np.ndarray] = None,
    itermax: int = 150,
    eps: float = 0.0,
    bounds: Optional[Tuple[float, float]] = None,
    inv_diag: Optional[np.ndarray] = None,
    exchange: Callable = _identity,
    allsum: Callable = _identity,
    verbose: bool = True,
) -> ChebyshevResult:
    """``inv_diag`` (1/diag(A), original row order) enables Jacobi
    preconditioning: the recurrence runs on M^-1 A and the bounds are
    estimated for it (weighted Lanczos) — for the generated stencil
    problem this shrinks [lmin, lmax] spread ~diag-fold."""
    b = jnp.asarray(b)
    if b.dtype == jnp.bfloat16:
        # Lanczos bound estimation and the residual-norm tracking need
        # more than an 8-bit mantissa; run the working vectors in f32
        # (matrix storage stays bf16 — see solve_gmres)
        b = b.astype(jnp.float32)
        if x0 is not None:
            x0 = jnp.asarray(x0).astype(jnp.float32)
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    # original-row-order copy for estimate_bounds (which permutes itself)
    inv_diag_orig = (
        jnp.asarray(inv_diag, dtype=b.dtype) if inv_diag is not None else None
    )

    permuted = getattr(A, "permuted_output", False)
    if permuted:
        b_in, x0_in = A.permute_vector(b), A.permute_vector(x0)
        inv_diag = (A.permute_vector(inv_diag_orig)
                    if inv_diag_orig is not None else None)
    else:
        b_in, x0_in = b, x0
        inv_diag = inv_diag_orig

    if bounds is None:
        bounds = estimate_bounds(
            A, b.shape[0], b.dtype, exchange=exchange, allsum=allsum,
            permute=A.permute_vector if permuted else None,
            inv_diag=inv_diag_orig,
        )
    lmin, lmax = bounds
    if verbose:
        print(f"Chebyshev bounds: lmin = {lmin:.4e} lmax = {lmax:.4e}")

    from sparsebench.solvers._jitcache import jit_loop

    loop = jit_loop(cheby_loop, itermax=itermax, lmin=float(lmin),
                    lmax=float(lmax), exchange=exchange, allsum=allsum)
    eps_arr = jnp.asarray(eps, b.dtype)
    x_dev, k_dev, h_dev = loop(A, b_in, x0_in, eps=eps_arr,
                               inv_diag=inv_diag)
    int(k_dev)
    t0 = time.perf_counter()
    x_dev, k_dev, h_dev = loop(A, b_in, x0_in, eps=eps_arr,
                               inv_diag=inv_diag)
    k = int(k_dev)  # scalar readback = reliable sync (see cg.py)
    t1 = time.perf_counter()

    if permuted:
        x_dev = A.unpermute_vector(x_dev)
    hist = np.asarray(h_dev)[:k]
    if verbose:
        print(f"Chebyshev performed {k} iterations and took {t1 - t0:.2f}s "
              f"(final residual {hist[-1]:E})")
    return ChebyshevResult(
        x=np.asarray(x_dev),
        iterations=k,
        residual_history=hist,
        final_normr=float(hist[-1]),
        solve_seconds=t1 - t0,
        bounds=(lmin, lmax),
    )
