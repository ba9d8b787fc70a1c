"""Conjugate-Gradient solver (reference src/CGSolver.c).

Unpreconditioned HPCG-style CG with the reference's exact iteration
structure (src/CGSolver.c:94-129):

    init:  p = x0; exchange(p); Ap = A p; r = b - Ap; rtrans = r.r
    k = 1 .. itermax-1 while normr > eps:
        k == 1:  p = r
        else:    rtrans, old = r.r, rtrans; beta = rtrans/old; p = r + beta p
        normr = sqrt(rtrans)
        exchange(p); Ap = A p
        alpha = rtrans / (p . Ap)
        x += alpha p;  r -= alpha Ap

Differences from the reference:
  * the whole loop is one ``lax.while_loop`` inside a single jit — no
    host round-trips per iteration; the residual history is recorded into
    a preallocated on-device array and printed after the solve (the
    reference prints from inside the loop, src/CGSolver.c:118-120 —
    same text, different time);
  * communication is injected: ``exchange`` fills the halo tail of p and
    ``allsum`` reduces dot products (identity on a single device; ppermute /
    psum inside shard_map for the distributed solve) — per iteration that
    is exactly the reference's 2 allreduces + 1 halo exchange (SURVEY §3.1);
  * row-permuting formats (SELL-C-sigma) are handled by permuting b/x0 once
    and un-permuting x at the end, so the hot loop runs natively in the
    format's row order. The reference never applies its SCS permutation in
    CG — a latent bug (SURVEY.md §7) fixed here structurally.
"""

from __future__ import annotations

import dataclasses
import time
from functools import lru_cache, partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sparsebench.solvers._jitcache import jit_loop
from sparsebench.solvers.precond import resolve_apply_m

_identity = lambda v: v  # noqa: E731


def safe_div(num, den):
    """num/den with 0 when den == 0 (exact-convergence guard, see cg_loop)."""
    return jnp.where(den != 0, num / jnp.where(den != 0, den, 1), 0)


def default_acc_dtype(vdt, acc_dtype):
    """Accumulation dtype for solver scalars (dots, residual history).

    bf16 VALUES accumulate in f32 by default: an 8-bit-mantissa dot
    product cannot drive a CG recurrence (and a bf16 residual history
    even breaks float formatting). Vectors stay in ``vdt`` — bf16
    storage halves BLAS1/matrix bytes, which is the point of --dtype
    bf16 — only the reductions and recurrence scalars widen."""
    if acc_dtype is not None:
        return acc_dtype
    if jnp.dtype(vdt) == jnp.bfloat16:
        return jnp.float32
    return vdt


def print_residual_history(hist: np.ndarray, k: int, itermax: int) -> None:
    """The reference's residual print block (printFreq semantics,
    src/CGSolver.c:85-91,118-120), shared by every batch-history solver
    driver. Skips the NaN slots the sstep variant leaves between
    outer-step boundaries."""
    print(f"Initial Residual = {hist[0]:E}")
    print_freq = min(max(itermax // 10, 1), 50)
    for j in range(1, k):
        if (j % print_freq == 0 or j + 1 == itermax) and not np.isnan(
            hist[j]
        ):
            print(f"Iteration = {j} Residual = {hist[j]:E}")


@dataclasses.dataclass
class CGResult:
    x: np.ndarray                    # solution, original row order
    iterations: int                  # reference's returned k (CGSolver.c:138)
    residual_history: np.ndarray     # normr per iteration; [0] = initial
    final_normr: float
    solve_seconds: float


def _make_helpers(A, nr, nc, vdt, sdt, exchange, allsum):
    spmv = A.spmv_permuted if getattr(A, "permuted_output", False) else A.spmv

    def dot(u, v):
        # elementwise multiply + tree-sum, NOT jnp.dot: XLA's dot lowering
        # (CPU gemv, GPU TF32 for f32) can lose precision (~1e-3 relative
        # observed on the CPU backend for f64) which flips r.r negative at
        # machine-zero residuals; sum() lowers to an accurate tree
        # reduction everywhere.
        return allsum(jnp.sum(u.astype(sdt) * v.astype(sdt)))

    def widen(v):
        # length-nc working vector with halo tail (reference allocates p at
        # ncol, src/CGSolver.c:70)
        if nc == nr:
            return v
        return jnp.concatenate([v, jnp.zeros(nc - nr, vdt)])

    return spmv, dot, widen


def cg_init(
    A,
    b: jnp.ndarray,
    x0: jnp.ndarray,
    itermax: int,
    exchange: Callable = _identity,
    allsum: Callable = _identity,
    acc_dtype=None,
    inv_diag=None,
    precond=None,
):
    """Initial CG state (reference src/CGSolver.c:94-104). The state tuple
    (k, x, p, r, rtrans, normr, hist, done) is a checkpointable pytree.

    With ``inv_diag`` (Jacobi preconditioning — beyond the reference, which
    is unpreconditioned) the ``rtrans`` slot carries r.z (z = M^-1 r) while
    ``normr``/history keep the true residual norm ||r||. ``precond``
    (solvers/precond.py ChebPrecond) switches M to the Chebyshev
    polynomial operator (scaled by ``inv_diag`` when both are given)."""
    nr = b.shape[0]
    vdt = b.dtype
    sdt = default_acc_dtype(vdt, acc_dtype)
    spmv, dot, widen = _make_helpers(A, nr, A.nc, vdt, sdt, exchange, allsum)
    apply_m = resolve_apply_m(
        precond, inv_diag, lambda v: spmv(exchange(widen(v))), vdt
    )

    p = exchange(widen(x0))
    Ap = spmv(p)
    r = b - Ap
    if apply_m is None:
        rtrans0 = dot(r, r)
        normr0 = jnp.sqrt(rtrans0)
    else:
        z = apply_m(r)
        s = allsum(jnp.stack([
            jnp.sum(r.astype(sdt) * z.astype(sdt)),
            jnp.sum(r.astype(sdt) * r.astype(sdt)),
        ]))
        rtrans0, normr0 = s[0], jnp.sqrt(s[1])
    history0 = jnp.full(itermax, jnp.nan, dtype=sdt).at[0].set(normr0)
    return (jnp.asarray(1), x0, p, r, rtrans0, normr0, history0,
            jnp.asarray(False))


def cg_run(
    A,
    state,
    k_end: int,
    eps,
    exchange: Callable = _identity,
    allsum: Callable = _identity,
    acc_dtype=None,
    inv_diag=None,
    precond=None,
):
    """Advance CG from ``state`` until k == k_end, convergence, or
    breakdown (reference hot loop, src/CGSolver.c:107-129). Segmentable:
    running two segments is bit-identical to one long run, which is what
    makes checkpoint/resume exact. ``inv_diag`` switches the loop to
    Jacobi-preconditioned CG; ``precond`` to Chebyshev-polynomial PCG
    (see cg_init)."""
    _k, x_probe, _p, r_probe, *_ = state
    nr = r_probe.shape[0]
    vdt = r_probe.dtype
    sdt = default_acc_dtype(vdt, acc_dtype)
    spmv, dot, widen = _make_helpers(A, nr, A.nc, vdt, sdt, exchange, allsum)
    apply_m = resolve_apply_m(
        precond, inv_diag, lambda v: spmv(exchange(widen(v))), vdt
    )

    def cond(state):
        k, _x, _p, _r, _rtrans, normr, _hist, done = state
        return jnp.logical_and(
            jnp.logical_and(k < k_end, normr > eps), jnp.logical_not(done)
        )

    def body(state):
        k, x, p, r, rtrans, _normr, hist, done = state

        if apply_m is None:

            def first(_):
                return rtrans, widen(r)

            def rest(_):
                new_rtrans = dot(r, r)
                beta = (safe_div(new_rtrans, rtrans)).astype(vdt)
                return new_rtrans, widen(r) + beta * p

            rtrans, p = jax.lax.cond(k == 1, first, rest, None)
            normr = jnp.sqrt(rtrans)
        else:
            z = apply_m(r)

            def first(_):
                rr = dot(r, r)
                return rtrans, rr, widen(z)

            def rest(_):
                s = allsum(jnp.stack([
                    jnp.sum(r.astype(sdt) * z.astype(sdt)),
                    jnp.sum(r.astype(sdt) * r.astype(sdt)),
                ]))
                beta = (safe_div(s[0], rtrans)).astype(vdt)
                return s[0], s[1], widen(z) + beta * p

            rtrans, rr, p = jax.lax.cond(k == 1, first, rest, None)
            normr = jnp.sqrt(rr)
        hist = hist.at[k].set(normr)

        p = exchange(p)
        Ap = spmv(p)
        # Breakdown guard: at machine-zero residual pAp underflows and
        # alpha = rtrans/pAp explodes — the reference then poisons x with
        # inf - inf = NaN (src/CGSolver.c:124-127). We detect the breakdown
        # (pAp no longer a healthy positive multiple of rtrans), freeze the
        # converged state, and exit.
        pAp = dot(p[:nr], Ap)
        breakdown = pAp <= rtrans * 1e-30
        alpha = jnp.where(breakdown, 0, safe_div(rtrans, pAp)).astype(vdt)
        x = x + alpha * p[:nr]
        r = r - alpha * Ap
        return k + 1, x, p, r, rtrans, normr, hist, breakdown

    return jax.lax.while_loop(cond, body, state)


def cg_cs_loop(
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
    """Single-reduction CG (Chronopoulos & Gear 1989, "communication-
    saving" CG). Mathematically identical iterates to standard CG, but the
    two dependent dot products per iteration collapse into ONE fused
    allreduce of two scalars:

        gamma = r.r, delta = w.r   (w = A r)   — one allsum of a 2-vector
        beta  = gamma/gamma_old
        alpha = gamma / (delta - beta*gamma/alpha_old)
        p = r + beta p;  s = w + beta s        (s carries A p)
        x += alpha p;    r -= alpha s;   w = A r

    Per iteration: 1 exchange + 1 allreduce (the reference structure is
    1 exchange + 2 sequential allreduces, src/CGSolver.c:107-129 /
    SURVEY §3.1) at the cost of two extra axpys — a latency win that grows
    with mesh size. Residual-history parity with ``cg_loop`` holds to
    rounding (same Krylov iterates; tested in tests/test_cg.py).

    ``inv_diag`` folds Jacobi preconditioning into the same recurrence
    (Chronopoulos-Gear PCG): u = M^-1 r, w = A u, and the fused reduction
    carries one extra scalar — [r.u, w.u, r.r] — still ONE allreduce per
    iteration. alpha/beta use the M-inner products (gamma = r.u,
    delta = w.u); normr/history track the true ||r|| like cg_run's
    preconditioned path. ``precond`` (ChebPrecond) swaps M for the
    Chebyshev polynomial operator — the fused reduction structure is
    unchanged (the polynomial apply has no dot products), so this is
    polynomial PCG at ONE allreduce per iteration.
    """
    nr = b.shape[0]
    vdt = b.dtype
    sdt = default_acc_dtype(vdt, acc_dtype)
    spmv, dot, widen = _make_helpers(A, nr, A.nc, vdt, sdt, exchange, allsum)
    _apply_m = resolve_apply_m(
        precond, inv_diag, lambda v: spmv(exchange(widen(v))), vdt
    )
    has_m = _apply_m is not None

    def apply_m(r):
        return _apply_m(r) if has_m else r

    def fused_dots(r, u, w):
        # [gamma = r.u, delta = w.u] (+ [r.r] under preconditioning, where
        # r.u != r.r) — one allsum either way
        parts = [
            jnp.sum(r.astype(sdt) * u.astype(sdt)),
            jnp.sum(w.astype(sdt) * u.astype(sdt)),
        ]
        if has_m:
            parts.append(jnp.sum(r.astype(sdt) * r.astype(sdt)))
        return allsum(jnp.stack(parts))

    r = b - spmv(exchange(widen(x0)))
    u = apply_m(r)
    w = spmv(exchange(widen(u)))
    gd = fused_dots(r, u, w)
    gamma, delta = gd[0], gd[1]
    rr = gd[2] if has_m else gamma
    alpha = safe_div(gamma, delta)
    normr0 = jnp.sqrt(rr)
    hist0 = jnp.full(itermax, jnp.nan, dtype=sdt).at[0].set(normr0)
    # p never feeds the spmv (only u does), so it needs no halo tail.
    # normr tracks the PRE-update residual exactly like cg_run's, so the
    # exit iteration and recorded history match the standard loop.
    state = (jnp.asarray(1), x0, r, u, w, jnp.zeros(nr, vdt),
             jnp.zeros(nr, vdt), gamma, rr, alpha, jnp.zeros((), sdt),
             normr0, hist0, jnp.asarray(False))

    def cond(state):
        (k, _x, _r, _u, _w, _p, _s, _gamma, _rr, _al, _be, normr, _hist,
         done) = state
        return jnp.logical_and(
            jnp.logical_and(k < itermax, normr > eps),
            jnp.logical_not(done),
        )

    def body(state):
        k, x, r, u, w, p, s, gamma, rr, alpha, beta, _normr, hist, done = state
        normr = jnp.sqrt(rr)
        hist = hist.at[k].set(normr)
        b_v = beta.astype(vdt)
        p = u + b_v * p
        s = w + b_v * s
        a_v = alpha.astype(vdt)
        x = x + a_v * p
        r = r - a_v * s
        u = apply_m(r)
        w = spmv(exchange(widen(u)))
        gd = fused_dots(r, u, w)
        g_new, d_new = gd[0], gd[1]
        rr_new = gd[2] if has_m else g_new
        beta_new = safe_div(g_new, gamma)
        denom = d_new - beta_new * safe_div(g_new, alpha)
        # breakdown: denom is p.Ap in disguise — same positivity guard as
        # cg_run (machine-zero residuals underflow it)
        breakdown = denom <= g_new * 1e-30
        alpha_new = jnp.where(breakdown, 0, safe_div(g_new, denom))
        return (k + 1, x, r, u, w, p, s, g_new, rr_new, alpha_new, beta_new,
                normr, hist, breakdown)

    k, x, *_rest, hist, _done = jax.lax.while_loop(cond, body, state)
    return x, k, hist


@lru_cache(maxsize=None)
def _sstep_loop_for(s: int):
    # cached so resolve_cg_loop returns the SAME callable object for a
    # given basis size — the solver jit cache (_jitcache.py) keys on it
    from sparsebench.solvers.cg_sstep import cg_sstep_loop

    return partial(cg_sstep_loop, s=s)


def resolve_cg_loop(variant: str, sstep: int = 4):
    """Map a CG variant name to its loop function — the ONE place the
    variant vocabulary lives, shared by the serial and distributed
    drivers. Raises ValueError on unknown names: the historic failure
    mode was an if/else chain in each driver silently falling back to
    standard CG on a typo and reporting its results as the requested
    variant."""
    if variant == "standard":
        return cg_loop
    if variant == "cs":
        return cg_cs_loop
    if variant == "sstep":
        return _sstep_loop_for(sstep)
    if variant == "pipe":
        from sparsebench.solvers.cg_pipe import cg_pipe_loop

        return cg_pipe_loop
    raise ValueError(
        "variant must be 'standard', 'cs', 'sstep' or 'pipe', "
        f"got {variant!r}"
    )


def cg_loop(
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
    """Pure jittable CG. ``A`` is any device format (pytree); ``b``/``x0``
    are length-nr vectors already in the format's row order. Returns
    (x, k, history[itermax]) with history[j] = normr at iteration j
    (nan where not reached).
    """
    state = cg_init(A, b, x0, itermax, exchange, allsum, acc_dtype, inv_diag,
                    precond)
    k, x, p, r, rtrans, normr, hist, _done = cg_run(
        A, state, itermax, eps, exchange, allsum, acc_dtype, inv_diag, precond
    )
    return x, k, hist


def solve_cg(
    A,
    b: np.ndarray,
    *,
    x0: Optional[np.ndarray] = None,
    itermax: int = 150,
    eps: float = 0.0,
    exchange: Callable = _identity,
    allsum: Callable = _identity,
    acc_dtype=None,
    inv_diag: Optional[np.ndarray] = None,
    precond=None,
    variant: str = "standard",
    sstep: int = 4,
    verbose: bool = True,
) -> CGResult:
    """Host driver: permutation handling, jit, timing, residual printing.

    ``b`` is in original row order; the result ``x`` likewise. Pass
    ``inv_diag`` (1/diag(A), original row order) for Jacobi PCG, and/or
    ``precond`` (solvers/precond.py ChebPrecond, bounds for A — or for
    D^-1 A when combined with ``inv_diag``) for polynomial PCG.
    ``variant="cs"`` selects single-reduction CG (see cg_cs_loop);
    ``variant="sstep"`` selects s-step communication-avoiding CG with
    basis size ``sstep`` (solvers/cg_sstep.py — one fused allreduce per
    ``sstep`` iterations); ``variant="pipe"`` selects pipelined CG
    (solvers/cg_pipe.py — the allreduce overlaps the matvec).
    """
    loop_fn = resolve_cg_loop(variant, sstep)
    if precond is not None and variant not in ("standard", "cs", "pipe"):
        raise ValueError(
            "operator preconditioning (precond=) supports cg variants "
            f"'standard', 'cs' and 'pipe' only, not {variant!r}"
        )
    b = jnp.asarray(b)
    if x0 is None:
        x0 = jnp.zeros_like(b)  # reference initVectors: x = 0 (CGSolver.c:29)
    else:
        x0 = jnp.asarray(x0)
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

    kw = {"inv_diag": inv_diag}
    # precond is entirely static (python floats + int) — it rides the
    # partial closure, not the traced arguments
    extra = {"precond": precond} if precond is not None else {}
    loop = jit_loop(loop_fn, itermax=itermax, exchange=exchange,
                    allsum=allsum, acc_dtype=acc_dtype, **extra)
    eps_arr = jnp.asarray(eps, dtype=acc_dtype or b.dtype)

    # warm-up compile outside the timed section (the reference's compile cost
    # is paid at build time; ours at first trace)
    x_dev, k_dev, hist_dev = loop(A, b_in, x0_in, eps=eps_arr, **kw)
    int(k_dev)

    t0 = time.perf_counter()
    x_dev, k_dev, hist_dev = loop(A, b_in, x0_in, eps=eps_arr, **kw)
    # the iteration count depends on the whole loop, so reading it back
    # waits for the solve (what block_until_ready would do)
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


def check_residual(
    x: np.ndarray, xexact: np.ndarray, allmax: Callable = _identity
) -> float:
    """max|x - xexact| (reference solverCheckResidual, src/CGSolver.c:40-60)."""
    local = jnp.max(jnp.abs(jnp.asarray(x) - jnp.asarray(xexact)))
    return float(allmax(local))


def init_vectors(csr=None, dtype=np.float64, generated: bool = True,
                 row_lengths: Optional[np.ndarray] = None):
    """Reference initVectors (src/CGSolver.c:19-38): x=0; for generated
    problems b = 27 - (nnzrow - 1) with exact solution x == 1, else b = 1.

    The reference only defines this under ``#ifdef CRS`` (CGSolver.c:21) —
    a bug for SCS/CCRS builds (SURVEY §2.10); here it works for any format
    because it operates on the CSR intermediate before conversion, or on
    ``row_lengths`` alone (the analytic stencil->DIA path has no CSR).
    """
    nnzrow = row_lengths if row_lengths is not None else csr.row_lengths
    nr = nnzrow.shape[0]
    x = np.zeros(nr, dtype=dtype)
    if generated:
        b = (27.0 - (nnzrow - 1)).astype(dtype)
        xexact = np.ones(nr, dtype=dtype)
    else:
        b = np.ones(nr, dtype=dtype)
        xexact = None
    return x, b, xexact
