"""Operator preconditioners (beyond the reference, which is unpreconditioned
— src/CGSolver.c has no M; --precond jacobi was the first extension).

Chebyshev polynomial preconditioning is the mesh-friendly choice among
the classic strong preconditioners: one application is ``degree`` SpMVs +
axpys — pure streaming work with NO dot products, hence **zero additional
allreduces per CG iteration** (ILU/IC need sparse triangular solves, which
are sequential and gather-bound — the worst pattern for a wide device). On a
multi-chip mesh a degree-k polynomial preconditioner cuts the global
iteration count ~(k+1)-fold while the per-iteration collective count stays
exactly the baseline's (2 psums for standard CG, 1 fused for the cs
variant); only cheap nearest-neighbor halo exchanges scale with k.

The polynomial is the textbook Chebyshev semi-iteration (Saad, "Iterative
Methods for Sparse Linear Systems", Alg. 12.1) run for a FIXED number of
steps from z0 = 0: z = p_k(A) r with p_k the degree-k Chebyshev
approximation of 1/x on [lmin, lmax]. A fixed polynomial in an SPD A is
itself SPD, so CG's theory holds (flexible-CG is not needed). With Jacobi
scaling the operator becomes M^-1 = p_k(D^-1 A) D^-1 — still symmetric
positive definite (it equals D^-1/2 p_k(D^-1/2 A D^-1/2) D^-1/2).

Bounds come from the existing fused-Lanczos estimator
(solvers/chebyshev.py estimate_bounds, weighted form for the scaled
operator) — the same machinery the standalone Chebyshev solver uses.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChebPrecond:
    """Fixed Chebyshev polynomial preconditioner z = p_degree(A) r.

    Entirely static: ``lmin``/``lmax`` are Python floats (compile-time
    constants under jit — the object is closed over, never traced) and
    ``degree`` is the polynomial degree = number of operator applications
    per preconditioner apply. ``degree >= 1``; degree 0 would be a scalar
    multiple of the identity (use no preconditioner instead).
    """

    lmin: float
    lmax: float
    degree: int = 3

    def __post_init__(self):
        if self.degree < 1:
            raise ValueError(f"degree must be >= 1, got {self.degree}")
        if not (0 < self.lmin < self.lmax):
            raise ValueError(
                f"need 0 < lmin < lmax, got [{self.lmin}, {self.lmax}]"
            )

    def apply(self, matvec, r):
        """z = p_degree(A) r via the Chebyshev semi-iteration from z0 = 0.

        ``matvec`` is the full (exchanged, scaled if Jacobi-composed)
        operator apply for length-nr vectors; ``r`` the residual in the
        operator's working space. The loop is a static Python unroll —
        ``degree`` is small (2..8) and unrolling lets XLA fuse the axpys
        between the SpMVs.
        """
        theta = (self.lmax + self.lmin) / 2.0
        delta = (self.lmax - self.lmin) / 2.0
        sigma1 = theta / delta
        d = r / theta
        z = d
        rho = 1.0 / sigma1
        for _ in range(self.degree):
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * (r - matvec(z))
            z = z + d
            rho = rho_new
        return z


def cheb_precond_for(
    A, nr: int, dtype, degree: int = 3, exchange=None, allsum=None,
    permute=None, inv_diag=None, steps: int = 25,
) -> ChebPrecond:
    """Build a ChebPrecond for ``A`` from fused-Lanczos bounds with
    precond-mode (tight multiplicative) margins. ``inv_diag`` switches the
    estimate to spec(D^-1 A) (weighted Lanczos) to match the scaled
    polynomial resolve_apply_m builds when both are passed to a solver."""
    from sparsebench.solvers.chebyshev import estimate_bounds

    kw = {}
    if exchange is not None:
        kw["exchange"] = exchange
    if allsum is not None:
        kw["allsum"] = allsum
    lmin, lmax = estimate_bounds(
        A, nr, dtype, steps=steps, permute=permute, inv_diag=inv_diag,
        mode="precond", **kw,
    )
    return ChebPrecond(lmin, lmax, degree)


def resolve_apply_m(precond, inv_diag, matvec, vdt):
    """The ONE place the (precond, inv_diag) pair becomes an apply-M
    callable, shared by every solver loop:

      * both None                -> None (unpreconditioned)
      * inv_diag only            -> Jacobi, z = D^-1 r
      * precond only             -> z = p_k(A) r
      * precond + inv_diag       -> z = p_k(D^-1 A) D^-1 r (scaled
                                    polynomial; bounds must then be for
                                    spec(D^-1 A) — weighted Lanczos)

    ``matvec`` is the exchanged SpMV for length-nr vectors (ignored for
    pure Jacobi)."""
    if precond is None and inv_diag is None:
        return None
    if precond is None:
        return lambda r: (inv_diag * r).astype(vdt)
    if inv_diag is None:
        mv = lambda v: matvec(v).astype(vdt)  # noqa: E731
        return lambda r: precond.apply(mv, r).astype(vdt)
    mv = lambda v: (inv_diag * matvec(v)).astype(vdt)  # noqa: E731
    return lambda r: precond.apply(
        mv, (inv_diag * r).astype(vdt)
    ).astype(vdt)
