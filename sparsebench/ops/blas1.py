"""BLAS-1 streaming kernels (reference src/solver.c:16-62).

On the device these are single fused XLA element-wise ops — the reference's OpenMP
loops and its alpha==1 / beta==1 special cases (src/solver.c:23-38) are
subsumed by XLA constant folding. They exist as named functions so the
kernel-level benchmark harness (reference profiler regions WAXPBY/DDOT,
src/profiler.h:24) can measure them in isolation.

``ddot`` deliberately does NOT embed a global reduction — the reference
fuses MPI_Allreduce into ddot (src/solver.c:60), which here would hide a
collective inside a kernel. Solvers apply their communicator's ``allsum``
explicitly, keeping the 3-collectives-per-iteration structure visible
(SURVEY.md §3.1).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp


def waxpby(alpha, x: jnp.ndarray, beta, y: jnp.ndarray) -> jnp.ndarray:
    """w = alpha*x + beta*y (reference src/solver.c:16-39)."""
    return alpha * x + beta * y


def ddot(x: jnp.ndarray, y: jnp.ndarray, *, acc_dtype: Optional[jnp.dtype] = None):
    """Local dot product (reference src/solver.c:41-59, minus the allreduce).

    ``acc_dtype`` upcasts the accumulation (e.g. f32 data, f64 accumulate)
    for residual-history parity at low storage precision.
    """
    if acc_dtype is not None:
        x = x.astype(acc_dtype)
        y = y.astype(acc_dtype)
    # sum(x*y), not jnp.dot — XLA's dot lowering is inaccurate for this
    # (observed ~1e-3 relative error on the CPU backend for f64); the tree
    # reduction of sum() is accurate on every backend.
    return jnp.sum(x * y)
