"""Device matrix format protocol.

Every format is a pytree (sparsebench.struct.dataclass: arrays are leaves, layout
metadata is static) exposing:

  * ``from_csr(csr, policy, **opts)`` — the reference's
    ``convertMatrix(Matrix*, GMatrix*)`` (src/matrix.h:56), host-side;
  * ``spmv(x)`` — jittable SpMV, the reference's ``spMVM`` (src/matrix.h:57).
    ``x`` has length ``nc`` (>= nr once halo columns are appended by the
    partitioner, reference comm.c:616); the result has length ``nr``.

Row-permuting formats (SELL-C-sigma) additionally carry
``old_to_new``/``new_to_old`` and a ``permuted_output`` flag: their raw
kernel writes y in sorted row order (like the reference kernel,
src/matrix-SCS.c:229-231). ``spmv`` always returns original row order;
solvers that want to stay in permuted space use ``spmv_permuted`` plus
``permute_vector``/``unpermute_vector`` — the reference constructs these
perms but never applies them in CG (latent bug, SURVEY.md §7); we do.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from sparsebench.config import DTypePolicy


def default_policy(policy: Optional[DTypePolicy]) -> DTypePolicy:
    return policy if policy is not None else DTypePolicy.from_names("f64", "i32")


def take(x: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Gather with in-bounds promise (we build all index arrays ourselves)."""
    return jnp.asarray(x).at[idx].get(mode="promise_in_bounds")


def pad_to(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    if a.shape[0] >= n:
        return a
    pad = np.full((n - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def physical_spmv_bytes(A, x_bytes: int = 4) -> int:
    """Bytes PHYSICALLY streamed per SpMV: every stored matrix array
    (including padding, at its stored dtype) + one read of x + one write
    of y. This is the honest roofline numerator; the reference's byte
    model ((value_bytes + index_bytes) * nnz, src/main.c:187-189) is the
    "effective" model used for cross-implementation comparison — it
    credits compression (bf16/i8 storage) and debits padding.

    Works on any format pytree: sums ``.nbytes`` over array leaves.
    """
    import jax

    mat = sum(
        int(np.prod(leaf.shape)) * jnp.dtype(leaf.dtype).itemsize
        for leaf in jax.tree_util.tree_leaves(A)
        if hasattr(leaf, "dtype")
    )
    return mat + (A.nc + A.nr) * x_bytes
