"""Matrix-free operator for the generated 27/7-point stencil problem.

The reference's generator (src/matrix.c:30-121) emits diag = 27.0 and
-1.0 for every in-domain neighbor of the tensor-product stencil. That
matrix has a closed form: with S_a the zero-boundary 3-point sum along
axis a (S_a x)[i] = x[i-1] + x[i] + x[i+1],

    27-pt:  A x = 28 x - (S_z . S_y . S_x) x
    7-pt:   A x = 30 x - (S_x + S_y + S_z) x

because the 27 neighbor offsets are exactly the tensor product
{-1,0,1}^3 with uniform weight, the out-of-domain truncation factorizes
per axis, and the center appears in the product/sums with known
multiplicity. So the operator needs ZERO matrix bytes: SpMV streams x
and y only — the logical endpoint of the compression ladder the storing
formats climb (f32 -> bf16 diagonals), reached by exploiting what the
reference fixes structurally at generation time.

This is deliberately NOT a general sparse format: `from_csr` is absent,
it exists only for `filename = generate|generate7P` workloads
(`--fmt stencil`), and its bandwidth is excluded from the SpMV roofline
claims (physical_spmv_bytes degenerates to x+y; the honest streaming
numbers stay with DIA/BSLAB). CG time-to-solution, however, is a fair
headline: the iterates are bit-for-the-same-rounding the stored-matrix
ones (same values, same order of magnitude of accumulation — verified
against the CSR oracle in tests/test_stencil_op.py).

Serial only: the weak-scaling z-stacked multi-rank problem
(src/matrix.c:37-41) puts neighbor columns outside the local slab; its
distributed form is parallel/stencil_dist.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sparsebench import struct
from sparsebench.config import DTypePolicy
from sparsebench.formats.base import default_policy
from sparsebench.formats.registry import register_format


def _axis_counts(n: int) -> np.ndarray:
    """Per-position count of in-domain {-1,0,+1} offsets along one axis."""
    c = np.full(n, 3, dtype=np.int64)
    if n >= 1:
        c[0] = min(2, n)
        c[-1] = min(2, n)
    if n == 1:
        c[0] = 1
    return c


def stencil_row_counts(nx: int, ny: int, nz: int,
                       use_7pt: bool = False) -> np.ndarray:
    """Row lengths of the generated matrix (incl. the diagonal), flattened
    in the generator's row order (x fastest — src/matrix.c:42-47). Feeds
    the b = 27 - (nnzrow - 1) exact-solution setup (src/CGSolver.c:25-36)."""
    cx, cy, cz = _axis_counts(nx), _axis_counts(ny), _axis_counts(nz)
    if use_7pt:
        counts = (cz[:, None, None] + cy[None, :, None] + cx[None, None, :]
                  - 2)
    else:
        counts = cz[:, None, None] * cy[None, :, None] * cx[None, None, :]
    return counts.reshape(-1)


def _sum3(a: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Zero-boundary 3-point sum along ``axis`` (the S_a operator)."""
    n = a.shape[axis]
    pad = [(1, 1) if i == axis else (0, 0) for i in range(a.ndim)]
    p = jnp.pad(a, pad)
    return (jax.lax.slice_in_dim(p, 0, n, axis=axis)
            + jax.lax.slice_in_dim(p, 1, n + 1, axis=axis)
            + jax.lax.slice_in_dim(p, 2, n + 2, axis=axis))


@register_format("stencil")
@struct.dataclass
class StencilOperator:
    """Matrix-free 27/7-pt stencil apply. A pytree with zero array leaves:
    every field is static layout metadata, so ``physical_spmv_bytes``
    correctly reports x+y traffic only."""

    nx: int = struct.field(pytree_node=False)
    ny: int = struct.field(pytree_node=False)
    nz: int = struct.field(pytree_node=False)
    use_7pt: bool = struct.field(pytree_node=False)
    nr: int = struct.field(pytree_node=False)
    nc: int = struct.field(pytree_node=False)
    nnz: int = struct.field(pytree_node=False)
    start_row: int = struct.field(pytree_node=False, default=0)
    total_nr: int = struct.field(pytree_node=False, default=0)
    total_nnz: int = struct.field(pytree_node=False, default=0)

    @classmethod
    def from_csr(cls, csr, policy=None, **_opts):
        raise ValueError(
            "the stencil format is matrix-free and only applies to "
            "generated problems (filename = generate|generate7P); use a "
            "storing format (dia/bslab/...) for ingested matrices"
        )

    @classmethod
    def from_stencil(
        cls,
        nx: int,
        ny: int,
        nz: int,
        *,
        rank: int = 0,
        size: int = 1,
        use_7pt: bool = False,
        policy: Optional[DTypePolicy] = None,
        **_opts,
    ) -> Tuple["StencilOperator", np.ndarray]:
        if size != 1 or rank != 0:
            raise ValueError(
                "the matrix-free stencil operator is serial-only; the "
                "z-stacked multi-rank problem needs halo columns — use "
                "--fmt dia|bslab under --shards"
            )
        nr = nx * ny * nz
        counts = stencil_row_counts(nx, ny, nz, use_7pt)
        nnz = int(counts.sum())
        return (
            cls(nx=nx, ny=ny, nz=nz, use_7pt=use_7pt, nr=nr, nc=nr,
                nnz=nnz, total_nr=nr, total_nnz=nnz),
            counts,
        )

    @property
    def padding_ratio(self) -> float:
        return 0.0

    @property
    def permuted_output(self) -> bool:
        return False

    def permute_vector(self, v: jnp.ndarray) -> jnp.ndarray:
        return v

    def unpermute_vector(self, v: jnp.ndarray) -> jnp.ndarray:
        return v

    def spmv(self, x: jnp.ndarray) -> jnp.ndarray:
        v = x[: self.nr].reshape(self.nz, self.ny, self.nx)
        if self.use_7pt:
            s = _sum3(v, 0) + _sum3(v, 1) + _sum3(v, 2)
            y = jnp.asarray(30.0, v.dtype) * v - s
        else:
            s = _sum3(_sum3(_sum3(v, 2), 1), 0)
            y = jnp.asarray(28.0, v.dtype) * v - s
        return y.reshape(-1)
