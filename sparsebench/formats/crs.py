"""CRS and CCRS device formats (reference src/matrix-CRS.c, src/matrix-CCRS.c).

The reference CRS keeps rowPtr/colInd/val and runs an OpenMP row loop with a
scalar dot per row (src/matrix-CRS.c:46-64); CCRS is the same layout with
interleaved {col,val} array-of-structs entries (src/CCRSMatrix.h:9-12).
Neither maps to XLA: a row loop is scalar control flow and AoS interleaving
has no meaning for it. The device CRS keeps the *semantics* (no row
reordering, exact nnz storage) with a flat static-shape layout:

  val[e], col[e], row[e]  — element-parallel, sorted by row, padded to a
  lane-aligned length with (val=0, col=0, row=nr) sentinel entries.

SpMV = elementwise multiply + sorted segment-sum, fully vectorizable.
CCRS registers as an alias: on device the two are identical (the reference's
CCRS convertMatrix is a no-op bug anyway, src/matrix-CCRS.c:12; SURVEY §2.9).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from sparsebench import struct
from sparsebench.config import DTypePolicy
from sparsebench.formats.base import default_policy, pad_to, round_up, take
from sparsebench.formats.registry import register_format
from sparsebench.host.csr import HostCSR

_PAD = 1024  # 8 sublanes x 128 lanes


@register_format("crs")
@struct.dataclass
class CRSMatrix:
    """Element-parallel CRS (flat COO-with-sorted-rows) device matrix."""

    val: jnp.ndarray  # value[nnz_padded]
    col: jnp.ndarray  # index[nnz_padded]
    row: jnp.ndarray  # index[nnz_padded], row id per element (sentinel nr)
    nr: int = struct.field(pytree_node=False)
    nc: int = struct.field(pytree_node=False)
    nnz: int = struct.field(pytree_node=False)
    start_row: int = struct.field(pytree_node=False, default=0)
    total_nr: int = struct.field(pytree_node=False, default=0)
    total_nnz: int = struct.field(pytree_node=False, default=0)

    @classmethod
    def from_csr(
        cls, csr: HostCSR, policy: Optional[DTypePolicy] = None, *,
        nnz_pad: int = 0, **_opts
    ) -> "CRSMatrix":
        """``nnz_pad`` raises the padded length (distributed builds pass
        the largest shard's nnz, so every shard pads to one length and
        its sentinel rows stay sorted last when the shards stack)."""
        policy = default_policy(policy)
        nnz = csr.nnz
        nnz_p = max(_PAD, round_up(max(nnz, nnz_pad), _PAD))
        rows = np.repeat(np.arange(csr.nr, dtype=np.int64), csr.row_lengths)
        return cls(
            val=jnp.asarray(pad_to(csr.val.astype(policy.value), nnz_p, 0)),
            col=jnp.asarray(pad_to(csr.col.astype(policy.index), nnz_p, 0)),
            row=jnp.asarray(pad_to(rows.astype(policy.index), nnz_p, csr.nr)),
            nr=csr.nr,
            nc=csr.nc,
            nnz=nnz,
            start_row=csr.start_row,
            total_nr=csr.total_nr,
            total_nnz=csr.total_nnz,
        )

    def spmv(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A @ x (reference spMVM, src/matrix-CRS.c:46-64)."""
        prod = self.val * take(x, self.col).astype(self.val.dtype)
        y = jax.ops.segment_sum(
            prod,
            self.row,
            num_segments=self.nr + 1,
            indices_are_sorted=True,
        )
        return y[: self.nr]

    # CRS does not reorder rows.
    @property
    def permuted_output(self) -> bool:
        return False

    def permute_vector(self, v: jnp.ndarray) -> jnp.ndarray:
        return v

    def unpermute_vector(self, v: jnp.ndarray) -> jnp.ndarray:
        return v


@register_format("ccrs")
@struct.dataclass
class CCRSMatrix(CRSMatrix):
    """CLI/API-parity alias of CRS (see module docstring)."""
