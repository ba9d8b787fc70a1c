"""Split interior/boundary formats for distributed matrices.

The halo renumbering destroys the banded structure of a shard's local
matrix (external columns land in the compacted tail, reference
comm.c:96-110), so plain DIA cannot represent distributed blocks
(formats/dia.py constraint). The split: entries with local columns
(< nr) keep the interior format's fast path; the few boundary entries
whose columns point into the halo tail are a small element-parallel CRS
block, scatter-added onto the interior product. Both parts stream their
own data once, and the boundary part is a tiny fraction (the exchange
faces).

Used by the distributed layer for ``--fmt dia``; not registered as a
standalone format (single-device DIA needs no split).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from sparsebench import struct
from sparsebench.config import DTypePolicy
from sparsebench.formats.base import take
from sparsebench.formats.bslab import BslabMatrix
from sparsebench.formats.crs import CRSMatrix
from sparsebench.formats.dia import DiaMatrix
from sparsebench.host.csr import HostCSR


def split_interior_boundary(csr: HostCSR) -> Tuple[HostCSR, HostCSR]:
    """Partition entries into (cols < nr) interior and halo-tail boundary.

    O(nnz) with two passes and no per-entry row array: per-row interior
    counts come from the running sum of the mask sampled at row_ptr
    (the previous np.repeat + bincount build materialized a 8 B-per-nnz
    row index — ~1.7 GB and tens of host seconds at 200^3)."""
    interior_mask = csr.col < csr.nr
    run = np.zeros(csr.nnz + 1, dtype=np.int64)
    np.cumsum(interior_mask, out=run[1:])
    in_counts = run[csr.row_ptr[1:]] - run[csr.row_ptr[:-1]]

    def build(mask, counts, nc):
        row_ptr = np.zeros(csr.nr + 1, dtype=np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        return HostCSR(
            row_ptr=row_ptr,
            col=csr.col[mask],
            val=csr.val[mask],
            nr=csr.nr,
            nc=nc,
            start_row=csr.start_row,
            stop_row=csr.stop_row,
            total_nr=csr.total_nr,
            total_nnz=csr.total_nnz,
        )

    return (
        build(interior_mask, in_counts, csr.nr),
        build(~interior_mask, csr.row_lengths - in_counts, csr.nc),
    )


def _add_boundary(y: jnp.ndarray, boundary: CRSMatrix,
                  x: jnp.ndarray) -> jnp.ndarray:
    """y + boundary @ x as one scatter-add onto the interior product (the
    boundary's padding entries carry row id nr and are dropped)."""
    prod = boundary.val * take(x, boundary.col).astype(boundary.val.dtype)
    return y.at[boundary.row].add(prod.astype(y.dtype), mode="drop")


@struct.dataclass
class DiaSplitMatrix:
    interior: DiaMatrix
    boundary: CRSMatrix
    nr: int = struct.field(pytree_node=False)
    nc: int = struct.field(pytree_node=False)
    nnz: int = struct.field(pytree_node=False)
    start_row: int = struct.field(pytree_node=False, default=0)
    total_nr: int = struct.field(pytree_node=False, default=0)
    total_nnz: int = struct.field(pytree_node=False, default=0)

    @classmethod
    def from_csr(
        cls,
        csr: HostCSR,
        policy: Optional[DTypePolicy] = None,
        *,
        forced_offsets=None,
        nnz_pad: int = 0,
        **_opts,
    ) -> "DiaSplitMatrix":
        interior_csr, boundary_csr = split_interior_boundary(csr)
        return cls(
            interior=DiaMatrix.from_csr(
                interior_csr, policy, forced_offsets=forced_offsets,
            ),
            boundary=CRSMatrix.from_csr(boundary_csr, policy,
                                        nnz_pad=nnz_pad),
            nr=csr.nr,
            nc=csr.nc,
            nnz=csr.nnz,
            start_row=csr.start_row,
            total_nr=csr.total_nr,
            total_nnz=csr.total_nnz,
        )

    def spmv(self, x: jnp.ndarray) -> jnp.ndarray:
        # The explicit local-head slice makes the interior product's
        # independence from the halo exchange STRUCTURAL: the exchange
        # returns concat([x_local, received_tail]) (parallel/exchange.py),
        # XLA forwards slice-of-concat, so the dominant interior kernel
        # never waits on the collectives — the exchange rides under it
        # (latency-hiding scheduler). Only the tiny boundary product
        # consumes the wire data. The stored-format analog of the
        # matrix-free --overlap (parallel/stencil_dist.py).
        return _add_boundary(self.interior.spmv(x[: self.nr]),
                             self.boundary, x)

    @property
    def permuted_output(self) -> bool:
        return False

    def permute_vector(self, v: jnp.ndarray) -> jnp.ndarray:
        return v

    def unpermute_vector(self, v: jnp.ndarray) -> jnp.ndarray:
        return v

    @staticmethod
    def plan(shard_csrs):
        """Unified forced_offsets so shard builds stack."""
        offsets = set()
        for s in shard_csrs:
            ic, _ = split_interior_boundary(s)
            rows = np.repeat(np.arange(ic.nr, dtype=np.int64), ic.row_lengths)
            offsets.update(np.unique(ic.col - rows).tolist())
        return tuple(sorted(offsets))


@struct.dataclass
class BslabSplitMatrix:
    """Split interior/boundary BSLAB for distributed general matrices.

    Same decomposition as DiaSplitMatrix, with BSLAB (formats/bslab.py)
    on the interior block. The interior product reads only the LOCAL x
    head (sliced in spmv), so the halo-exchange collectives and the
    dominant interior product are structurally independent and XLA's
    latency-hiding scheduler can overlap the transfer with the interior
    apply (the reference's MPI_Neighbor_alltoallv is blocking,
    comm.c:627-651)."""

    interior: "BslabMatrix"
    boundary: CRSMatrix
    nr: int = struct.field(pytree_node=False)
    nc: int = struct.field(pytree_node=False)
    nnz: int = struct.field(pytree_node=False)
    start_row: int = struct.field(pytree_node=False, default=0)
    total_nr: int = struct.field(pytree_node=False, default=0)
    total_nnz: int = struct.field(pytree_node=False, default=0)

    @classmethod
    def from_csr(
        cls,
        csr: HostCSR,
        policy: Optional[DTypePolicy] = None,
        *,
        sub: int = 0,
        min_s_aff: int = 0,
        min_s_gen: int = 0,
        nnz_pad: int = 0,
        **_opts,
    ) -> "BslabSplitMatrix":
        interior_csr, boundary_csr = split_interior_boundary(csr)
        return cls(
            interior=BslabMatrix.from_csr(
                interior_csr, policy, sub=sub, min_s_aff=min_s_aff,
                min_s_gen=min_s_gen,
            ),
            boundary=CRSMatrix.from_csr(boundary_csr, policy,
                                        nnz_pad=nnz_pad),
            nr=csr.nr,
            nc=csr.nc,
            nnz=csr.nnz,
            start_row=csr.start_row,
            total_nr=csr.total_nr,
            total_nnz=csr.total_nnz,
        )

    def spmv(self, x: jnp.ndarray) -> jnp.ndarray:
        # see DiaSplitMatrix.spmv: the local-head slice keeps the
        # interior product off the exchange's dependency chain
        return _add_boundary(self.interior.spmv(x[: self.nr]),
                             self.boundary, x)

    @property
    def padding_ratio(self) -> float:
        return float(getattr(self.interior, "padding_ratio", 1.0))

    @property
    def permuted_output(self) -> bool:
        return False

    def permute_vector(self, v: jnp.ndarray) -> jnp.ndarray:
        return v

    def unpermute_vector(self, v: jnp.ndarray) -> jnp.ndarray:
        return v
