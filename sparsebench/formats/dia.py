"""DIA (diagonal) device format — gather-free SpMV for banded matrices.

No reference equivalent: the reference's formats all gather x through a
column index array. For banded/stencil matrices (the reference's
canonical workloads: the HPCG 27/7-pt generator, src/matrix.c:30-121, and
data/matrix_band_klein.mtx) the gather is avoidable: store the matrix as
its ``ndiag`` populated diagonals and compute

    y = sum_d  data[d, :] * x[offset_d : offset_d + nr]

— every x access is a contiguous shifted slice, which XLA fuses into one
elementwise loop. The x reads of neighbouring diagonals overlap within a
window of a few planes, so caches serve them and device-memory traffic is
the diagonals plus one pass over x.

Constraints: square local matrices only (halo-renumbered distributed blocks
break the banded structure — the distributed layer splits local/remote
parts instead), and ``ndiag`` must stay small; ``from_csr`` raises
``DiaUnsuitableError`` otherwise so callers can fall back to another format.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sparsebench import struct
from sparsebench.config import DTypePolicy
from sparsebench.formats.base import default_policy
from sparsebench.formats.registry import register_format
from sparsebench.host.csr import HostCSR

_MAX_DIAGS = 64

# (sz, sy, sx) in the reference generator's loop order (src/matrix.c:71-75).
_OFFSETS_27 = [
    (sz, sy, sx)
    for sz in (-1, 0, 1)
    for sy in (-1, 0, 1)
    for sx in (-1, 0, 1)
]


class DiaUnsuitableError(ValueError):
    """Matrix is not banded enough for DIA storage."""


@functools.partial(
    jax.jit,
    static_argnames=("specs", "nx", "ny", "local_nrow", "total_nrow",
                     "start_row", "store_dt"),
)
def _stencil_dia_device(specs, nx, ny, local_nrow, total_nrow, start_row,
                        store_dt):
    """Generate the 27/7-pt stencil's DIA data ON DEVICE: per (static)
    diagonal the values are a constant under three vectorized bound checks
    on iota-derived grid coordinates — no host arrays, no host->device
    transfer.

    Returns (data (ndiag, local_nrow), counts (local_nrow,) int32).
    """
    local = jax.lax.iota(jnp.int32, local_nrow)
    ix = local % nx
    iy = (local // nx) % ny
    counts = jnp.zeros(local_nrow, jnp.int32)
    planes = []
    for off, sz, sy, sx in specs:
        col = local + (start_row + off)
        m = (
            (ix + sx >= 0) & (ix + sx < nx)
            & (iy + sy >= 0) & (iy + sy < ny)
            & (col >= 0) & (col < total_nrow)
        )
        v = jnp.float32(27.0) if off == 0 else jnp.float32(-1.0)
        planes.append(jnp.where(m, v, 0.0).astype(store_dt))
        counts = counts + m
    return jnp.stack(planes), counts


def _compressed(data: np.ndarray) -> np.ndarray:
    """Lossless bf16 storage for f32 diagonals whose every value round-trips
    exactly (true for the generator's 27/-1 stencil values): halves the
    dominant traffic term at zero accuracy cost. SpMV accumulates in the x
    dtype."""
    import ml_dtypes

    bf = data.astype(ml_dtypes.bfloat16)
    return bf if np.array_equal(bf.astype(np.float32), data) else data


@register_format("dia")
@struct.dataclass
class DiaMatrix:
    # data[d, i] = A[i, i + offsets[d]] (zero where out of range)
    data: jnp.ndarray  # (ndiag, nr) value dtype (bf16 when lossless)
    offsets: Tuple[int, ...] = struct.field(pytree_node=False)
    nr: int = struct.field(pytree_node=False)
    nc: int = struct.field(pytree_node=False)
    nnz: int = struct.field(pytree_node=False)
    n_elems: int = struct.field(pytree_node=False)
    start_row: int = struct.field(pytree_node=False, default=0)
    total_nr: int = struct.field(pytree_node=False, default=0)
    total_nnz: int = struct.field(pytree_node=False, default=0)

    @classmethod
    def from_csr(
        cls,
        csr: HostCSR,
        policy: Optional[DTypePolicy] = None,
        *,
        max_diags: int = _MAX_DIAGS,
        compress: bool = True,
        forced_offsets=None,
        **_opts,
    ) -> "DiaMatrix":
        policy = default_policy(policy)
        if csr.nc != csr.nr:
            raise DiaUnsuitableError(
                f"DIA requires a square local matrix (nr={csr.nr}, nc={csr.nc})"
            )
        rows = np.repeat(np.arange(csr.nr, dtype=np.int64), csr.row_lengths)
        keys = csr.col - rows
        offsets = np.unique(keys)
        if forced_offsets is not None:
            # distributed builds force one diagonal set across shards so the
            # per-shard data arrays stack into a uniform mesh-sharded array
            forced = np.asarray(sorted(forced_offsets), dtype=np.int64)
            if not np.isin(offsets, forced).all():
                raise DiaUnsuitableError("forced_offsets misses populated diagonals")
            offsets = forced
        if offsets.size > max_diags:
            raise DiaUnsuitableError(
                f"{offsets.size} populated diagonals exceeds max_diags={max_diags}"
            )
        data = np.zeros((offsets.size, csr.nr), dtype=policy.value)
        d_idx = np.searchsorted(offsets, keys)
        data[d_idx, rows] = csr.val.astype(policy.value)
        if compress and data.dtype == np.float32:
            data = _compressed(data)
        return cls(
            data=jnp.asarray(data),
            offsets=tuple(int(o) for o in offsets),
            nr=csr.nr,
            nc=csr.nc,
            nnz=csr.nnz,
            n_elems=offsets.size * csr.nr,
            start_row=csr.start_row,
            total_nr=csr.total_nr,
            total_nnz=csr.total_nnz,
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
        compress: bool = True,
    ) -> Tuple["DiaMatrix", np.ndarray]:
        """Build the 27/7-pt stencil matrix (reference src/matrix.c:30-121)
        directly in DIA layout, skipping the CSR intermediate entirely.

        The generated matrix's populated diagonals are analytically known
        (offset = sz*nx*ny + sy*nx + sx per neighbor), its values are the
        constants 27.0 / -1.0, and validity per row is three vectorized
        bound checks — so the whole device format materializes with 27
        masked stores instead of a 27M-entry repeat/unique/scatter pipeline.

        Returns ``(matrix, row_counts)`` — row_counts feeds the reference's
        b = 27 - (nnzrow - 1) exact-solution setup (src/CGSolver.c:25-36)
        without a CSR to count from.
        """
        policy = default_policy(policy)
        local_nrow = nx * ny * nz
        total_nrow = local_nrow * size
        start_row = local_nrow * rank
        plane = nx * ny

        specs = [
            (sz * plane + sy * nx + sx, sz, sy, sx)
            for (sz, sy, sx) in _OFFSETS_27
            if not use_7pt or (sz * sz + sy * sy + sx * sx <= 1)
        ]
        offs = [s[0] for s in specs]
        if len(set(offs)) != len(offs):
            # degenerate tiny grids (nx or ny <= 2) can alias two neighbor
            # shifts onto one diagonal — fall back to the general CSR path
            from sparsebench.host.generator import generate_stencil

            csr = generate_stencil(nx, ny, nz, rank=rank, size=size,
                                   use_7pt=use_7pt, dtype=np.float64)
            return (
                cls.from_csr(csr, policy, compress=compress),
                csr.row_lengths,
            )
        specs.sort()  # match from_csr's np.unique-sorted offset order

        # bf16 is exact for the stencil's constants; build compressed
        # directly (from_csr proves round-trip equality, here it is static)
        if compress and np.dtype(policy.value) == np.float32:
            import ml_dtypes

            store_dt = np.dtype(ml_dtypes.bfloat16)
        else:
            store_dt = policy.value

        data, counts = _stencil_dia_device(
            tuple(specs), nx, ny, local_nrow, total_nrow, start_row,
            jnp.dtype(store_dt),
        )

        # from_csr derives offsets as global_col - local_row, which includes
        # the rank's start_row shift for stacked multi-rank grids — match it
        offsets = start_row + np.asarray([s[0] for s in specs], dtype=np.int64)
        nnz = int(counts.sum())
        obj = cls(
            data=data,
            offsets=tuple(int(o) for o in offsets),
            nr=local_nrow,
            nc=local_nrow,
            nnz=nnz,
            n_elems=len(specs) * local_nrow,
            start_row=start_row,
            total_nr=total_nrow,
            total_nnz=nnz if size == 1 else 27 * total_nrow,
        )
        return obj, counts

    def spmv(self, x: jnp.ndarray) -> jnp.ndarray:
        return self.spmm_kn(x[None, :])[0]

    def spmm(self, X: jnp.ndarray) -> jnp.ndarray:
        """Multi-RHS SpMV, (nc, k) -> (nr, k) = A @ X."""
        return self.spmm_kn(X.T).T

    def spmm_kn(self, X: jnp.ndarray) -> jnp.ndarray:
        """Multi-RHS SpMV in slab-major layout: X is (k, nc), returns
        (k, nr) = (A @ X.T).T.

        SpMV is bandwidth-bound and the matrix is the dominant stream (the
        reference's byte model charges (value+index) bytes per nonzero per
        solve, src/main.c:187-189). With k right-hand sides each diagonal
        is read ONCE for all k columns, so per-RHS matrix traffic drops
        k-fold while the x/y traffic stays. Accumulation is in the x
        dtype (the diagonals may be stored compressed bf16), so each
        column matches the single-RHS operator bit for bit."""
        nr = self.nr
        X = X[:, :nr]
        lo = -min(0, min(self.offsets))
        hi = max(0, max(self.offsets))
        Xp = jnp.pad(X, ((0, 0), (lo, hi)))
        Y = jnp.zeros((X.shape[0], nr), dtype=X.dtype)
        for d, off in enumerate(self.offsets):
            Y = Y + self.data[d, :nr].astype(X.dtype)[None, :] * (
                Xp[:, lo + off : lo + off + nr]
            )
        return Y

    @property
    def permuted_output(self) -> bool:
        return False

    def permute_vector(self, v: jnp.ndarray) -> jnp.ndarray:
        return v

    def unpermute_vector(self, v: jnp.ndarray) -> jnp.ndarray:
        return v
