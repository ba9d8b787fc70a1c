"""SELL-C-sigma device format — the flagship general sparse format.

Semantics follow the reference SELL-C-sigma (src/matrix-SCS.c, Kreutzer et
al. arXiv:1307.6209, golden-specced by tests/data/expected/): rows are
stably sorted by descending nnz within sigma windows, grouped into chunks of
height C, each chunk padded to its longest row. The *device layout* is the
device translation of "column-major within chunk, C = SIMD width"
(src/matrix-SCS.c:218-222): chunks whose padded length falls in the same
quantization bucket form one dense block stored transposed as

    val_t, col_t : (L_b, rows_b)   rows contiguous along lanes,

so SpMV is, per bucket, ``sum_j val_t[j] * x[col_t[j]]`` — L_b fully
vectorized multiply-accumulate sweeps with one gather each, no scalar row
loop and no scatter. Because sorted chunk lengths are (near-)monotone, the
number of buckets is tiny (<= ~log of the length spread).

Columns are stored remapped into *permuted* index space (local columns pass
through old_to_new; halo columns >= nr keep their index), so an entire CG
solve can stay in permuted space with zero per-iteration permutation cost.
The reference builds these permutations but never applies them in CG —
a latent bug (SURVEY.md §7) that this design fixes structurally.

Defaults: C=32, sigma=nr (full sort — the permutation is free once the
solver lives in permuted space, so maximal padding reduction wins).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from sparsebench import struct
from sparsebench.config import DTypePolicy
from sparsebench.formats.base import default_policy, round_up, take
from sparsebench.formats.registry import register_format
from sparsebench.formats.scs_host import _sigma_sort
from sparsebench.host.csr import HostCSR

_DEFAULT_C = 32
_LEN_QUANT = 4  # chunk lengths round up to a multiple of this before bucketing


@register_format("sell")
@struct.dataclass
class SellMatrix:
    # Per-bucket transposed dense blocks; tuple length == static bucket count.
    vals: Tuple[jnp.ndarray, ...]  # each (L_b, rows_b) value dtype
    cols: Tuple[jnp.ndarray, ...]  # each (L_b, rows_b) index dtype
    old_to_new: jnp.ndarray        # index[nr]
    new_to_old: jnp.ndarray        # index[nr]
    nr: int = struct.field(pytree_node=False)
    nc: int = struct.field(pytree_node=False)
    nnz: int = struct.field(pytree_node=False)
    C: int = struct.field(pytree_node=False)
    sigma: int = struct.field(pytree_node=False)
    nr_padded: int = struct.field(pytree_node=False)
    n_elems: int = struct.field(pytree_node=False)  # stored elements incl. pad
    start_row: int = struct.field(pytree_node=False, default=0)
    total_nr: int = struct.field(pytree_node=False, default=0)
    total_nnz: int = struct.field(pytree_node=False, default=0)

    # ------------------------------------------------------------------ build
    @classmethod
    def from_csr(
        cls,
        csr: HostCSR,
        policy: Optional[DTypePolicy] = None,
        *,
        C: int = 0,
        sigma: int = 0,
        len_quant: int = _LEN_QUANT,
        forced_chunk_lens: Optional[np.ndarray] = None,
        **_opts,
    ) -> "SellMatrix":
        policy = default_policy(policy)
        nr, nc = csr.nr, csr.nc
        C = C if C >= 1 else _DEFAULT_C
        sigma = sigma if sigma >= 1 else max(nr, 1)

        n_chunks = max(1, -(-nr // C))
        nr_padded = n_chunks * C

        counts = np.zeros(nr_padded, dtype=np.int64)
        counts[:nr] = csr.row_lengths
        new_to_old_pad = _sigma_sort(counts, sigma)
        old_to_new_pad = np.empty(nr_padded, dtype=np.int64)
        old_to_new_pad[new_to_old_pad] = np.arange(nr_padded, dtype=np.int64)

        sorted_counts = counts[new_to_old_pad]
        chunk_lens = sorted_counts.reshape(n_chunks, C).max(axis=1)
        chunk_lens_q = np.maximum(len_quant, round_up_arr(chunk_lens, len_quant))
        if forced_chunk_lens is not None:
            # distributed builds force one chunk plan across all shards so
            # per-shard blocks stack into uniform mesh-sharded arrays
            assert forced_chunk_lens.shape == chunk_lens_q.shape
            assert np.all(forced_chunk_lens >= chunk_lens)
            chunk_lens_q = forced_chunk_lens

        # Buckets = runs of consecutive chunks with equal quantized length.
        change = np.flatnonzero(np.diff(chunk_lens_q)) + 1
        bucket_chunk_starts = np.concatenate([[0], change, [n_chunks]])
        b_row0 = bucket_chunk_starts[:-1] * C  # first padded row per bucket
        b_row1 = bucket_chunk_starts[1:] * C
        b_len = chunk_lens_q[bucket_chunk_starts[:-1]]

        # Remap columns into permuted space (halo columns >= nr unchanged).
        col = csr.col
        col_perm = np.where(col < nr, old_to_new_pad[np.minimum(col, nr - 1)], col)

        # Destination of every nnz entry: bucket b, then
        # (j_in_row, row_new - b_row0[b]) inside the (L_b, rows_b) block.
        nnz = csr.nnz
        rows_old = np.repeat(np.arange(nr, dtype=np.int64), csr.row_lengths)
        j_in_row = np.arange(nnz, dtype=np.int64) - csr.row_ptr[rows_old]
        rows_new = old_to_new_pad[rows_old]
        b_of = np.searchsorted(b_row0, rows_new, side="right") - 1

        # Flat packing of all buckets: bucket b occupies
        # [flat0[b], flat0[b] + L_b * rows_b) in transposed row-major order.
        rows_b = b_row1 - b_row0
        sizes = b_len * rows_b
        flat0 = np.zeros(len(sizes) + 1, dtype=np.int64)
        np.cumsum(sizes, out=flat0[1:])
        dest = flat0[b_of] + j_in_row * rows_b[b_of] + (rows_new - b_row0[b_of])

        flat_val = np.zeros(int(flat0[-1]), dtype=policy.value)
        flat_col = np.zeros(int(flat0[-1]), dtype=policy.index)
        flat_val[dest] = csr.val.astype(policy.value)
        flat_col[dest] = col_perm.astype(policy.index)

        vals, cols = [], []
        for b in range(len(sizes)):
            sl = slice(int(flat0[b]), int(flat0[b + 1]))
            shape = (int(b_len[b]), int(rows_b[b]))
            vals.append(jnp.asarray(flat_val[sl].reshape(shape)))
            cols.append(jnp.asarray(flat_col[sl].reshape(shape)))

        return cls(
            vals=tuple(vals),
            cols=tuple(cols),
            old_to_new=jnp.asarray(old_to_new_pad[:nr].astype(policy.index)),
            new_to_old=jnp.asarray(_new_to_old(old_to_new_pad, nr).astype(policy.index)),
            nr=nr,
            nc=nc,
            nnz=nnz,
            C=C,
            sigma=sigma,
            nr_padded=nr_padded,
            n_elems=int(flat0[-1]),
            start_row=csr.start_row,
            total_nr=csr.total_nr,
            total_nnz=csr.total_nnz,
        )

    @staticmethod
    def plan_chunk_lens(
        csr: HostCSR, C: int = 0, sigma: int = 0, len_quant: int = _LEN_QUANT
    ) -> np.ndarray:
        """Quantized chunk lengths this CSR would use (for cross-shard
        unification: take the elementwise max over shards, then pass as
        ``forced_chunk_lens``)."""
        nr = csr.nr
        C = C if C >= 1 else _DEFAULT_C
        sigma = sigma if sigma >= 1 else max(nr, 1)
        n_chunks = max(1, -(-nr // C))
        nr_padded = n_chunks * C
        counts = np.zeros(nr_padded, dtype=np.int64)
        counts[:nr] = csr.row_lengths
        sorted_counts = counts[_sigma_sort(counts, sigma)]
        lens = sorted_counts.reshape(n_chunks, C).max(axis=1)
        return np.maximum(len_quant, round_up_arr(lens, len_quant))

    # ------------------------------------------------------------------ spmv
    def spmv_permuted(self, xp: jnp.ndarray) -> jnp.ndarray:
        """y_perm = A_perm @ xp. ``xp``: first ``nr`` entries in permuted
        order, tail (halo) unchanged. Returns length-``nr`` permuted y."""
        parts = []
        for val_t, col_t in zip(self.vals, self.cols):
            g = take(xp, col_t.reshape(-1)).reshape(col_t.shape)
            parts.append((val_t * g.astype(val_t.dtype)).sum(axis=0))
        y = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
        return y[: self.nr]

    def spmv(self, x: jnp.ndarray) -> jnp.ndarray:
        """Original-row-order SpMV: permute in, compute, un-permute out."""
        return take(self.spmv_permuted(self.permute_vector(x)), self.old_to_new)

    # ----------------------------------------------------------- permutation
    @property
    def permuted_output(self) -> bool:
        return True

    def permute_vector(self, v: jnp.ndarray) -> jnp.ndarray:
        """original order -> permuted order (first nr entries; tail kept)."""
        head = take(v, self.new_to_old)
        return head if v.shape[0] == self.nr else jnp.concatenate([head, v[self.nr :]])

    def unpermute_vector(self, vp: jnp.ndarray) -> jnp.ndarray:
        head = take(vp, self.old_to_new)
        return head if vp.shape[0] == self.nr else jnp.concatenate([head, vp[self.nr :]])


def round_up_arr(a: np.ndarray, m: int) -> np.ndarray:
    return ((a + m - 1) // m) * m


def _new_to_old(old_to_new_pad: np.ndarray, nr: int) -> np.ndarray:
    """Inverse restricted to real rows (reference src/matrix-SCS.c:131-143)."""
    out = np.zeros(nr, dtype=np.int64)
    o2n = old_to_new_pad[:nr]
    ok = o2n < nr
    out[o2n[ok]] = np.arange(nr, dtype=np.int64)[ok]
    return out


@register_format("ell")
@struct.dataclass
class EllMatrix:
    """Plain padded ELLPACK: one dense (Lmax, nr) transposed block, no row
    permutation. The best format when row lengths are near-uniform (e.g. the
    27-pt stencil problem: Lmax 27 vs mean ~26). Equivalent to SELL with
    C = nr and sigma = 1."""

    val_t: jnp.ndarray  # (Lmax, nr_padded)
    col_t: jnp.ndarray  # (Lmax, nr_padded)
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
        lmax: int = 0,
        **_opts,
    ) -> "EllMatrix":
        policy = default_policy(policy)
        nr = csr.nr
        nr_p = max(128, round_up(nr, 128))
        lens = csr.row_lengths
        actual_lmax = int(lens.max()) if nr and csr.nnz else 1
        if lmax and lmax < actual_lmax:
            raise ValueError(f"forced lmax {lmax} < actual max row length {actual_lmax}")
        lmax = lmax or actual_lmax
        val_t = np.zeros((lmax, nr_p), dtype=policy.value)
        col_t = np.zeros((lmax, nr_p), dtype=policy.index)
        rows = np.repeat(np.arange(nr, dtype=np.int64), lens)
        j_in_row = np.arange(csr.nnz, dtype=np.int64) - csr.row_ptr[rows]
        val_t[j_in_row, rows] = csr.val.astype(policy.value)
        col_t[j_in_row, rows] = csr.col.astype(policy.index)
        return cls(
            val_t=jnp.asarray(val_t),
            col_t=jnp.asarray(col_t),
            nr=nr,
            nc=csr.nc,
            nnz=csr.nnz,
            n_elems=lmax * nr_p,
            start_row=csr.start_row,
            total_nr=csr.total_nr,
            total_nnz=csr.total_nnz,
        )

    def spmv(self, x: jnp.ndarray) -> jnp.ndarray:
        g = take(x, self.col_t.reshape(-1)).reshape(self.col_t.shape)
        y = (self.val_t * g.astype(self.val_t.dtype)).sum(axis=0)
        return y[: self.nr]

    @property
    def permuted_output(self) -> bool:
        return False

    def permute_vector(self, v: jnp.ndarray) -> jnp.ndarray:
        return v

    def unpermute_vector(self, v: jnp.ndarray) -> jnp.ndarray:
        return v
