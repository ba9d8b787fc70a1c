"""BSLAB — slab-table block-column SELL, the general sparse format.

Layout: rows group 128-consecutive per lane group; ``sub`` lane groups form
one tile of ``sub*128`` rows. Entries bucket by block-diagonal
d = col/128 - row/128, so one (sub,128) slice of a tile reads ONE
contiguous slab of x; rows pad per (tile, d) to the longest per-row run.
Slices are classified at build time: **affine** slices (lane index
= (lane + r) & 127 for one scalar r — all diagonal parts, i.e. every
stencil/banded slice) store NO index plane; **general** slices keep an
int8 lane-index plane. Together with bf16 values where lossless that is
3 B per stored element for general slices and 2 B for affine ones.

No row permutation (padding is bounded by column locality); `--rcm`
helps scattered matrices, row sorting is unnecessary.

Reference parity: the analog of the reference's SELL-C-sigma SIMD kernel
(src/matrix-SCS.c:198-227); "effective" reporting follows the
src/main.c:187-189 byte model.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sparsebench import struct
from sparsebench.config import DTypePolicy
from sparsebench.formats.base import default_policy, take
from sparsebench.formats.registry import register_format
from sparsebench.host.csr import HostCSR

LANES = 128  # rows per lane group and columns per x block
DEFAULT_SUB = 64


def _auto_sub(nr: int, sub: int, default: int = DEFAULT_SUB) -> int:
    """Default slice height: the tallest power-of-two (<= default) whose
    tile does not dwarf the matrix (tiny problems keep short tiles)."""
    if sub:
        if sub % 8 or sub < 8:
            raise ValueError(f"sub must be a multiple of 8 >= 8, got {sub}")
        return sub
    s = default
    while s > 8 and s * LANES > max(nr, 1):
        s //= 2
    return s


# (sz, sy, sx) in the reference generator's loop order (src/matrix.c:71-75)
_OFFSETS_27 = [
    (sz, sy, sx) for sz in (-1, 0, 1) for sy in (-1, 0, 1) for sx in (-1, 0, 1)
]


def _build_arrays(csr: HostCSR, policy: DTypePolicy, sub: int):
    """Vectorized host construction (numpy) of the slab-slice arrays."""
    nr, nc = csr.nr, csr.nc
    lead = sub  # x lead pad rows: slab of a real entry never underflows
    tile_rows = sub * LANES
    n_tiles = max(1, -(-nr // tile_rows))
    n_groups_total = n_tiles * sub
    nb = max(1, -(-nc // LANES))
    x_rows = lead + nb + sub
    nnz = csr.nnz
    if nnz == 0:
        meta_aff = np.full((n_tiles, 1, 2), 0, np.int32)
        meta_aff[:, :, 0] = lead
        vals_aff = np.zeros((n_tiles, 1, sub, LANES), policy.value)
        meta_gen = np.zeros((n_tiles, 0, 1), np.int32)
        vals_gen = np.zeros((n_tiles, 0, sub, LANES), policy.value)
        lidx_gen = np.zeros((n_tiles, 0, sub, LANES), np.int8)
        return (meta_aff, vals_aff, meta_gen, vals_gen, lidx_gen, n_tiles,
                1, 0, x_rows)

    lens = csr.row_lengths
    rows = np.repeat(np.arange(nr, dtype=np.int64), lens)
    col = csr.col.astype(np.int64)
    val = csr.val
    # the occurrence-run logic below requires column-sorted rows; every
    # in-tree ingest path produces them, but guard (an unsorted row would
    # silently collapse same-(row,d) entries onto one slot)
    same_row = rows[1:] == rows[:-1]
    if np.any(same_row & (col[1:] <= col[:-1])):
        order0 = np.lexsort((col, rows))
        col = col[order0]
        val = val[order0]
    g = rows >> 7
    lane = (rows & 127).astype(np.int64)
    b = col >> 7
    lidx = (col & 127).astype(np.int64)
    t = g // sub
    s = g % sub
    dk = b - g + n_groups_total             # shifted block-diagonal >= 0
    ndk = nb + n_groups_total               # dk < ndk

    # occurrence j within each (row, d) run (entries sorted by (row, col)
    # -> d nondecreasing within a row, runs contiguous)
    key_rd = rows * ndk + dk
    is_new = np.empty(nnz, bool)
    is_new[0] = True
    is_new[1:] = key_rd[1:] != key_rd[:-1]
    run_start = np.flatnonzero(is_new)
    run_id = np.cumsum(is_new) - 1
    j = np.arange(nnz, dtype=np.int64) - run_start[run_id]

    # per (tile, d): Lmax over the tile's (row, d) runs
    run_len = np.diff(np.append(run_start, nnz))
    key_td_run = t[run_start] * ndk + dk[run_start]
    order = np.argsort(key_td_run, kind="stable")
    ktd_sorted = key_td_run[order]
    len_sorted = run_len[order]
    td_new = np.empty(ktd_sorted.size, bool)
    td_new[0] = True
    td_new[1:] = ktd_sorted[1:] != ktd_sorted[:-1]
    td_starts = np.flatnonzero(td_new)
    td_keys = ktd_sorted[td_starts]          # ascending (tile, dk)
    lmax_td = np.maximum.reduceat(len_sorted, td_starts)
    td_t = td_keys // ndk
    td_dk = td_keys % ndk

    # global slice ids: slices of (t,d) occupy [gbase_td, gbase_td + lmax)
    csum = np.cumsum(lmax_td)
    gbase_td = csum - lmax_td
    total_slices = int(csum[-1])

    # entry -> slice gid
    key_td_entry = t * ndk + dk
    td_pos = np.searchsorted(td_keys, key_td_entry)
    gid = gbase_td[td_pos] + j

    # per-slice affinity: all entries share one rotation r = (lidx-lane)&127
    re = (lidx - lane) & 127
    re_min = np.full(total_slices, 200, np.int64)
    re_max = np.full(total_slices, -1, np.int64)
    np.minimum.at(re_min, gid, re)
    np.maximum.at(re_max, gid, re)
    affine = re_min == re_max                # every slice has >= 1 entry

    # per-slice attrs (expand (t,d) runs)
    within = np.arange(total_slices, dtype=np.int64) - np.repeat(
        gbase_td, lmax_td
    )
    rep = np.repeat(np.arange(td_keys.size), lmax_td)
    sl_tile = td_t[rep]
    sl_dk = td_dk[rep]
    # dbase in padded x rows; real-entry slices satisfy
    # dbase = b - (g - sub*t) + lead in [b + lead - (sub-1), b + lead]
    # -> [1, nb - 1 + lead] subset of [0, x_rows - sub]
    sl_dbase = (sub * sl_tile + (sl_dk - n_groups_total) + lead).astype(
        np.int64
    )

    # per-tile class partition: affine slices first (ordered by d, j)
    order2 = np.lexsort((within, sl_dk, np.logical_not(affine), sl_tile))
    sorted_tile = sl_tile[order2]
    tile_change = np.empty(total_slices, bool)
    tile_change[0] = True
    tile_change[1:] = sorted_tile[1:] != sorted_tile[:-1]
    tile_first = np.flatnonzero(tile_change)
    pos_sorted = np.arange(total_slices) - np.repeat(
        tile_first, np.diff(np.append(tile_first, total_slices))
    )
    pos = np.empty(total_slices, np.int64)
    pos[order2] = pos_sorted
    n_aff_tile = np.zeros(n_tiles, np.int64)
    np.add.at(n_aff_tile, sl_tile, affine)
    n_all_tile = np.zeros(n_tiles, np.int64)
    np.add.at(n_all_tile, sl_tile, 1)
    pos_cls = np.where(affine, pos, pos - n_aff_tile[sl_tile])
    s_aff = int(n_aff_tile.max())
    s_gen = int((n_all_tile - n_aff_tile).max())

    # allocate + scatter slice metadata (padding slices point at the
    # tile's own lowest slab, so every gather stays in range)
    lo = np.full(n_tiles, x_rows - sub, np.int64)
    np.minimum.at(lo, sl_tile, sl_dbase)
    lo[n_all_tile == 0] = lead
    meta_aff = np.zeros((n_tiles, max(s_aff, 1), 2), np.int32)
    meta_aff[:, :, 0] = lo[:, None]
    meta_gen = np.zeros((n_tiles, s_gen, 1), np.int32)
    if s_gen:
        meta_gen[:, :, 0] = lo[:, None]
    a_sel = affine
    meta_aff[sl_tile[a_sel], pos_cls[a_sel], 0] = sl_dbase[a_sel]
    meta_aff[sl_tile[a_sel], pos_cls[a_sel], 1] = re_min[a_sel]
    g_sel = ~affine
    if s_gen:
        meta_gen[sl_tile[g_sel], pos_cls[g_sel], 0] = sl_dbase[g_sel]
    s_aff = max(s_aff, 1)

    # scatter entries
    vals_aff = np.zeros((n_tiles, s_aff, sub, LANES), policy.value)
    vals_gen = np.zeros((n_tiles, s_gen, sub, LANES), policy.value)
    lidx_gen = np.zeros((n_tiles, s_gen, sub, LANES), np.int8)
    e_aff = affine[gid]
    e_pos = pos_cls[gid]
    v = val.astype(policy.value)
    vals_aff[t[e_aff], e_pos[e_aff], s[e_aff], lane[e_aff]] = v[e_aff]
    if s_gen:
        ge = ~e_aff
        vals_gen[t[ge], e_pos[ge], s[ge], lane[ge]] = v[ge]
        lidx_gen[t[ge], e_pos[ge], s[ge], lane[ge]] = lidx[ge].astype(np.int8)
    return (meta_aff, vals_aff, meta_gen, vals_gen, lidx_gen, n_tiles,
            s_aff, s_gen, x_rows)


@register_format("bslab")
@struct.dataclass
class BslabMatrix:
    meta_aff: jnp.ndarray   # (n_tiles, s_aff, 2) int32 [dbase, r]
    vals_aff: jnp.ndarray   # (n_tiles, s_aff, sub, 128) value dtype
    meta_gen: jnp.ndarray   # (n_tiles, s_gen, 1) int32 dbase
    vals_gen: jnp.ndarray   # (n_tiles, s_gen, sub, 128)
    lidx_gen: jnp.ndarray   # (n_tiles, s_gen, sub, 128) int8
    # WIDE slices: overflow pool with a per-element block delta (dblk int8
    # < wide_k) on top of the lane index. Empty (s_wide == 0) except for
    # quantile-cap builds (formats/rgl_build.py).
    meta_wide: jnp.ndarray  # (n_tiles, s_wide, 1) int32 dbase at dblk == 0
    vals_wide: jnp.ndarray  # (n_tiles, s_wide, sub, 128)
    lidx_wide: jnp.ndarray  # (n_tiles, s_wide, sub, 128) int8
    dblk_wide: jnp.ndarray  # (n_tiles, s_wide, sub, 128) int8
    nr: int = struct.field(pytree_node=False)
    nc: int = struct.field(pytree_node=False)
    nnz: int = struct.field(pytree_node=False)
    n_tiles: int = struct.field(pytree_node=False)
    s_aff: int = struct.field(pytree_node=False)
    s_gen: int = struct.field(pytree_node=False)
    s_wide: int = struct.field(pytree_node=False)
    wide_k: int = struct.field(pytree_node=False)    # dblk range
    sub: int = struct.field(pytree_node=False)       # slice height (groups)
    x_rows: int = struct.field(pytree_node=False)    # padded x rows
    n_elems: int = struct.field(pytree_node=False)
    start_row: int = struct.field(pytree_node=False, default=0)
    total_nr: int = struct.field(pytree_node=False, default=0)
    total_nnz: int = struct.field(pytree_node=False, default=0)

    @staticmethod
    def empty_wide(n_tiles: int, sub: int, store_dt):
        """Zero-size wide-class arrays (the common no-overflow case)."""
        return dict(
            meta_wide=jnp.zeros((n_tiles, 0, 1), jnp.int32),
            vals_wide=jnp.zeros((n_tiles, 0, sub, LANES), store_dt),
            lidx_wide=jnp.zeros((n_tiles, 0, sub, LANES), jnp.int8),
            dblk_wide=jnp.zeros((n_tiles, 0, sub, LANES), jnp.int8),
        )

    @property
    def lead(self) -> int:
        return self.sub

    # ------------------------------------------------------------- builders
    @classmethod
    def from_csr(
        cls,
        csr: HostCSR,
        policy: Optional[DTypePolicy] = None,
        *,
        compress: bool = True,
        sub: int = 0,
        min_s_aff: int = 0,
        min_s_gen: int = 0,
        **_opts,
    ) -> "BslabMatrix":
        policy = default_policy(policy)
        sub = _auto_sub(csr.nr, sub)
        (meta_aff, vals_aff, meta_gen, vals_gen, lidx_gen, n_tiles,
         s_aff, s_gen, x_rows) = _build_arrays(csr, policy, sub)
        if compress and vals_aff.dtype == np.float32:
            import ml_dtypes

            ok = True
            for a in (vals_aff, vals_gen):
                bf = a.astype(ml_dtypes.bfloat16)
                ok = ok and np.array_equal(bf.astype(np.float32), a)
            if ok:
                vals_aff = vals_aff.astype(ml_dtypes.bfloat16)
                vals_gen = vals_gen.astype(ml_dtypes.bfloat16)
        if min_s_aff > s_aff:
            pad = min_s_aff - s_aff
            vals_aff = np.pad(vals_aff, ((0, 0), (0, pad), (0, 0), (0, 0)))
            m = np.zeros((n_tiles, pad, 2), np.int32)
            m[:, :, 0] = meta_aff[:, :1, 0]
            meta_aff = np.concatenate([meta_aff, m], axis=1)
            s_aff = min_s_aff
        if min_s_gen > s_gen:
            pad = min_s_gen - s_gen
            vals_gen = np.pad(vals_gen, ((0, 0), (0, pad), (0, 0), (0, 0)))
            lidx_gen = np.pad(lidx_gen, ((0, 0), (0, pad), (0, 0), (0, 0)))
            m = np.zeros((n_tiles, pad, 1), np.int32)
            m[:, :, 0] = meta_aff[:, :1, 0]
            meta_gen = np.concatenate([meta_gen, m], axis=1)
            s_gen = min_s_gen
        return cls(
            meta_aff=jnp.asarray(meta_aff),
            vals_aff=jnp.asarray(vals_aff),
            meta_gen=jnp.asarray(meta_gen),
            vals_gen=jnp.asarray(vals_gen),
            lidx_gen=jnp.asarray(lidx_gen),
            **cls.empty_wide(n_tiles, sub, vals_aff.dtype),
            nr=csr.nr, nc=csr.nc, nnz=csr.nnz,
            n_tiles=n_tiles, s_aff=s_aff, s_gen=s_gen, s_wide=0, wide_k=1,
            sub=sub, x_rows=x_rows,
            n_elems=n_tiles * (s_aff + s_gen) * sub * LANES,
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
        use_7pt: bool = False,
        policy: Optional[DTypePolicy] = None,
        compress: bool = True,
        sub: int = 0,
    ) -> Tuple["BslabMatrix", jnp.ndarray]:
        """Analytic ON-DEVICE build of the 27/7-pt stencil (reference
        src/matrix.c:30-121) in slab layout: every slice is the A or B
        part of one diagonal — all affine, no index planes at all.
        Single-shard only (the distributed layer partitions CSR shards)."""
        policy = default_policy(policy)
        nr = nx * ny * nz
        sub = _auto_sub(nr, sub)
        lead = sub
        plane = nx * ny
        specs = sorted(
            (sz * plane + sy * nx + sx, sz, sy, sx)
            for (sz, sy, sx) in _OFFSETS_27
            if not use_7pt or (sz * sz + sy * sy + sx * sx <= 1)
        )
        if len({sp[0] for sp in specs}) != len(specs):
            from sparsebench.host.generator import generate_stencil

            csr = generate_stencil(nx, ny, nz, use_7pt=use_7pt,
                                   dtype=policy.value)
            obj = cls.from_csr(csr, policy, compress=compress, sub=sub)
            return obj, jnp.asarray(csr.row_lengths)

        # slice plan: (off, sz, sy, sx, d, r, part) — part B when the
        # lane shift wraps into the next block
        slices = []
        for off, sz, sy, sx in specs:
            q, r = divmod(off, LANES)
            slices.append((off, sz, sy, sx, q, r, 0))
            if r != 0:
                slices.append((off, sz, sy, sx, q + 1, r, 1))
        s_aff = len(slices)
        tile_rows = sub * LANES
        n_tiles = max(1, -(-nr // tile_rows))
        nb = max(1, -(-nr // LANES))
        x_rows = lead + nb + sub
        d_arr = np.asarray([sp[4] for sp in slices], np.int64)
        r_arr = np.asarray([sp[5] for sp in slices], np.int64)
        t_np = np.arange(n_tiles, dtype=np.int64)
        dbase = np.clip(
            sub * t_np[:, None] + d_arr[None, :] + lead, 0, x_rows - sub
        )
        meta_aff = np.stack(
            [dbase, np.broadcast_to(r_arr[None, :], dbase.shape)], axis=2
        ).astype(np.int32)

        use_bf16 = compress and np.dtype(policy.value) == np.float32
        if use_bf16:
            import ml_dtypes

            store_dt = jnp.dtype(ml_dtypes.bfloat16)
        else:
            store_dt = jnp.dtype(policy.value)
        vals_aff, counts = _stencil_vals_device(
            tuple((sp[0], sp[1], sp[2], sp[3], sp[5], sp[6]) for sp in slices),
            nx, ny, nr, n_tiles, sub, store_dt,
        )
        counts = counts[:nr]
        nnz = int(counts.sum())
        obj = cls(
            meta_aff=jnp.asarray(meta_aff),
            vals_aff=vals_aff,
            meta_gen=jnp.zeros((n_tiles, 0, 1), jnp.int32),
            vals_gen=jnp.zeros((n_tiles, 0, sub, LANES), store_dt),
            lidx_gen=jnp.zeros((n_tiles, 0, sub, LANES), jnp.int8),
            **cls.empty_wide(n_tiles, sub, store_dt),
            nr=nr, nc=nr, nnz=nnz,
            n_tiles=n_tiles, s_aff=s_aff, s_gen=0, s_wide=0, wide_k=1,
            sub=sub, x_rows=x_rows,
            n_elems=n_tiles * s_aff * sub * LANES,
            start_row=0, total_nr=nr, total_nnz=nnz,
        )
        return obj, counts

    # ---------------------------------------------------------------- spmv
    def spmv(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A @ x: per slice class, gather the (sub,128) x table from
        its slab (affine: rotated lanes; general: stored lane indices;
        wide: lane indices plus a block delta), multiply, and sum over the
        tile's slices."""
        lead_el = self.lead * LANES
        xp = jnp.zeros(self.x_rows * LANES, x.dtype)
        xp = xp.at[lead_el : lead_el + x.shape[0]].set(x)
        lanes = jnp.arange(LANES, dtype=jnp.int32)
        subs = jnp.arange(self.sub, dtype=jnp.int32)
        acc = jnp.zeros((self.n_tiles, self.sub, LANES), x.dtype)
        if self.s_aff:
            dbase = self.meta_aff[:, :, 0].astype(jnp.int32)
            r = self.meta_aff[:, :, 1].astype(jnp.int32)
            rowp = dbase[:, :, None] + subs[None, None, :]
            idx = (lanes[None, None, None, :] + r[:, :, None, None]) & (
                LANES - 1
            )
            gcol = rowp[:, :, :, None] * LANES + idx
            g = take(xp, gcol.reshape(-1)).reshape(gcol.shape)
            acc = acc + (self.vals_aff.astype(x.dtype) * g).sum(axis=1)
        if self.s_gen:
            dbase = self.meta_gen[:, :, 0].astype(jnp.int32)
            rowp = dbase[:, :, None] + subs[None, None, :]
            gcol = rowp[:, :, :, None] * LANES + self.lidx_gen.astype(
                jnp.int32
            )
            g = take(xp, gcol.reshape(-1)).reshape(gcol.shape)
            acc = acc + (self.vals_gen.astype(x.dtype) * g).sum(axis=1)
        if self.s_wide:
            dbase = self.meta_wide[:, :, 0].astype(jnp.int32)
            rowp = (dbase[:, :, None] + subs[None, None, :])[:, :, :, None]
            rowp = rowp + self.dblk_wide.astype(jnp.int32)
            gcol = rowp * LANES + self.lidx_wide.astype(jnp.int32)
            g = take(xp, gcol.reshape(-1)).reshape(gcol.shape)
            acc = acc + (self.vals_wide.astype(x.dtype) * g).sum(axis=1)
        return acc.reshape(-1)[: self.nr]

    # ------------------------------------------------------------ protocol
    @property
    def permuted_output(self) -> bool:
        return False

    def permute_vector(self, v: jnp.ndarray) -> jnp.ndarray:
        return v

    def unpermute_vector(self, v: jnp.ndarray) -> jnp.ndarray:
        return v

    @property
    def padding_ratio(self) -> float:
        return self.n_elems / max(self.nnz, 1)


@functools.partial(
    jax.jit,
    static_argnames=("slices", "nx", "ny", "local_nrow", "n_tiles", "sub",
                     "store_dt"),
)
def _stencil_vals_device(slices, nx, ny, local_nrow, n_tiles, sub, store_dt):
    """Device-side value planes for the stencil slab build: per slice
    (diagonal part) the values are a constant under vectorized bound
    checks on iota grid coordinates (cf. formats/dia.py
    _stencil_dia_device). Two levels of batching keep both compile time
    and dispatch overhead bounded: tiles process in 16-tile blocks under
    ``lax.map`` (a fully unrolled whole-matrix build compiles for tens of
    seconds at 200^3; one-tile steps multiply the dispatches), and the
    slice axis is a broadcast dimension instead of a 53-expression python
    loop."""
    R = sub * LANES
    blk = min(16, n_tiles)
    nblk = -(-n_tiles // blk)  # build nblk*blk tiles, slice the excess off
    BR = blk * R
    S = len(slices)
    off_a = jnp.asarray([sp[0] for sp in slices], jnp.int32)[:, None]
    sz_a = jnp.asarray([sp[1] for sp in slices], jnp.int32)[:, None]
    sy_a = jnp.asarray([sp[2] for sp in slices], jnp.int32)[:, None]
    sx_a = jnp.asarray([sp[3] for sp in slices], jnp.int32)[:, None]
    r_a = jnp.asarray([sp[4] for sp in slices], jnp.int32)[:, None]
    isb_a = jnp.asarray([sp[5] for sp in slices], bool)[:, None]
    del sz_a  # z bounds are captured by the col range check
    v_a = jnp.where(off_a == 0, jnp.float32(27.0), jnp.float32(-1.0))

    def block_fn(tb):
        i = (tb * BR + jax.lax.iota(jnp.int32, BR))[None, :]
        ix = i % nx
        iy = (i // nx) % ny
        valid = i < local_nrow
        lane = i % LANES
        col = i + off_a
        m = (
            valid
            & (ix + sx_a >= 0) & (ix + sx_a < nx)
            & (iy + sy_a >= 0) & (iy + sy_a < ny)
            & (col >= 0) & (col < local_nrow)
        )                                        # (S, BR)
        counts = (m & ~isb_a).sum(axis=0).astype(jnp.int32)
        wrap = lane + r_a >= LANES
        sel = jnp.where(isb_a, wrap, ~wrap)
        planes = jnp.where(m & sel, v_a, 0.0).astype(store_dt)
        # (S, blk, sub, L) -> (blk, S, sub, L)
        return planes.reshape(S, blk, sub, LANES).swapaxes(0, 1), counts

    vals, counts = jax.lax.map(
        block_fn, jnp.arange(nblk, dtype=jnp.int32)
    )
    # excess tiles (rows >= local_nrow) are fully masked -> zero planes
    return (vals.reshape(nblk * blk, S, sub, LANES)[:n_tiles],
            counts.reshape(-1)[: n_tiles * R])
