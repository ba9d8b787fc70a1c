"""Device-side builder: RGL (random-graph Laplacian) -> BslabMatrix.

A >=10^7-nnz irregular matrix would spend its set-up in a host build and
upload, so it is generated and laid out entirely ON DEVICE from the
(n, band, deg, seed) spec in host/rgl.py:

  * per tile of ``sub``*128 rows, the (rows x offsets) edge mask is pure
    u32 hash arithmetic on iota grids (no scatter, no gather);
  * the BSLAB slice layout uses STATIC per-block-diagonal capacity caps
    measured EXACTLY by a cheap phase-1 device pass (global max of the
    per-(row, d) entry count — a handful of scalars read back), so every
    slice plane in phase 2 has a static position;
  * a block-diagonal bucket d only involves offsets in the 255-wide
    window [128d-127, 128d+127] (the bucket of an entry is
    ((row mod 128) + off) >> 7), so all per-bucket work runs on (rows,
    <=255) windows instead of the full (rows, 2*band+1) grid — ~4x less
    traffic and a much smaller HLO graph than the full-width build;
  * the per-bucket plane extraction is ONE one-hot contraction
    (einsum over the window axis against one_hot(rank)) instead of
    cap-many masked reductions — rank k's entry has within-(row, d)
    cumulative count k+1, so the contraction reproduces the exact
    layout of the k-loop formulation, in a fraction of the graph;
  * a device-side overflow check cross-validates the two phases.

All slices are general (stored int8 lane indices) — the matrix is
irregular by design. Values are -1 / degree+1 <= 255, exactly
representable in bf16, so compression (and the bf16 one-hot
contraction) is lossless by construction; the one-hot contractions
are exact too (bf16 operands are integers <= 255, accumulated in f32).
"""

from __future__ import annotations

import functools
import os
import time
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sparsebench.config import DTypePolicy
from sparsebench.formats.base import default_policy
from sparsebench.formats.bslab import LANES, BslabMatrix
from sparsebench.host.rgl import threshold


def _bucket_window(band: int, d: int) -> Tuple[int, int]:
    """Static offset window of block-diagonal bucket d: an entry at
    (row, row+off) lands in bucket ((row mod 128) + off) >> 7, so bucket
    d only sees off in [128d-127, 128d+127] (clipped to the band)."""
    return (max(-band, LANES * d - (LANES - 1)),
            min(band, LANES * d + (LANES - 1)))


def _hash_finish(h, seed, thresh):
    h = h + jnp.uint32(seed) * jnp.uint32(0xC2B2AE3D)
    h = h ^ (h >> 15)
    h = h * jnp.uint32(0x2C1B3C6D)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0x297A2D39)
    h = h ^ (h >> 16)
    return h < jnp.uint32(thresh)


def _bucket_masks(t, n, band, sub, d, thresh, seed):
    """Per-tile masks for ONE bucket, on its static offset window.

    Returns (i, offs, md, me): md = stored entries of bucket d
    (edges + the diagonal when d == 0), me = edges only (for degree)."""
    R = sub * LANES
    w_lo, w_hi = _bucket_window(band, d)
    i = t * R + jnp.arange(R, dtype=jnp.int32)
    offs = jnp.arange(w_lo, w_hi + 1, dtype=jnp.int32)
    j = i[:, None] + offs[None, :]
    row_ok = i < n
    inb = (j >= 0) & (j < n) & (offs[None, :] != 0) & row_ok[:, None]
    lo = jnp.minimum(i[:, None], j)
    hi = jnp.maximum(i[:, None], j)
    h = (
        jnp.maximum(lo, 0).astype(jnp.uint32) * jnp.uint32(0x9E3779B1)
        + jnp.maximum(hi, 0).astype(jnp.uint32) * jnp.uint32(0x85EBCA77)
    )
    in_bucket = (((i[:, None] & (LANES - 1)) + offs[None, :]) >> 7) == d
    me = inb & _hash_finish(h, seed, thresh) & in_bucket
    md = me
    if w_lo <= 0 <= w_hi:  # the diagonal lands in bucket 0's window
        md = md | ((offs[None, :] == 0) & row_ok[:, None] & in_bucket)
    return i, offs, md, me


_HIST_CAP = 48  # per-(row, d) counts beyond this are off-distribution


@functools.partial(
    jax.jit,
    static_argnames=("n", "band", "sub", "n_tiles", "nD", "d_min",
                     "thresh", "seed"),
)
def _probe_hist(n, band, sub, n_tiles, nD, d_min, thresh, seed):
    """Phase 1a: per-bucket histogram of the per-(row, d) entry counts
    over all rows — (nD, _HIST_CAP) ints read back. Subsumes the r3 max
    probe (cap_max = last nonzero bin) and gives the quantile caps the
    overflow-pool layout needs."""

    def tile_fn(t):
        hists = []
        for bi in range(nD):
            i, _, md, _ = _bucket_masks(
                t, n, band, sub, d_min + bi, thresh, seed
            )
            cnt = md.sum(axis=1)
            # exclude phantom rows (>= n) from the c == 0 bin
            oh = jax.nn.one_hot(
                jnp.where(i < n, jnp.minimum(cnt, _HIST_CAP - 1), -1),
                _HIST_CAP, dtype=jnp.float32,
            )
            hists.append(oh.sum(axis=0).astype(jnp.int32))
        return jnp.stack(hists)

    per_tile = jax.lax.map(tile_fn, jnp.arange(n_tiles, dtype=jnp.int32))
    return per_tile.sum(axis=0)


@functools.partial(
    jax.jit,
    static_argnames=("n", "band", "sub", "n_tiles", "nD", "d_min",
                     "thresh", "seed", "span"),
)
def _probe_overflow(q, n, band, sub, n_tiles, nD, d_min, thresh, seed,
                    span=None):
    """Phase 1b: for a BATCH of candidate caps q ((nC, nD) int32, dynamic
    — one compile + one execution covers every candidate), the exact
    per-GROUP wide-pool capacities (max over rows of the group's total
    overflow; groups are runs of ``span`` consecutive buckets, one group
    spanning everything when span is None) and the total overflow entry
    count, per candidate: ((nC, G) int32, (nC,) int32)."""
    span = nD if span is None else span
    nG = -(-nD // span)

    def tile_fn(t):
        over = jnp.zeros((q.shape[0], nG, sub * LANES), jnp.int32)
        for bi in range(nD):
            _, _, md, _ = _bucket_masks(
                t, n, band, sub, d_min + bi, thresh, seed
            )
            # int32 explicitly: under x64 the bool-sum promotes to int64
            # and the .at[].add scatter into the int32 accumulator is a
            # FutureWarning (error in future jax).
            cnt = md.sum(axis=1, dtype=jnp.int32)
            over = over.at[:, bi // span, :].add(
                jnp.maximum(cnt[None, :] - q[:, bi, None], 0)
            )
        return over.max(axis=2), over.sum(axis=(1, 2))

    caps, tots = jax.lax.map(
        tile_fn, jnp.arange(n_tiles, dtype=jnp.int32)
    )
    return caps.max(axis=0), tots.sum(axis=0)


@functools.partial(
    jax.jit,
    static_argnames=("n", "band", "sub", "n_tiles", "caps", "wcaps",
                     "span", "d_min", "thresh", "seed", "store_dt"),
)
def _build_device(n, band, sub, n_tiles, caps, wcaps, span, d_min, thresh,
                  seed, store_dt):
    """Phase 2. With wcaps == () this is the r3 exact-cap layout; with
    overflow pools the caps are quantiles and each row's overflow (rank
    >= cap_d, in ascending-d order) lands in the wide pool of its
    bucket's GROUP (groups = runs of ``span`` buckets; pool g holds
    dblk = bi - g*span in [0, span)). one_hot of an out-of-range rank
    is a zero row, so the split is pure arithmetic."""
    nD = len(caps)
    R = sub * LANES
    s_wide = int(sum(wcaps))
    # pool g's slices occupy positions [wbase[g], wbase[g] + wcaps[g])
    wbase = [0]
    for c in wcaps:
        wbase.append(wbase[-1] + c)

    def tile_fn(t):
        per_bucket = [
            _bucket_masks(t, n, band, sub, d_min + bi, thresh, seed)
            for bi in range(nD)
        ]
        # buckets partition the edges, so the row degree is the sum of
        # the per-bucket edge counts
        degree = functools.reduce(
            jnp.add, [me.sum(axis=1) for (_, _, _, me) in per_bucket]
        ).astype(jnp.float32)

        v_chunks, l_chunks = [], []
        overflow = jnp.asarray(False)
        nnz_t = jnp.asarray(0, jnp.int32)
        woff = jnp.zeros(R, jnp.int32)
        wval = jnp.zeros((R, max(s_wide, 1)), jnp.float32)
        wlid = jnp.zeros((R, max(s_wide, 1)), jnp.float32)
        wdbl = jnp.zeros((R, max(s_wide, 1)), jnp.float32)
        for bi, (i, offs, md, _) in enumerate(per_bucket):
            cap = caps[bi]
            nnz_t = nnz_t + md.sum()
            cnt = jnp.cumsum(md, axis=1)
            # rank of each stored entry within (row, bucket); -1 (one_hot
            # -> all-zero row) elsewhere; ranks >= cap are overflow and
            # also one_hot to zero here
            rank = jnp.where(md, cnt - 1, -1)
            oh = jax.nn.one_hot(rank, cap, dtype=jnp.bfloat16)
            val = jnp.where(
                offs[None, :] == 0, degree[:, None] + 1.0, -1.0
            ).astype(jnp.bfloat16)
            lidx = ((i[:, None] + offs[None, :]) & (LANES - 1)).astype(
                jnp.bfloat16
            )
            # (R, w) x (R, w, cap) -> (R, cap): exact — one nonzero
            # one-hot term per (row, k), operands integral and <= 255
            planes = jnp.einsum(
                "rw,rwk->rk", val, oh,
                preferred_element_type=jnp.float32,
            )
            lplanes = jnp.einsum(
                "rw,rwk->rk", lidx, oh,
                preferred_element_type=jnp.float32,
            )
            v_chunks.append(
                planes.T.reshape(cap, sub, LANES).astype(store_dt)
            )
            l_chunks.append(
                lplanes.T.reshape(cap, sub, LANES).astype(jnp.int8)
            )
            if s_wide:
                g = bi // span
                if bi % span == 0:
                    woff = jnp.zeros(R, jnp.int32)  # fresh pool per group
                mo = md & (rank >= cap)
                # rank within pool g; pool capacity check BEFORE the
                # global one_hot position (a pool overrun must not
                # silently land in the next pool's slices)
                wlocal = woff[:, None] + rank - cap
                overflow = overflow | jnp.any(mo & (wlocal >= wcaps[g]))
                wrank = jnp.where(mo, wbase[g] + wlocal, -1)
                ohw = jax.nn.one_hot(wrank, s_wide, dtype=jnp.bfloat16)
                wval = wval + jnp.einsum(
                    "rw,rwk->rk", val, ohw,
                    preferred_element_type=jnp.float32,
                )
                wlid = wlid + jnp.einsum(
                    "rw,rwk->rk", lidx, ohw,
                    preferred_element_type=jnp.float32,
                )
                wdbl = wdbl + float(bi - g * span) * jnp.einsum(
                    "rwk->rk", ohw, preferred_element_type=jnp.float32,
                )
                woff = woff + jnp.maximum(cnt[:, -1] - cap, 0)
            else:
                overflow = overflow | jnp.any(md & (cnt > cap))
        vals = jnp.concatenate(v_chunks)     # (s_gen, sub, 128)
        lidx = jnp.concatenate(l_chunks)
        wv = wval.T.reshape(max(s_wide, 1), sub, LANES).astype(store_dt)
        wl = wlid.T.reshape(max(s_wide, 1), sub, LANES).astype(jnp.int8)
        wd = wdbl.T.reshape(max(s_wide, 1), sub, LANES).astype(jnp.int8)
        return vals, lidx, wv[:s_wide], wl[:s_wide], wd[:s_wide], nnz_t, \
            overflow

    vals, lidx, wv, wl, wd, nnz_t, over = jax.lax.map(
        tile_fn, jnp.arange(n_tiles, dtype=jnp.int32)
    )
    return vals, lidx, wv, wl, wd, nnz_t.sum(), over.any()


def _layout_bytes(s_gen: int, s_wide: int, vb: float) -> float:
    """Stored bytes per row of a layout: value + int8 lane index per
    general slice element, plus the int8 block delta per wide one. SpMV
    streams every stored byte once, so this is its device-memory cost."""
    return (vb + 1) * s_gen + (vb + 2) * s_wide


def _choose_caps(hist: np.ndarray, n: int, caps_max, probe, vb: float,
                 nD: int, mark) -> Tuple[tuple, tuple, int]:
    """Pick per-bucket quantile caps + per-group wide-pool capacities +
    pool span minimizing the stored bytes (_layout_bytes). Candidates sweep a
    per-(row, bucket) tail probability alpha crossed with the pool span;
    the exact per-group capacities for ALL alpha candidates of one span
    come from one batched device probe (one compile + execution per
    span). Returns (caps, wcaps, span)."""
    cands = [tuple(caps_max)]
    for alpha in (0.0003, 0.001, 0.003, 0.01, 0.03, 0.1):
        caps_a = []
        for d in range(nD):
            rows_gt = hist[d][::-1].cumsum()[::-1]  # rows with cnt >= c
            # smallest q with #rows(cnt > q) = rows_gt[q+1] <= alpha*n,
            # i.e. keep lowering while rows_gt[q] <= alpha*n
            q = caps_max[d]
            while q > 1 and rows_gt[q] <= alpha * n:
                q -= 1
            caps_a.append(max(q, 1))
        t = tuple(caps_a)
        if t not in cands:
            cands.append(t)
    best = (tuple(caps_max), (), nD)
    best_cost = _layout_bytes(sum(caps_max), 0, vb)
    if len(cands) > 1:
        q = np.asarray(cands[1:], np.int32)
        for span in sorted({2, 3, nD} - {1}):
            w_caps, _tots = probe(q, span)
            for t, wc in zip(cands[1:], np.asarray(w_caps)):
                wc = tuple(int(w) for w in wc)
                cost = _layout_bytes(sum(t), sum(wc), vb)
                if cost < best_cost:
                    best, best_cost = (t, wc, span), cost
    mark(f"cap selection ({len(cands)} alphas x 3 spans)")
    return best


def rgl_bslab(
    n: int,
    band: int = 512,
    deg: float = 16.0,
    seed: int = 1,
    *,
    policy: Optional[DTypePolicy] = None,
    sub: int = 64,
    tail: bool = True,
    force_caps: Optional[tuple] = None,
    force_span: int = 0,
) -> Tuple[BslabMatrix, int]:
    """Build the RGL matrix directly as a device BslabMatrix.

    Returns (matrix, nnz). b = A @ 1 == ones with exact solution x == 1
    (host/rgl.py), so callers need no row-count vector.

    ``tail=True`` (default) considers quantile per-bucket caps with the
    overflow in WIDE slices and keeps the layout with the fewest stored
    bytes (at n=2M/band=512/deg=16 it cuts the padding from 6.32x to
    2.54x). ``tail=False`` forces the exact-cap layout outright.
    """
    policy = default_policy(policy)
    if band < 1 or band >= n:
        raise ValueError(f"band must be in [1, n); got {band} for n={n}")
    prof = os.environ.get("SB_RGL_PROF")
    t_last = time.perf_counter()

    def mark(label):
        nonlocal t_last
        if prof:
            now = time.perf_counter()
            print(f"[rgl] {label}: {now - t_last:.1f}s", flush=True)
            t_last = now

    lead = sub
    R = sub * LANES
    n_tiles = max(1, -(-n // R))
    nb = max(1, -(-n // LANES))
    d_min = -((band + LANES - 1) // LANES)
    d_max = (LANES - 1 + band) // LANES
    nD = d_max - d_min + 1
    thresh = int(threshold(band, deg))
    store_dt = (
        jnp.dtype(jnp.bfloat16)
        if np.dtype(policy.value) == np.float32
        else jnp.dtype(policy.value)
    )
    vb = jnp.dtype(store_dt).itemsize

    # phase 1a: per-bucket count histograms (subsume the max probe)
    hist = np.asarray(
        _probe_hist(n, band, sub, n_tiles, nD, d_min, thresh, seed)
    )
    if hist[:, -1].any():
        raise ValueError(
            f"per-(row, d) entry counts reached the histogram clamp "
            f"({_HIST_CAP - 1}); this deg/band combination is outside the "
            f"layout's design range — raise rgl_build._HIST_CAP"
        )
    caps_max = [
        max(1, int(np.nonzero(hist[d])[0].max()) if hist[d].any() else 1)
        for d in range(nD)
    ]
    mark("phase1 histogram probe (compile+exec)")
    # the wide dbase (group anchor blocks) must not underflow the lead pad
    if force_caps is not None:
        # test hook: explicit caps (+ span), exact pool capacities from
        # the probe
        if lead + d_min < 0:
            raise ValueError(
                f"wide slices need sub >= {-d_min} (lead pad underflow)"
            )
        caps = tuple(int(c) for c in force_caps)
        span = force_span if force_span else nD
        wcaps = tuple(
            int(w) for w in np.asarray(_probe_overflow(
                jnp.asarray([caps], jnp.int32), n, band, sub,
                n_tiles, nD, d_min, thresh, seed, span=span,
            )[0])[0]
        )
    elif tail and lead + d_min >= 0:
        caps, wcaps, span = _choose_caps(
            hist, n, caps_max,
            lambda q, sp: _probe_overflow(jnp.asarray(q), n, band, sub,
                                          n_tiles, nD, d_min, thresh,
                                          seed, span=sp),
            vb, nD, mark,
        )
    else:
        caps, wcaps, span = tuple(caps_max), (), nD
    s_gen = int(sum(caps))
    s_wide = int(sum(wcaps))

    vals, lidx, wv, wl, wd, nnz_dev, over = _build_device(
        n, band, sub, n_tiles, caps, wcaps, span, d_min, thresh, seed,
        store_dt,
    )
    if bool(over):
        raise SystemExit(
            f"RGL build overflowed the probed slice caps {caps} "
            f"(pools {wcaps}, span {span}) for seed={seed} — "
            "phase-1/phase-2 disagreement (bug)"
        )
    nnz = int(nnz_dev)
    mark("phase2 build (compile+exec)")

    # slice metadata: bucket bi (d = d_min + bi) occupies static positions
    # [sum(caps[:bi]), sum(caps[:bi+1])); dbase = sub*t + d + lead.
    # Wide pool g anchors at block d_min + g*span (its dblk indexes
    # upward through span blocks), so x must cover span - 1 blocks above
    # the last anchor's slab.
    wide_ext = (span - 1) if s_wide else 0
    anchors = [d_min + g * span for g, c in enumerate(wcaps) if c]
    top_anchor = max(anchors) if anchors else 0
    # coverage above the last gen block the tallest pool slab needs
    extra = max(0, top_anchor + wide_ext - (d_min + nD - 1)) if s_wide \
        else 0
    x_rows = lead + nb + sub + extra
    pos_d = np.concatenate(
        [np.full(c, d_min + bi, np.int64) for bi, c in enumerate(caps)]
    )
    t_np = np.arange(n_tiles, dtype=np.int64)
    dbase = np.clip(
        sub * t_np[:, None] + pos_d[None, :] + lead, 0, x_rows - sub
    )
    meta_gen = dbase.astype(np.int32)[:, :, None]
    if s_wide:
        # per-slice anchors: pool g's slices all carry its anchor block
        pos_w = np.concatenate([
            np.full(c, a, np.int64)
            for a, c in zip(anchors, [c for c in wcaps if c])
        ])
        dbase_w = sub * t_np[:, None] + pos_w[None, :] + lead  # >= 0
        meta_wide = dbase_w.astype(np.int32)[:, :, None]
    else:
        meta_wide = np.zeros((n_tiles, 0, 1), np.int32)

    mark("host metadata")
    obj = BslabMatrix(
        meta_aff=jnp.zeros((n_tiles, 0, 2), jnp.int32),
        vals_aff=jnp.zeros((n_tiles, 0, sub, LANES), store_dt),
        meta_gen=jnp.asarray(meta_gen),
        vals_gen=vals,
        lidx_gen=lidx,
        meta_wide=jnp.asarray(meta_wide),
        vals_wide=wv,
        lidx_wide=wl,
        dblk_wide=wd,
        nr=n, nc=n, nnz=nnz,
        n_tiles=n_tiles, s_aff=0, s_gen=s_gen, s_wide=s_wide,
        wide_k=span if s_wide else 1, sub=sub, x_rows=x_rows,
        n_elems=n_tiles * (s_gen + s_wide) * sub * LANES,
        start_row=0, total_nr=n, total_nnz=nnz,
    )
    mark("pytree assembly + transfers")
    return obj, nnz
