"""Distributed (mesh-sharded) matrix build and solver drivers.

This is the reference's MPI SPMD layer (src/comm.c + the solve call tree,
SURVEY §3.1) rebuilt on ``jax.shard_map`` over a 1-D device mesh:

  * every shard's renumbered local matrix (from
    :func:`sparsebench.parallel.partition.partition`) is lowered to the
    chosen device format, padded to uniform shapes, and stacked along a
    leading shard axis that is sharded over the mesh;
  * the *same* ``cg_loop`` / ``cheby_loop`` used on a single device runs
    inside shard_map, with ``exchange`` bound to ppermute/all_gather and
    ``allsum`` to psum — per CG iteration exactly 2 scalar psums + 1 halo
    exchange, the reference's collective structure (comm.c:627-662);
  * the whole distributed solve is ONE jitted program: XLA overlaps the
    halo collective with local compute where the schedule allows, something
    the reference's blocking MPI_Neighbor_alltoallv cannot do.

Row-permuting formats permute per shard; the send-index arrays are
composed with each shard's permutation at plan time (the reference's
SCS-under-MPI path forgets this and is broken, SURVEY §2.8).
"""

from __future__ import annotations

import time
from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from sparsebench.config import DTypePolicy
from sparsebench.formats import get_format
from sparsebench.host.csr import HostCSR
from sparsebench.parallel.exchange import make_allsum, make_exchange
from sparsebench.parallel.partition import Partitioned, partition
from sparsebench.solvers.cg import CGResult, print_residual_history

AXIS = "shards"


def make_mesh(n: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()[:n]
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return jax.make_mesh((n,), (AXIS,), devices=np.asarray(devices))


def _pad_stack_leaves(objs):
    """Stack format pytrees along a new leading shard axis, zero-padding
    each leaf to the elementwise-max shape. Zero padding is value-safe for
    every format (padded val entries are 0 and contribute nothing)."""
    flats = [jax.tree_util.tree_flatten(o) for o in objs]
    treedef = flats[0][1]
    for _, td in flats[1:]:
        if td != treedef:
            raise ValueError(
                "shard format objects have mismatched structure; "
                "normalize static fields before stacking"
            )
    stacked = []
    for leaves in zip(*(f[0] for f in flats)):
        shapes = np.asarray([l.shape for l in leaves])
        target = shapes.max(axis=0)
        padded = [
            np.pad(np.asarray(l), [(0, t - s) for s, t in zip(l.shape, target)])
            for l in leaves
        ]
        stacked.append(jnp.asarray(np.stack(padded)))
    return jax.tree_util.tree_unflatten(treedef, stacked)


def _normalize_statics(obj, part: Partitioned):
    """Equalize per-shard static metadata so pytree structures match.

    Runs AFTER the shard_meta snapshot in DistMatrix.__init__, so
    per-shard truth (nnz, padding_ratio) is recorded before the zeroing
    (split formats normalize their nested interior/boundary here too)."""
    if hasattr(obj, "interior"):
        obj = obj.replace(
            interior=obj.interior.replace(nnz=0, start_row=0),
            boundary=obj.boundary.replace(nnz=0, start_row=0),
        )
    return obj.replace(
        nnz=part.total_nnz,
        start_row=0,
        total_nr=part.total_nr,
        total_nnz=part.total_nnz,
    )


def _boundary_pad(part: Partitioned) -> int:
    """One padded length for the split formats' CRS boundary blocks, so
    the shards stack without reordering their sentinel entries."""
    from sparsebench.formats.dia_split import split_interior_boundary

    return max(split_interior_boundary(s)[1].nnz for s in part.shards)


def _build_bslab_split(part: Partitioned, policy):
    """Per-shard BslabSplitMatrix builds with cross-shard-unified statics
    (slice counts, boundary length) so the stacked pytrees share one
    treedef. The interior product reads only local columns, so the halo
    exchange can overlap it instead of blocking it."""
    from sparsebench.formats.dia_split import BslabSplitMatrix

    nnz_pad = _boundary_pad(part)
    probe = [
        BslabSplitMatrix.from_csr(s, policy, nnz_pad=nnz_pad)
        for s in part.shards
    ]
    sub = probe[0].interior.sub
    s_aff = max(o.interior.s_aff for o in probe)
    s_gen = max(o.interior.s_gen for o in probe)
    x_rows = max(o.interior.x_rows for o in probe)
    objs = [
        o
        if (o.interior.s_aff, o.interior.s_gen, o.interior.sub) == (
            s_aff, s_gen, sub)
        else BslabSplitMatrix.from_csr(
            s, policy, sub=sub, min_s_aff=s_aff, min_s_gen=s_gen,
            nnz_pad=nnz_pad)
        for o, s in zip(probe, part.shards)
    ]
    # x_rows only pads x further, so it lifts by replace
    return [o.replace(interior=o.interior.replace(x_rows=x_rows))
            for o in objs]


class DistMatrix:
    """Mesh-sharded matrix: stacked per-shard device formats + exchange plan."""

    def __init__(
        self,
        part: Partitioned,
        fmt: str,
        policy: Optional[DTypePolicy] = None,
        *,
        C: int = 0,
        sigma: int = 0,
        exchange_backend: str = "auto",
        mesh: Optional[Mesh] = None,
    ):
        self.part = part
        self.fmt = fmt
        self.policy = policy
        cls = get_format(fmt)

        if fmt == "sell":
            plans = [
                cls.plan_chunk_lens(s, C=C, sigma=sigma) for s in part.shards
            ]
            unified = np.max(np.stack(plans), axis=0)
            objs = [
                cls.from_csr(s, policy, C=C, sigma=sigma, forced_chunk_lens=unified)
                for s in part.shards
            ]
            self.perms = [
                np.asarray(o.old_to_new, dtype=np.int64) for o in objs
            ]
        elif fmt in ("ell",):
            lmax = max(
                (int(s.row_lengths.max()) if s.nnz else 1) for s in part.shards
            )
            objs = [cls.from_csr(s, policy, lmax=lmax) for s in part.shards]
            self.perms = None
        elif fmt in ("crs", "ccrs"):
            nnz_pad = max(s.nnz for s in part.shards)
            objs = [cls.from_csr(s, policy, nnz_pad=nnz_pad)
                    for s in part.shards]
            self.perms = None
        elif fmt == "dia":
            from sparsebench.formats.dia_split import DiaSplitMatrix

            offs = DiaSplitMatrix.plan(part.shards)
            nnz_pad = _boundary_pad(part)
            objs = [
                DiaSplitMatrix.from_csr(s, policy, forced_offsets=offs,
                                        nnz_pad=nnz_pad)
                for s in part.shards
            ]
            self.perms = None
        elif fmt == "bslab":
            objs = _build_bslab_split(part, policy)
            self.perms = None
        else:
            raise NotImplementedError(
                f"format {fmt!r} has no distributed build; "
                "use sell/ell/crs/bslab/dia for sharded solves"
            )

        # Per-shard metadata snapshot, taken BEFORE statics are normalized
        # for stacking: the stacked pytree's nnz/start_row fields are
        # meaningless per shard (they are equalized below so the shard
        # pytrees share one treedef) — anything that wants per-shard truth
        # (reports, padding evaluation) must read it from here.
        self.shard_meta = [
            {
                "nnz": int(s.nnz),
                "start_row": int(s.start_row),
                "nr": int(s.nr),
                "padding_ratio": float(getattr(o, "padding_ratio", 1.0)),
            }
            for o, s in zip(objs, part.shards)
        ]
        objs = [_normalize_statics(o, part) for o in objs]
        self.A = _pad_stack_leaves(objs)
        self.mesh = mesh if mesh is not None else make_mesh(part.plan.size)
        self.exchange = make_exchange(
            part.plan, AXIS, backend=exchange_backend, perm=self.perms
        )
        self.allsum = make_allsum(AXIS)
        self.permuted = bool(getattr(objs[0], "permuted_output", False))

    # -------------------------------------------------------- vector helpers
    @property
    def nr_max(self) -> int:
        return self.part.plan.nr_max

    def shard_vector(self, v_global: np.ndarray) -> np.ndarray:
        """Split a global row vector into the stacked (size, nr_max) layout
        (permuting per shard for row-permuting formats)."""
        plan = self.part.plan
        out = np.zeros((plan.size, plan.nr_max), dtype=v_global.dtype)
        for s, csr in enumerate(self.part.shards):
            nr_actual = csr.stop_row - csr.start_row + 1
            out[s, :nr_actual] = v_global[csr.start_row : csr.stop_row + 1]
            if self.permuted:
                out[s] = out[s][self._new_to_old(s)]  # v_perm[new] = v[old]
        return out

    def _new_to_old(self, s: int) -> np.ndarray:
        inv = np.empty_like(self.perms[s])
        inv[self.perms[s]] = np.arange(self.perms[s].size)
        return inv

    def unshard_vector(self, v_stacked: np.ndarray) -> np.ndarray:
        """Inverse of shard_vector: stacked (size, nr_max) -> global rows."""
        plan = self.part.plan
        parts = []
        for s, csr in enumerate(self.part.shards):
            v = np.asarray(v_stacked[s])
            if self.permuted:
                v = v[self.perms[s]]  # back to original local order
            nr_actual = csr.stop_row - csr.start_row + 1
            parts.append(v[:nr_actual])
        return np.concatenate(parts)


def dist_solve_cg(
    dm: DistMatrix,
    b_global: np.ndarray,
    *,
    itermax: int = 150,
    eps: float = 0.0,
    acc_dtype=None,
    inv_diag: "np.ndarray" = None,
    precond=None,
    variant: str = "standard",
    sstep: int = 4,
    verbose: bool = True,
) -> CGResult:
    """Distributed CG: one jitted shard_map program over the mesh.
    ``inv_diag`` (global row order) switches to Jacobi PCG — the z = D^-1 r
    step is shard-local elementwise; the reductions ride the same psum.
    ``variant="cs"`` runs single-reduction CG (solvers/cg.py cg_cs_loop):
    one fused psum per iteration instead of two sequential ones — the
    latency win this formulation exists for shows up exactly here, on a
    multi-chip mesh. cs + inv_diag = Chronopoulos-Gear Jacobi PCG (one
    fused 3-scalar psum per iteration). ``variant="sstep"`` runs s-step
    communication-avoiding CG (solvers/cg_sstep.py): ONE fused gram psum
    per ``sstep`` iterations — the deepest latency cut, for meshes where
    allreduce latency dominates.

    ``precond`` (solvers/precond.py ChebPrecond, optionally on top of
    ``inv_diag`` scaling; bounds from _dist_estimate_bounds mode=
    "precond") runs Chebyshev-polynomial PCG: each M-apply costs
    ``degree`` extra halo exchanges (nearest-neighbor ppermutes) but ZERO
    extra psums — on a mesh this converts global-latency-bound iterations
    into cheap neighbor traffic, cutting the psum count per digit of
    accuracy ~(degree+1)-fold."""
    if precond is not None and variant not in ("standard", "cs", "pipe"):
        raise ValueError(
            "operator preconditioning (precond=) supports cg variants "
            f"'standard', 'cs' and 'pipe' only, not {variant!r}"
        )
    plan = dm.part.plan
    b_stacked = jnp.asarray(dm.shard_vector(np.asarray(b_global)))
    x0_stacked = jnp.zeros_like(b_stacked)
    md_stacked = (
        jnp.asarray(dm.shard_vector(np.asarray(inv_diag, dtype=b_stacked.dtype)))
        if inv_diag is not None else None
    )

    from sparsebench.solvers.cg import resolve_cg_loop

    loop = partial(
        resolve_cg_loop(variant, sstep),
        itermax=itermax,
        exchange=dm.exchange,
        allsum=dm.allsum,
        acc_dtype=acc_dtype,
        # static (python floats + int): rides the closure, never traced
        **({"precond": precond} if precond is not None else {}),
    )

    def local_fn(A_stacked, b, x0, eps_s, md):
        A_local = jax.tree_util.tree_map(lambda l: l[0], A_stacked)
        x, k, hist = loop(
            A_local, b[0], x0[0], eps=eps_s,
            inv_diag=None if md is None else md[0],
        )
        return x[None], k, hist

    shard_fn = jax.jit(
        jax.shard_map(
            local_fn,
            mesh=dm.mesh,
            in_specs=(P(AXIS), P(AXIS), P(AXIS), P(),
                      P() if md_stacked is None else P(AXIS)),
            out_specs=(P(AXIS), P(), P()),
            check_vma=False,
        )
    )

    eps_arr = jnp.asarray(eps, dtype=acc_dtype or b_stacked.dtype)
    x_dev, k_dev, hist_dev = shard_fn(dm.A, b_stacked, x0_stacked, eps_arr,
                                      md_stacked)
    int(k_dev)
    t0 = time.perf_counter()
    x_dev, k_dev, hist_dev = shard_fn(dm.A, b_stacked, x0_stacked, eps_arr,
                                      md_stacked)
    k = int(k_dev)  # scalar readback = reliable sync (see cg.py)
    t1 = time.perf_counter()
    hist = np.asarray(hist_dev)
    x_global = dm.unshard_vector(np.asarray(x_dev))

    if verbose:
        print_residual_history(hist, k, itermax)
        print(f"Solution performed {k} iterations and took {t1 - t0:.2f}s")

    return CGResult(
        x=x_global,
        iterations=k,
        residual_history=hist[:k],
        final_normr=float(hist[k - 1] if k > 1 else hist[0]),
        solve_seconds=t1 - t0,
    )


def dist_solve_cg_refine(
    dm: DistMatrix,
    b_global: np.ndarray,
    *,
    dm_lo: DistMatrix,
    outer_max: int = 12,
    inner_iters: int = 100,
    eps: float = 0.0,
    acc_dtype=None,
    inner_eps_factor: float = 0.05,
    verbose: bool = True,
) -> CGResult:
    """Distributed mixed-precision iterative-refinement CG
    (solvers/refine.py cg_refine_loop inside shard_map): ``dm_lo`` is the
    low-precision twin built over the SAME ``Partitioned`` (pass the same
    ``part`` to both DistMatrix builds — same row split, same halo plan).
    Inner iterations exchange half-width halos and psum f32 scalars; the
    outer true-residual psum runs once per sweep in working precision."""
    if dm_lo.part is not dm.part and (
        dm_lo.part.plan.nr_max != dm.part.plan.nr_max
        or dm_lo.part.plan.size != dm.part.plan.size
    ):
        raise ValueError("dm_lo must share dm's partition plan")
    from sparsebench.solvers.refine import cg_refine_loop

    b_stacked = jnp.asarray(dm.shard_vector(np.asarray(b_global)))
    x0_stacked = jnp.zeros_like(b_stacked)

    loop = partial(
        cg_refine_loop, outer_max=outer_max, inner_iters=inner_iters,
        exchange=dm.exchange, allsum=dm.allsum, acc_dtype=acc_dtype,
        inner_eps_factor=inner_eps_factor,
    )

    def local_fn(A_hi_st, A_lo_st, b, x0, eps_s):
        A_hi = jax.tree_util.tree_map(lambda l: l[0], A_hi_st)
        A_lo = jax.tree_util.tree_map(lambda l: l[0], A_lo_st)
        x, sweeps, total_inner, hist = loop(A_hi, A_lo, b[0], x0[0],
                                            eps=eps_s)
        return x[None], sweeps, total_inner, hist

    shard_fn = jax.jit(
        jax.shard_map(
            local_fn,
            mesh=dm.mesh,
            in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P()),
            out_specs=(P(AXIS), P(), P(), P()),
            check_vma=False,
        )
    )

    eps_arr = jnp.asarray(eps, dtype=acc_dtype or b_stacked.dtype)
    x_dev, s_dev, ti_dev, hist_dev = shard_fn(dm.A, dm_lo.A, b_stacked,
                                              x0_stacked, eps_arr)
    int(s_dev)
    t0 = time.perf_counter()
    x_dev, s_dev, ti_dev, hist_dev = shard_fn(dm.A, dm_lo.A, b_stacked,
                                              x0_stacked, eps_arr)
    sweeps = int(s_dev)
    t1 = time.perf_counter()
    total_inner = int(ti_dev)
    hist = np.asarray(hist_dev)
    x_global = dm.unshard_vector(np.asarray(x_dev))

    if verbose:
        print(f"Initial Residual = {hist[0]:E}")
        for j in range(1, sweeps + 1):
            if not np.isnan(hist[j]):
                print(f"Refinement sweep = {j} Residual = {hist[j]:E}")
        print(f"Solution performed {sweeps} sweeps / {total_inner} "
              f"low-precision iterations and took {t1 - t0:.2f}s")

    final = hist[sweeps] if sweeps > 0 else hist[0]
    return CGResult(
        x=x_global,
        iterations=total_inner,
        residual_history=hist[: sweeps + 1],
        final_normr=float(final),
        solve_seconds=t1 - t0,
    )


def dist_spmv(dm: DistMatrix, x_global: np.ndarray) -> np.ndarray:
    """Distributed SpMV (halo exchange + local kernel), for tests/benchmarks."""
    x_stacked = jnp.asarray(dm.shard_vector(np.asarray(x_global)))
    halo = dm.part.plan.halo_max

    def local_fn(A_stacked, xs):
        A_local = jax.tree_util.tree_map(lambda l: l[0], A_stacked)
        xfull = jnp.concatenate([xs[0], jnp.zeros(halo, xs.dtype)])
        xfull = dm.exchange(xfull)
        spmv = A_local.spmv_permuted if dm.permuted else A_local.spmv
        return spmv(xfull)[None]

    fn = jax.jit(
        jax.shard_map(
            local_fn,
            mesh=dm.mesh,
            in_specs=(P(AXIS), P(AXIS)),
            out_specs=P(AXIS),
            check_vma=False,
        )
    )
    y = np.asarray(fn(dm.A, x_stacked))
    return dm.unshard_vector(y)


def dist_solve_chebyshev(
    dm: DistMatrix,
    b_global: np.ndarray,
    *,
    itermax: int = 150,
    eps: float = 0.0,
    bounds=None,
    inv_diag: "np.ndarray" = None,
    verbose: bool = True,
):
    """Distributed Chebyshev iteration: zero per-iteration allreduces except
    the residual-norm tracking psum — the communication-optimal solve.
    ``inv_diag`` (global row order) enables Jacobi preconditioning; the
    bounds are then estimated for M^-1 A (weighted distributed Lanczos)."""
    from sparsebench.solvers.chebyshev import ChebyshevResult, cheby_loop

    if bounds is None:
        bounds = _dist_estimate_bounds(dm, b_global.shape[0], b_global.dtype,
                                       inv_diag=inv_diag)
    lmin, lmax = bounds
    if verbose:
        print(f"Chebyshev bounds: lmin = {lmin:.4e} lmax = {lmax:.4e}")

    b_stacked = jnp.asarray(dm.shard_vector(np.asarray(b_global)))
    x0_stacked = jnp.zeros_like(b_stacked)
    md_stacked = (
        jnp.asarray(dm.shard_vector(np.asarray(inv_diag,
                                               dtype=b_stacked.dtype)))
        if inv_diag is not None else None
    )
    loop = partial(
        cheby_loop, itermax=itermax, lmin=lmin, lmax=lmax,
        exchange=dm.exchange, allsum=dm.allsum,
    )

    def local_fn(A_stacked, b, x0, eps_s, md):
        A_local = jax.tree_util.tree_map(lambda l: l[0], A_stacked)
        x, k, hist = loop(A_local, b[0], x0[0], eps=eps_s,
                          inv_diag=None if md is None else md[0])
        return x[None], k, hist

    shard_fn = jax.jit(
        jax.shard_map(
            local_fn,
            mesh=dm.mesh,
            in_specs=(P(AXIS), P(AXIS), P(AXIS), P(),
                      P() if md_stacked is None else P(AXIS)),
            out_specs=(P(AXIS), P(), P()),
            check_vma=False,
        )
    )
    eps_arr = jnp.asarray(eps, b_stacked.dtype)
    x_dev, k_dev, h_dev = shard_fn(dm.A, b_stacked, x0_stacked, eps_arr,
                                   md_stacked)
    int(k_dev)
    t0 = time.perf_counter()
    x_dev, k_dev, h_dev = shard_fn(dm.A, b_stacked, x0_stacked, eps_arr,
                                   md_stacked)
    k = int(k_dev)  # scalar readback = reliable sync (see cg.py)
    t1 = time.perf_counter()
    hist = np.asarray(h_dev)[:k]
    if verbose:
        print(f"Chebyshev performed {k} iterations and took {t1 - t0:.2f}s "
              f"(final residual {hist[-1]:E})")
    return ChebyshevResult(
        x=dm.unshard_vector(np.asarray(x_dev)),
        iterations=k,
        residual_history=hist,
        final_normr=float(hist[-1]),
        solve_seconds=t1 - t0,
        bounds=(lmin, lmax),
    )


def dist_solve_gmres(
    dm: DistMatrix,
    b_global: np.ndarray,
    *,
    itermax: int = 150,
    eps: float = 0.0,
    restart: int = 30,
    orth: str = "cgs",
    inv_diag: "np.ndarray" = None,
    precond=None,
    verbose: bool = True,
):
    """Distributed restarted GMRES(m): the Arnoldi cycle runs inside
    shard_map (basis sharded by rows, orthogonalization dots psummed).
    ``inv_diag`` (global row order) enables right Jacobi preconditioning
    (see solvers/gmres.py _gmres_cycle) — the M^-1 apply is shard-local
    elementwise. ``precond`` (ChebPrecond) swaps M^-1 for the Chebyshev
    polynomial: each apply costs ``degree`` halo exchanges, zero psums."""
    from sparsebench.solvers.gmres import GMRESResult, _gmres_cycle

    if orth not in ("cgs", "cgs2"):
        # same guard as solve_gmres: an unknown value would silently run
        # single-pass CGS (only the literal 'cgs2' reorthogonalizes)
        raise ValueError(f"orth must be 'cgs' or 'cgs2', got {orth!r}")

    b_stacked = jnp.asarray(dm.shard_vector(np.asarray(b_global)))
    x_stacked = jnp.zeros_like(b_stacked)
    md_stacked = (
        jnp.asarray(dm.shard_vector(np.asarray(inv_diag,
                                               dtype=b_stacked.dtype)))
        if inv_diag is not None else None
    )
    m = min(restart, itermax)
    nr_local = dm.nr_max
    nc_local = dm.nr_max + dm.part.plan.halo_max

    def local_fn(A_stacked, b, x0, md):
        A_local = jax.tree_util.tree_map(lambda l: l[0], A_stacked)
        spmv = (
            A_local.spmv_permuted
            if getattr(A_local, "permuted_output", False)
            else A_local.spmv
        )
        x_new, normr, k, brk = _gmres_cycle(
            A_local, b[0], x0[0], None if md is None else md[0],
            m=m, exchange=dm.exchange,
            allsum=dm.allsum, spmv=spmv, nr=nr_local, nc=nc_local, eps=eps,
            orth=orth, precond=precond,
        )
        return x_new[None], normr, k, brk

    cycle = jax.jit(
        jax.shard_map(
            local_fn,
            mesh=dm.mesh,
            in_specs=(P(AXIS), P(AXIS), P(AXIS),
                      P() if md_stacked is None else P(AXIS)),
            out_specs=(P(AXIS), P(), P(), P()),
            check_vma=False,
        )
    )

    # warm-up compile outside the timed section (solve_gmres convention)
    _w = cycle(dm.A, b_stacked, x_stacked, md_stacked)
    float(_w[1])

    hist = []
    iters = 0
    normr = np.inf
    broke_down = False
    t0 = time.perf_counter()
    while iters < itermax:
        x_new, normr_dev, k_dev, brk_dev = cycle(dm.A, b_stacked, x_stacked,
                                                 md_stacked)
        # one batched readback for the control scalars (see solve_gmres)
        normr_h, k_h, brk_h = jax.device_get((normr_dev, k_dev, brk_dev))
        if bool(brk_h):
            broke_down = True  # keep the last good iterate
            break
        x_stacked = x_new
        normr = float(normr_h)
        hist.append(normr)
        iters += int(k_h)
        if verbose:
            print(f"GMRES cycle {len(hist)}: iterations = {iters} "
                  f"Residual = {normr:E}")
        if normr <= eps or not np.isfinite(normr) or int(k_h) < m:
            break
    t1 = time.perf_counter()
    return GMRESResult(
        x=dm.unshard_vector(np.asarray(x_stacked)),
        iterations=min(iters, itermax),
        residual_history=np.asarray(hist),
        final_normr=normr,
        solve_seconds=t1 - t0,
        breakdown=broke_down,
    )


def _dist_short_recurrence_solve(
    dm: DistMatrix,
    b_global: np.ndarray,
    loop,
    *,
    itermax: int,
    eps: float,
    acc_dtype=None,
    inv_diag: "np.ndarray" = None,
    verbose: bool = True,
) -> CGResult:
    """Shared driver for the short-recurrence distributed solvers
    (BiCGStab, MINRES — both share cg_loop's (x, k, hist) contract):
    bf16 working-vector upcast (bf16 recurrences collapse —
    solve_gmres's finding), vector sharding, ONE shard_map'd jit with
    the None-aware inv_diag spec, warm-up + timed run, CGResult
    assembly. ``loop`` is the solver's jittable loop partially applied
    with everything but (A, b, x0, eps, inv_diag)."""
    b_np = np.asarray(b_global)
    if jnp.dtype(b_np.dtype) == jnp.bfloat16:
        b_np = b_np.astype(np.float32)
    b_stacked = jnp.asarray(dm.shard_vector(b_np))
    x0_stacked = jnp.zeros_like(b_stacked)
    md_stacked = (
        jnp.asarray(dm.shard_vector(np.asarray(inv_diag,
                                               dtype=b_stacked.dtype)))
        if inv_diag is not None else None
    )

    def local_fn(A_stacked, b, x0, eps_s, md):
        A_local = jax.tree_util.tree_map(lambda l: l[0], A_stacked)
        x, k, hist = loop(A_local, b[0], x0[0], eps=eps_s,
                          inv_diag=None if md is None else md[0])
        return x[None], k, hist

    shard_fn = jax.jit(
        jax.shard_map(
            local_fn,
            mesh=dm.mesh,
            in_specs=(P(AXIS), P(AXIS), P(AXIS), P(),
                      P() if md_stacked is None else P(AXIS)),
            out_specs=(P(AXIS), P(), P()),
            check_vma=False,
        )
    )
    eps_arr = jnp.asarray(eps, dtype=acc_dtype or b_stacked.dtype)
    x_dev, k_dev, hist_dev = shard_fn(dm.A, b_stacked, x0_stacked, eps_arr,
                                      md_stacked)
    int(k_dev)
    t0 = time.perf_counter()
    x_dev, k_dev, hist_dev = shard_fn(dm.A, b_stacked, x0_stacked, eps_arr,
                                      md_stacked)
    k = int(k_dev)
    t1 = time.perf_counter()
    hist = np.asarray(hist_dev)
    if verbose:
        print_residual_history(hist, k, itermax)
        print(f"Solution performed {k} iterations and took {t1 - t0:.2f}s")
    return CGResult(
        x=dm.unshard_vector(np.asarray(x_dev)),
        iterations=k,
        residual_history=hist[:k],
        final_normr=float(hist[k - 1] if k > 1 else hist[0]),
        solve_seconds=t1 - t0,
    )


def dist_solve_bicgstab(
    dm: DistMatrix,
    b_global: np.ndarray,
    *,
    itermax: int = 150,
    eps: float = 0.0,
    acc_dtype=None,
    inv_diag: "np.ndarray" = None,
    precond=None,
    verbose: bool = True,
) -> CGResult:
    """Distributed BiCGStab (solvers/bicgstab.py): one jitted shard_map
    program — 2 halo exchanges + 3 allreduces (two fused) per
    iteration. ``inv_diag`` (global row order) = right Jacobi;
    ``precond`` (ChebPrecond) = right polynomial preconditioning
    (2*degree extra halo exchanges per iteration, zero extra psums)."""
    from sparsebench.solvers.bicgstab import bicgstab_loop

    loop = partial(
        bicgstab_loop,
        itermax=itermax, exchange=dm.exchange, allsum=dm.allsum,
        acc_dtype=acc_dtype,
        # static (python floats + int): rides the closure, never traced
        **({"precond": precond} if precond is not None else {}),
    )
    return _dist_short_recurrence_solve(
        dm, b_global, loop, itermax=itermax, eps=eps, acc_dtype=acc_dtype,
        inv_diag=inv_diag, verbose=verbose,
    )


def dist_solve_minres(
    dm: DistMatrix,
    b_global: np.ndarray,
    *,
    itermax: int = 150,
    eps: float = 0.0,
    acc_dtype=None,
    inv_diag: "np.ndarray" = None,
    verbose: bool = True,
) -> CGResult:
    """Distributed MINRES (solvers/minres.py): one jitted shard_map
    program — 1 halo exchange + 2 scalar allreduces per iteration
    (standard CG's collective count). ``inv_diag`` (global row order) =
    Jacobi preconditioning; MINRES needs M SPD so every entry must be
    positive (validated here, like solve_minres)."""
    from sparsebench.solvers.minres import minres_loop

    if inv_diag is not None and not np.all(
        np.asarray(inv_diag, dtype=np.float64) > 0
    ):
        raise ValueError(
            "MINRES Jacobi preconditioning requires a positive diagonal "
            "(M must be SPD)"
        )
    loop = partial(
        minres_loop,
        itermax=itermax, exchange=dm.exchange, allsum=dm.allsum,
        acc_dtype=acc_dtype,
    )
    return _dist_short_recurrence_solve(
        dm, b_global, loop, itermax=itermax, eps=eps, acc_dtype=acc_dtype,
        inv_diag=inv_diag, verbose=verbose,
    )


def _dist_estimate_bounds(dm: DistMatrix, n: int, dtype, steps: int = 25,
                          inv_diag: "np.ndarray" = None,
                          mode: str = "solver"):
    """Distributed Lanczos bound estimate: the whole recurrence runs as ONE
    shard_map'd jit over the mesh (one dispatch, not one per Lanczos
    step)."""
    from sparsebench.solvers.chebyshev import (
        bounds_from_tridiag,
        lanczos_tridiag,
    )

    steps = min(steps, n)
    rng = np.random.default_rng(0)
    v0 = dm.shard_vector(rng.standard_normal(n).astype(dtype))
    md_stacked = (
        jnp.asarray(dm.shard_vector(np.asarray(inv_diag, dtype=dtype)))
        if inv_diag is not None else None
    )

    def local_fn(A_stacked, v, md):
        A_local = jax.tree_util.tree_map(lambda l: l[0], A_stacked)
        return lanczos_tridiag(A_local, v[0], steps=steps,
                               exchange=dm.exchange, allsum=dm.allsum,
                               inv_diag=None if md is None else md[0])

    fn = jax.jit(
        jax.shard_map(
            local_fn,
            mesh=dm.mesh,
            in_specs=(P(AXIS), P(AXIS),
                      P() if md_stacked is None else P(AXIS)),
            out_specs=(P(), P(), P()),
            check_vma=False,
        )
    )
    alphas, betas, count = fn(dm.A, jnp.asarray(v0), md_stacked)
    return bounds_from_tridiag(alphas, betas, int(count), mode=mode)


def build_distributed(
    shard_csrs: Sequence[HostCSR],
    fmt: str = "sell",
    policy: Optional[DTypePolicy] = None,
    *,
    C: int = 0,
    sigma: int = 0,
    exchange_backend: str = "auto",
    mesh: Optional[Mesh] = None,
) -> DistMatrix:
    """Partition + device build in one call (reference main.c:168-174:
    commPartition then convertMatrix)."""
    part = partition(list(shard_csrs))
    if fmt == "auto":
        from sparsebench.formats.dia import DiaUnsuitableError

        try:
            return DistMatrix(
                part, "dia", policy, C=C, sigma=sigma,
                exchange_backend=exchange_backend, mesh=mesh,
            )
        except DiaUnsuitableError:
            fmt = "bslab"
    return DistMatrix(
        part, fmt, policy, C=C, sigma=sigma,
        exchange_backend=exchange_backend, mesh=mesh,
    )
