"""Distributed matrix-free stencil CG: z-slab SPMD over the device mesh.

The weak-scaling generated problem stacks each rank's (nx, ny, nz)
subgrid along z (reference src/matrix.c:37-41), so the natural mesh
decomposition is one z-slab per device and the halo is exactly ONE
xy-plane per neighbor — the matrix-free analog of the reference's
compacted external tail (comm.c:96-110). Per CG iteration the collective
structure is identical to the stored-matrix path (2 scalar psums + 1
halo exchange, comm.c:627-662), but the exchange is two nearest-neighbor
``lax.ppermute`` plane shifts between mesh neighbours, and the local apply
streams zero matrix bytes (formats/stencil.py factorization).

The halo tail convention: a local working vector has length
nc = nr + 2*plane, tail = [plane received from rank-1 (the z-below
neighbor's LAST plane), plane received from rank+1 (the z-above
neighbor's FIRST plane)]. Edge shards keep zeros there — ppermute
zero-fills non-receiving shards, which is exactly the generator's
global-boundary truncation.

``overlap=True`` (CLI --overlap) swaps the blocking exchange->apply
composition for OverlapHaloStencil: the two plane ppermutes become
data-independent of the interior apply, so XLA's latency-hiding
scheduler can run the transfer underneath the whole interior apply and
only the O(nx*ny) one-plane corrections wait on the wire — the
communication/computation overlap the reference's blocking
MPI_Neighbor_alltoallv cannot express.
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from sparsebench import struct
from sparsebench.config import DTypePolicy
from sparsebench.formats.stencil import _sum3, stencil_row_counts
from sparsebench.parallel.dist import AXIS, make_mesh
from sparsebench.parallel.exchange import make_allsum
from sparsebench.solvers.cg import CGResult, print_residual_history


@struct.dataclass
class HaloStencilOperator:
    """Per-shard matrix-free apply over the halo-extended z-slab. All
    fields are static (zero array leaves) — inside shard_map it is a
    closure, never an operand.

    Deliberately mirrors formats/stencil.py StencilOperator (same fields,
    same 28/30 factorization constants) rather than subclassing it: the
    two differ in their whole vector-space contract
    (z-halo planes here are LIVE neighbor data, there they are zeros).
    The serial-vs-distributed residual-parity tests
    (tests/test_stencil_dist.py) pin the two implementations together —
    any divergence in the shared math fails them."""

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

    def spmv(self, x: jnp.ndarray) -> jnp.ndarray:
        nz, ny, nx = self.nz, self.ny, self.nx
        plane = nx * ny
        v3 = x[: self.nr].reshape(nz, ny, nx)
        up = x[self.nr : self.nr + plane].reshape(1, ny, nx)
        dn = x[self.nr + plane : self.nr + 2 * plane].reshape(1, ny, nx)
        ext = jnp.concatenate([up, v3, dn], axis=0)  # (nz+2, ny, nx)
        if self.use_7pt:
            sxy = _sum3(v3, 1) + _sum3(v3, 2)
            sz = ext[0:nz] + ext[1 : nz + 1] + ext[2 : nz + 2]
            y = jnp.asarray(30.0, v3.dtype) * v3 - (sxy + sz)
        else:
            t = _sum3(_sum3(ext, 2), 1)
            s = t[0:nz] + t[1 : nz + 1] + t[2 : nz + 2]
            y = jnp.asarray(28.0, v3.dtype) * v3 - s
        return y.reshape(-1)


def _halo_plane_correction(h2: jnp.ndarray, ny: int, nx: int,
                           use_7pt: bool) -> jnp.ndarray:
    """Contribution of one received z-halo plane to its adjacent interior
    output plane. By the tensor-product factorization (formats/stencil.py)
    the halo plane enters the apply only through the z-window term of that
    one neighbor plane: -(Sy Sx h) for the 27-pt operator, -h for the
    7-pt."""
    if not use_7pt:
        h2 = _sum3(_sum3(h2, 0), 1)
    return h2


@struct.dataclass
class OverlapHaloStencil:
    """Communication/computation-overlapped distributed stencil apply.

    The plain path composes ``spmv(exchange(p))``: the apply's
    input depends on both ppermutes, so XLA must finish the halo exchange
    before the apply starts — exactly the reference's blocking
    MPI_Neighbor_alltoallv discipline (comm.c:627-651). This operator
    restructures the SAME linear apply for latency hiding:

        1. ship the two boundary planes (ppermute, depends only on two
           planes of p);
        2. run the apply on p with ZERO halo planes (independent of the
           ppermutes — XLA's latency-hiding scheduler can overlap the
           transfer with the whole interior apply);
        3. add the received planes' one-plane corrections
           (_halo_plane_correction — O(nx*ny) work vs O(nx*ny*nz)).

    Linearity makes this exact: apply(p with halos h) == apply(p, 0)
    - corrections(h), to the same rounding class (the correction sums
    products in a different association; parity tests bound it). Works
    because solver working vectors keep their halo tail zero (axpys
    preserve zeros), so the operand IS the zero-halo volume.

    The exchange hook becomes identity."""

    base: HaloStencilOperator = struct.field(pytree_node=False)
    size: int = struct.field(pytree_node=False)
    axis: str = struct.field(pytree_node=False, default=AXIS)

    # mirrored static layout metadata (solvers read these off the operator)
    @property
    def nr(self):
        return self.base.nr

    @property
    def nc(self):
        return self.base.nc

    @property
    def nnz(self):
        return self.base.nnz

    @property
    def total_nr(self):
        return self.base.total_nr

    @property
    def total_nnz(self):
        return self.base.total_nnz

    def spmv(self, v: jnp.ndarray) -> jnp.ndarray:
        A = self.base
        up_perm = [(i, i + 1) for i in range(self.size - 1)]
        dn_perm = [(i + 1, i) for i in range(self.size - 1)]
        # send my last/first planes; non-receivers get zeros (= the
        # generator's global-boundary truncation)
        plane = A.nx * A.ny
        nr = A.nr
        up = jax.lax.ppermute(v[nr - plane : nr], self.axis, up_perm)
        dn = jax.lax.ppermute(v[:plane], self.axis, dn_perm)
        y = A.spmv(v)  # tail halos are zero in solver working vectors
        cu = _halo_plane_correction(up.reshape(A.ny, A.nx), A.ny, A.nx,
                                    A.use_7pt)
        cd = _halo_plane_correction(dn.reshape(A.ny, A.nx), A.ny, A.nx,
                                    A.use_7pt)
        y3 = y.reshape(A.nz, A.ny, A.nx)
        return y3.at[0].add(-cu).at[A.nz - 1].add(-cd).reshape(-1)


def make_plane_exchange(nr: int, plane: int, size: int, axis: str = AXIS):
    """Fill the 2-plane halo tail from the z-neighbors: two nearest-
    neighbor ppermutes (the reference's MPI_Neighbor_alltoallv over the
    dist-graph, comm.c:627-651 — banded partitions only ever talk to ring
    neighbors, SURVEY §5)."""
    up_perm = [(i, i + 1) for i in range(size - 1)]
    dn_perm = [(i + 1, i) for i in range(size - 1)]

    def exchange(p):
        up = jax.lax.ppermute(p[nr - plane : nr], axis, up_perm)
        dn = jax.lax.ppermute(p[:plane], axis, dn_perm)
        return jnp.concatenate([p[:nr], up, dn])

    return exchange


def build_halo_stencil(nx: int, ny: int, nz: int, size: int,
                       use_7pt: bool = False):
    """(operator, global row_counts) for the z-stacked ``size``-rank
    problem; counts feed b = 27 - (nnzrow - 1) (src/CGSolver.c:25-36)."""
    nr = nx * ny * nz
    counts = stencil_row_counts(nx, ny, nz * size, use_7pt)
    nnz = int(counts.sum())
    A = HaloStencilOperator(
        nx=nx, ny=ny, nz=nz, use_7pt=use_7pt, nr=nr,
        nc=nr + 2 * nx * ny, nnz=nnz, total_nr=nr * size, total_nnz=nnz,
    )
    return A, counts


def _shard_in(A: HaloStencilOperator, size: int, v_global) -> np.ndarray:
    """Global row vector -> stacked (size, nr) per-shard vectors."""
    return np.asarray(v_global).reshape(size, A.nr)


def _shard_out(A: HaloStencilOperator, size: int, v_stacked) -> np.ndarray:
    return np.asarray(v_stacked).reshape(-1)[: size * A.nr]


def _op_and_exchange(A: HaloStencilOperator, size: int, overlap: bool):
    """(operator, exchange) pair for the solver loops. ``overlap`` swaps
    the blocking exchange->apply composition for the OverlapHaloStencil
    restructuring (exchange becomes identity — the ppermutes live inside
    the apply where XLA can schedule them concurrently)."""
    if overlap:
        return OverlapHaloStencil(base=A, size=size), (lambda p: p)
    return A, make_plane_exchange(A.nr, A.nx * A.ny, size)


def dist_spmv_stencil(A: HaloStencilOperator, size: int,
                      x_global: np.ndarray, mesh=None,
                      overlap: bool = False) -> np.ndarray:
    """One exchanged SpMV over the mesh (testing/parity oracle)."""
    mesh = mesh if mesh is not None else make_mesh(size)
    A_op, exchange = _op_and_exchange(A, size, overlap)
    tail = A.nc - A.nr

    def local(x):
        xl = jnp.concatenate([x[0], jnp.zeros(tail, x.dtype)])
        return A_op.spmv(exchange(xl))[None]

    fn = jax.jit(
        jax.shard_map(local, mesh=mesh, in_specs=(P(AXIS),),
                      out_specs=P(AXIS), check_vma=False)
    )
    xs = _shard_in(A, size, np.asarray(x_global))
    return _shard_out(A, size, fn(jnp.asarray(xs)))


def dist_solve_cg_stencil(
    A: HaloStencilOperator,
    size: int,
    b_global: np.ndarray,
    *,
    itermax: int = 150,
    eps: float = 0.0,
    variant: str = "standard",
    sstep: int = 4,
    inv_diag: np.ndarray = None,
    precond=None,
    mesh=None,
    verbose: bool = True,
    overlap: bool = False,
) -> CGResult:
    """Distributed matrix-free CG: ONE jitted shard_map program (same
    collective structure as dist_solve_cg — 2 psums + 1 plane exchange
    per iteration; 1 fused psum with variant="cs"; 1 fused gram psum per
    ``sstep`` iterations with variant="sstep"). ``precond``
    (solvers/precond.py ChebPrecond) runs Chebyshev-polynomial PCG:
    degree extra plane exchanges per iteration, zero extra psums.
    ``overlap`` hides the halo-exchange latency behind the interior
    apply (OverlapHaloStencil)."""
    if precond is not None and variant not in ("standard", "cs", "pipe"):
        raise ValueError(
            "operator preconditioning (precond=) supports cg variants "
            f"'standard', 'cs' and 'pipe' only, not {variant!r}"
        )
    mesh = mesh if mesh is not None else make_mesh(size)
    A_op, exchange = _op_and_exchange(A, size, overlap)
    allsum = make_allsum(AXIS)
    from sparsebench.solvers.cg import resolve_cg_loop

    loop = partial(
        resolve_cg_loop(variant, sstep),
        itermax=itermax, exchange=exchange, allsum=allsum,
        **({"precond": precond} if precond is not None else {}),
    )

    b_st = jnp.asarray(_shard_in(A, size, b_global))
    x0_st = jnp.zeros_like(b_st)
    md_st = (
        jnp.asarray(_shard_in(
            A, size, np.asarray(inv_diag, dtype=np.asarray(b_global).dtype)
        ))
        if inv_diag is not None else None
    )

    def local_fn(b, x0, eps_s, md):
        x, k, hist = loop(A_op, b[0], x0[0], eps=eps_s,
                          inv_diag=None if md is None else md[0])
        return x[None], k, hist

    shard_fn = jax.jit(
        jax.shard_map(
            local_fn, mesh=mesh,
            in_specs=(P(AXIS), P(AXIS), P(),
                      P() if md_st is None else P(AXIS)),
            out_specs=(P(AXIS), P(), P()),
            check_vma=False,
        )
    )

    eps_arr = jnp.asarray(eps, dtype=b_st.dtype)
    x_dev, k_dev, hist_dev = shard_fn(b_st, x0_st, eps_arr, md_st)
    int(k_dev)  # warm-up + sync
    t0 = time.perf_counter()
    x_dev, k_dev, hist_dev = shard_fn(b_st, x0_st, eps_arr, md_st)
    k = int(k_dev)  # scalar readback = reliable sync (see cg.py)
    t1 = time.perf_counter()
    hist = np.asarray(hist_dev)

    if verbose:
        print_residual_history(hist, k, itermax)
        print(f"Solution performed {k} iterations and took {t1 - t0:.2f}s")

    return CGResult(
        x=_shard_out(A, size, x_dev),
        iterations=k,
        residual_history=hist[:k],
        final_normr=float(hist[k - 1] if k > 1 else hist[0]),
        solve_seconds=t1 - t0,
    )


def dist_solve_cg_refine_stencil(
    A: HaloStencilOperator,
    size: int,
    b_global: np.ndarray,
    *,
    outer_max: int = 12,
    inner_iters: int = 100,
    eps: float = 0.0,
    inner_eps_factor: float = 0.05,
    mesh=None,
    verbose: bool = True,
    overlap: bool = False,
) -> CGResult:
    """Distributed mixed-precision iterative refinement on the
    matrix-free stencil (solvers/refine.py cg_refine_loop inside
    shard_map). The operator stores nothing and adopts the vector dtype,
    so the low-precision twin IS the operator itself: inner iterations
    run on bf16/f32 vectors (halved halo planes and BLAS1 bytes — for a
    zero-matrix-byte apply the vectors are ALL the traffic), the outer
    true-residual sweep restores working precision."""
    mesh = mesh if mesh is not None else make_mesh(size)
    A_op, exchange = _op_and_exchange(A, size, overlap)
    allsum = make_allsum(AXIS)
    from sparsebench.solvers.refine import cg_refine_loop

    loop = partial(
        cg_refine_loop, outer_max=outer_max, inner_iters=inner_iters,
        exchange=exchange, allsum=allsum,
        inner_eps_factor=inner_eps_factor,
    )

    b_st = jnp.asarray(_shard_in(A, size, b_global))
    x0_st = jnp.zeros_like(b_st)

    def local_fn(b, x0, eps_s):
        x, sweeps, total_inner, hist = loop(A_op, A_op, b[0], x0[0],
                                            eps=eps_s)
        return x[None], sweeps, total_inner, hist

    shard_fn = jax.jit(
        jax.shard_map(
            local_fn, mesh=mesh,
            in_specs=(P(AXIS), P(AXIS), P()),
            out_specs=(P(AXIS), P(), P(), P()),
            check_vma=False,
        )
    )

    eps_arr = jnp.asarray(eps, dtype=b_st.dtype)
    x_dev, s_dev, ti_dev, hist_dev = shard_fn(b_st, x0_st, eps_arr)
    int(s_dev)  # warm-up + sync
    t0 = time.perf_counter()
    x_dev, s_dev, ti_dev, hist_dev = shard_fn(b_st, x0_st, eps_arr)
    sweeps = int(s_dev)
    t1 = time.perf_counter()
    total_inner = int(ti_dev)
    hist = np.asarray(hist_dev)

    if verbose:
        print(f"Initial Residual = {hist[0]:E}")
        for j in range(1, sweeps + 1):
            if not np.isnan(hist[j]):
                print(f"Refinement sweep = {j} Residual = {hist[j]:E}")
        print(f"Solution performed {sweeps} sweeps / {total_inner} "
              f"low-precision iterations and took {t1 - t0:.2f}s")

    final = hist[sweeps] if sweeps > 0 else hist[0]
    return CGResult(
        x=_shard_out(A, size, x_dev),
        iterations=total_inner,
        residual_history=hist[: sweeps + 1],
        final_normr=float(final),
        solve_seconds=t1 - t0,
    )


def dist_estimate_bounds_stencil(
    A: HaloStencilOperator, size: int, dtype, steps: int = 25,
    inv_diag: np.ndarray = None, mesh=None, mode: str = "solver",
    overlap: bool = False,
):
    """Mesh-Lanczos extreme-eigenvalue estimate for the matrix-free
    stencil operator: one fused shard_map dispatch (the same discipline
    as parallel/dist.py _dist_estimate_bounds)."""
    from sparsebench.solvers.chebyshev import (
        bounds_from_tridiag,
        lanczos_tridiag,
    )

    mesh = mesh if mesh is not None else make_mesh(size)
    A_op, exchange = _op_and_exchange(A, size, overlap)
    allsum = make_allsum(AXIS)
    n = A.total_nr
    steps = min(steps, n)
    rng = np.random.default_rng(0)
    v0 = _shard_in(A, size, rng.standard_normal(n).astype(dtype))
    md = (
        _shard_in(A, size, np.asarray(inv_diag, dtype=dtype))
        if inv_diag is not None else None
    )

    def local_fn(v, md_):
        return lanczos_tridiag(A_op, v[0], steps=steps, exchange=exchange,
                               allsum=allsum,
                               inv_diag=None if md_ is None else md_[0])

    fn = jax.jit(
        jax.shard_map(
            local_fn, mesh=mesh,
            in_specs=(P(AXIS), P() if md is None else P(AXIS)),
            out_specs=(P(), P(), P()),
            check_vma=False,
        )
    )
    alphas, betas, count = fn(
        jnp.asarray(v0), None if md is None else jnp.asarray(md)
    )
    return bounds_from_tridiag(alphas, betas, int(count), mode=mode)


def run_distributed_stencil(param, policy: DTypePolicy, args) -> int:
    """CLI driver for --fmt stencil --shards N (generated problems only).
    Mirrors run_distributed's report shape (parallel/driver.py)."""
    from sparsebench.profiler import HLINE, Profiler, trace
    from sparsebench.solvers.cg import check_residual

    if param.filename not in ("generate", "generate7P"):
        raise SystemExit(
            "--fmt stencil is matrix-free and applies to generated "
            "problems only (filename = generate|generate7P)"
        )
    if param.bench not in ("cg",):
        raise SystemExit(
            "--fmt stencil under --shards supports -t cg; use dia/bslab "
            "for the other distributed bench types"
        )
    for flag, msg in (("profile", "--profile"), ("checkpoint", "--checkpoint"),
                      ("rcm", "--rcm")):
        if getattr(args, flag, None):
            raise SystemExit(
                f"{msg} combines with the stored-format distributed paths; "
                "--fmt stencil streams no matrix"
            )
    size = param.shards
    if len(jax.devices()) < size:
        raise SystemExit(
            f"--shards {size} needs {size} devices, have {len(jax.devices())}"
        )

    t0 = time.perf_counter()
    A, counts = build_halo_stencil(
        param.nx, param.ny, param.nz, size,
        use_7pt=param.filename == "generate7P",
    )
    print(f"Setup took {time.perf_counter() - t0:.2f}s (format stencil, "
          "matrix-free)")
    plane = param.nx * param.ny
    print(f"Partition: {size} z-slabs x {A.nr} rows, halo {2 * plane}")
    overlap = bool(getattr(args, "overlap", False))
    if overlap:
        print("Exchange: overlapped (boundary-plane ppermutes concurrent "
              "with the zero-halo interior apply)")

    b = (27.0 - (counts - 1)).astype(policy.value)
    xexact = np.ones(A.total_nr, dtype=policy.value)
    refine = getattr(args, "refine", False)
    if refine and (
        getattr(args, "precond", "none") != "none"
        or getattr(args, "cg_variant", "standard") != "standard"
    ):
        raise SystemExit(
            "--refine combines with the plain CG path only (no "
            "--precond/--cg-variant)"
        )
    inv_diag = None
    precond = None
    pc_name = getattr(args, "precond", "none")
    if pc_name in ("jacobi", "cheb-jacobi"):
        # analytic stencil diagonal: constant 27 (reference matrix.c:87-92)
        inv_diag = np.full(A.total_nr, 1.0 / 27.0, dtype=policy.value)
        if pc_name == "jacobi":
            print("Preconditioner: Jacobi")
    if pc_name in ("cheb", "cheb-jacobi"):
        from sparsebench.solvers.precond import ChebPrecond

        if getattr(args, "cg_variant", "standard") not in (
            "standard", "cs", "pipe",
        ):
            raise SystemExit(
                f"--precond {pc_name} combines with --cg-variant "
                "standard/cs/pipe only"
            )
        bdt = np.float64 if policy.value == np.float64 else np.float32
        bounds = dist_estimate_bounds_stencil(
            A, size, bdt, inv_diag=inv_diag, mode="precond",
            overlap=overlap,
        )
        precond = ChebPrecond(*bounds,
                              degree=getattr(args, "precond_degree", 3))
        scaled = " on D^-1 A" if inv_diag is not None else ""
        print(f"Preconditioner: Chebyshev(degree {precond.degree}, "
              f"bounds [{precond.lmin:.4g}, {precond.lmax:.4g}]){scaled}")

    prof = Profiler()
    prof.init_factors(A.total_nr, 27 * A.total_nr, policy.value_bytes,
                      policy.index_bytes)
    with trace(getattr(args, "trace", None)):
        print("Test type: CG")
        if refine:
            from sparsebench.solvers.refine import refine_lo_policy

            _lo, lo_name = refine_lo_policy(policy)  # validates headroom
            print(f"Refinement: outer {np.dtype(policy.value).name} "
                  f"sweeps, inner CG in {lo_name} (matrix-free: the "
                  "operator adopts the vector dtype)")
            res = dist_solve_cg_refine_stencil(
                A, size, b,
                outer_max=getattr(args, "refine_sweeps", 12),
                inner_iters=param.itermax, eps=param.eps,
                overlap=overlap,
            )
        else:
            res = dist_solve_cg_stencil(
                A, size, b, itermax=param.itermax, eps=param.eps,
                variant=getattr(args, "cg_variant", "standard"),
                sstep=getattr(args, "sstep", 4),
                inv_diag=inv_diag,
                precond=precond,
                overlap=overlap,
            )
        print(prof.report_aggregate(res.iterations, res.solve_seconds))
    diff = check_residual(res.x, xexact)
    print(f"Difference between computed and exact  = {diff:f}")
    print(HLINE)
    print("Communication")
    print("rank\tkB")
    total = 0.0
    for i in range(size):
        neighbors = (1 if size > 1 else 0) * ((i > 0) + (i < size - 1))
        kb = 1.0e-3 * plane * neighbors * policy.value_bytes
        print(f"{i} {kb:11.2f}")
        total += kb
    print(f"Total data volume {total:.2f} kB")
    print(HLINE)
    return 0
