"""CLI driver for mesh-sharded runs (the --shards path of the CLI).

Mirrors the reference's MPI execution flow (src/main.c:83-230 under
mpirun): per-shard ingest -> partition -> format conversion -> distributed
solve -> report, except all shards are planned by one host process driving
the device mesh.
"""

from __future__ import annotations

import time

import numpy as np

from sparsebench.config import DTypePolicy, Parameter
from sparsebench.parallel.dist import build_distributed, dist_solve_cg
from sparsebench.profiler import HLINE, Profiler


class MeshCommInfo:
    """Adapter feeding the profiler's multi-rank report (reference
    profiler.c:47-124): per-shard communication volumes from the exchange
    plan. One host clock drives the mesh, so per-shard walltimes coincide."""

    single_clock = True  # profiler report prints the min==max caveat

    def __init__(self, plan, policy: DTypePolicy):
        self.size = plan.size
        self.plan = plan
        self.value_bytes = policy.value_bytes

    def comm_volumes(self):
        return list(self.plan.comm_words_per_shard)

    def gather_times(self, times):
        """Per-shard region walltimes (reference MPI_Gather of _t[],
        src/profiler.c:53-87). One host clock drives the lockstep mesh
        program, so every shard reports the same spans."""
        import numpy as _np

        return _np.tile(_np.asarray(times), (self.size, 1))


def init_shards(param: Parameter, size: int, rcm: bool = False):
    """Per-shard ingest with ONE parse of the input (reference master-read
    + scatter, comm.c:311-412): .mtx is read and parsed once, then sliced
    per rank; .bmx already memmap-slices per rank without re-parsing.
    ``rcm`` applies a global Reverse Cuthill-McKee reordering before
    slicing (the permutation is global — it cannot be applied per shard)."""
    from sparsebench.host import HostCSR, generate_stencil, read_mm
    from sparsebench.parallel.partition import slice_coo_rows

    fn = param.filename
    if fn in ("generate", "generate7P"):
        if rcm:
            raise SystemExit(
                "--rcm applies to file-ingested matrices; the generated "
                "stencil is already optimally banded"
            )
        return [
            generate_stencil(
                param.nx, param.ny, param.nz, rank=r, size=size,
                use_7pt=fn == "generate7P",
            )
            for r in range(size)
        ]
    if fn == "generateRGL":
        # distributed RGL builds shards from the host spec (host/rgl.py;
        # the single-chip path uses the on-device builder) so the
        # partition planner sees ordinary CSR shards
        from sparsebench.host.rgl import rgl_csr

        csr = rgl_csr(param.nx * param.ny * param.nz, band=param.band,
                      deg=param.deg, seed=param.seed)
        coo = _csr_to_coo(csr)
        return [
            HostCSR.from_coo(slice_coo_rows(coo, r, size))
            for r in range(size)
        ]

    if fn.endswith(".mtx"):
        coo = read_mm(fn)
        print("Read MTX matrix")
    elif fn.endswith(".bmx"):
        from sparsebench.host.binfile import (
            rank_row_range,
            read_bmx,
            read_bmx_header,
        )

        print("Read BMX matrix")
        if not rcm:
            # sharded memmap reads — each rank reads only its row slice
            total_nr, _ = read_bmx_header(fn)
            return [
                read_bmx(fn, row_range=rank_row_range(r, size, total_nr),
                         size=size)
                for r in range(size)
            ]
        coo = _csr_to_coo(read_bmx(fn))
    else:
        raise SystemExit(f"Unknown matrix file format: {fn}")

    if rcm:
        from sparsebench.host.rcm import permute_csr, rcm_permutation

        csr = HostCSR.from_coo(coo)
        csr = permute_csr(csr, rcm_permutation(csr))
        print(f"RCM reordering applied ({csr.nr} rows)")
        coo = _csr_to_coo(csr)
    return [
        HostCSR.from_coo(slice_coo_rows(coo, r, size)) for r in range(size)
    ]


def _csr_to_coo(csr):
    from sparsebench.host.coo import COOMatrix

    rows = np.repeat(np.arange(csr.nr, dtype=np.int64), csr.row_lengths)
    return COOMatrix(row=rows, col=csr.col, val=csr.val, nr=csr.nr,
                     nc=csr.nc)


def run_distributed(param: Parameter, policy: DTypePolicy, args) -> int:
    import jax

    from sparsebench.solvers.cg import check_residual

    size = param.shards
    if len(jax.devices()) < size:
        raise SystemExit(
            f"--shards {size} needs {size} devices, have {len(jax.devices())} "
            "(tests use XLA_FLAGS=--xla_force_host_platform_device_count=N)"
        )
    generated = param.filename in ("generate", "generate7P")

    t0 = time.perf_counter()
    shards = init_shards(param, size, rcm=getattr(args, "rcm", False))
    dm = build_distributed(
        shards,
        fmt=param.fmt,
        policy=policy,
        C=param.chunk_height,
        sigma=param.sigma,
        exchange_backend=param.exchange,
    )
    print(f"Setup took {time.perf_counter() - t0:.2f}s")
    from sparsebench.debug import maybe_dump_partition

    maybe_dump_partition(dm.part)  # SB_VERBOSE: out-<shard>.txt dumps
    plan = dm.part.plan
    print(
        f"Partition: {size} shards x {plan.nr_max} rows, halo {plan.halo_max}, "
        f"ring offsets {list(plan.offsets)}"
    )

    # rhs in original global order (reference initVectors per rank)
    if generated:
        b = np.concatenate(
            [27.0 - (s.row_lengths - 1) for s in shards]
        ).astype(policy.value)
        xexact = np.ones(b.shape[0], dtype=policy.value)
    elif param.filename == "generateRGL":
        # RGL row sums are exactly 1 (host/rgl.py): b = ones, x == 1
        b = np.ones(dm.part.total_nr, dtype=policy.value)
        xexact = np.ones(dm.part.total_nr, dtype=policy.value)
    else:
        b = np.ones(dm.part.total_nr, dtype=policy.value)
        xexact = None

    prof = Profiler()
    # reference reports the model count 27*nrow for generated problems
    # (src/matrix.c:113-120), actual nnz otherwise
    model_nnz = (
        27 * dm.part.total_nr if generated else sum(s.nnz for s in shards)
    )
    prof.init_factors(
        dm.part.total_nr, model_nnz, policy.value_bytes, policy.index_bytes,
        comm_words=int(np.sum(dm.part.plan.comm_words_per_shard)),
    )
    comm = MeshCommInfo(dm.part.plan, policy)
    iterations = 0

    from sparsebench.profiler import trace

    def make_inv_diag(announce: bool = True):
        """1/diag(A) from the shard diagonals (global row order), for
        --precond jacobi with any distributed solver."""
        d = np.concatenate([s.diagonal() for s in shards])
        if announce:
            print("Preconditioner: Jacobi")
        return np.where(d != 0, 1.0 / np.where(d != 0, d, 1), 1.0)

    def make_cheb_precond(inv_diag):
        """ChebPrecond from mesh-Lanczos precond-mode bounds (one fused
        shard_map dispatch), for --precond cheb / cheb-jacobi."""
        from sparsebench.parallel.dist import _dist_estimate_bounds
        from sparsebench.solvers.precond import ChebPrecond

        bdt = np.float64 if policy.value == np.float64 else np.float32
        bounds = _dist_estimate_bounds(
            dm, dm.part.total_nr, bdt, inv_diag=inv_diag, mode="precond"
        )
        pc = ChebPrecond(*bounds, degree=getattr(args, "precond_degree", 3))
        scaled = " on D^-1 A" if inv_diag is not None else ""
        print(f"Preconditioner: Chebyshev(degree {pc.degree}, "
              f"bounds [{pc.lmin:.4g}, {pc.lmax:.4g}]){scaled}")
        return pc

    def resolve_precond_pair():
        """(inv_diag, precond) from --precond — mirrors cli.py's helper
        of the same name for the distributed solver branches."""
        pc_name = getattr(args, "precond", "none")
        inv_diag = None
        precond = None
        if pc_name in ("jacobi", "cheb-jacobi"):
            inv_diag = make_inv_diag(announce=pc_name == "jacobi")
        if pc_name in ("cheb", "cheb-jacobi"):
            precond = make_cheb_precond(inv_diag)
        return inv_diag, precond

    with trace(getattr(args, "trace", None)):
        if param.bench == "cg":
            print("Test type: CG")
            pc_name = getattr(args, "precond", "none")
            if pc_name in ("cheb", "cheb-jacobi") and getattr(
                args, "cg_variant", "standard"
            ) not in ("standard", "cs", "pipe"):
                raise SystemExit(
                    f"--precond {pc_name} combines with --cg-variant "
                    "standard/cs/pipe only"
                )
            refine = getattr(args, "refine", False)
            if refine and (
                pc_name != "none"
                or getattr(args, "cg_variant", "standard") != "standard"
                or getattr(args, "checkpoint", None)
                or getattr(args, "profile", False)
            ):
                raise SystemExit(
                    "--refine combines with the plain CG path only (no "
                    "--precond/--cg-variant/--checkpoint/--profile)"
                )
            inv_diag, precond = resolve_precond_pair()
            checkpoint = getattr(args, "checkpoint", None)
            if checkpoint and (
                getattr(args, "profile", False)
                or inv_diag is not None
                or precond is not None
                or getattr(args, "cg_variant", "standard") != "standard"
            ):
                raise SystemExit(
                    "--checkpoint combines with the plain CG path only"
                )
            if refine:
                from sparsebench.parallel.dist import (
                    DistMatrix,
                    dist_solve_cg_refine,
                )
                from sparsebench.solvers.refine import refine_lo_policy

                lo, lo_name = refine_lo_policy(policy)
                print(f"Refinement: outer {np.dtype(policy.value).name} "
                      f"sweeps, inner CG in {lo_name}")
                dm_lo = DistMatrix(
                    dm.part, dm.fmt, lo, C=param.chunk_height,
                    sigma=param.sigma, exchange_backend=param.exchange,
                    mesh=dm.mesh,
                )
                res = dist_solve_cg_refine(
                    dm, b, dm_lo=dm_lo,
                    outer_max=getattr(args, "refine_sweeps", 12),
                    inner_iters=param.itermax, eps=param.eps,
                )
            elif checkpoint:
                from sparsebench.parallel.checkpoint import (
                    dist_solve_cg_checkpointed,
                )

                res = dist_solve_cg_checkpointed(
                    dm, b, checkpoint_path=checkpoint,
                    checkpoint_every=getattr(args, "checkpoint_every", 50),
                    itermax=param.itermax, eps=param.eps,
                )
            elif getattr(args, "profile", False):
                from sparsebench.parallel.profiled import (
                    dist_solve_cg_profiled,
                )

                if inv_diag is not None or precond is not None:
                    raise SystemExit(
                        "--precond combines with the plain CG path only"
                    )
                if getattr(args, "cg_variant", "standard") != "standard":
                    raise SystemExit(
                        "--cg-variant combines with the plain CG path only"
                    )
                res = dist_solve_cg_profiled(
                    dm, b, prof, itermax=param.itermax, eps=param.eps
                )
            else:
                res = dist_solve_cg(dm, b, itermax=param.itermax,
                                    eps=param.eps, inv_diag=inv_diag,
                                    precond=precond,
                                    variant=getattr(args, "cg_variant",
                                                    "standard"),
                                    sstep=getattr(args, "sstep", 4))
                print(prof.report_aggregate(res.iterations,
                                            res.solve_seconds))
            iterations = res.iterations
        elif param.bench == "cheb":
            from sparsebench.parallel.dist import dist_solve_chebyshev

            print("Test type: CHEBFD")
            inv_diag = None
            if getattr(args, "precond", "none") == "jacobi":
                inv_diag = make_inv_diag()
            res = dist_solve_chebyshev(dm, b, itermax=param.itermax,
                                       eps=param.eps, inv_diag=inv_diag)
        elif param.bench == "gmres":
            from sparsebench.parallel.dist import dist_solve_gmres

            print("Test type: GMRES")
            inv_diag, precond = resolve_precond_pair()
            res = dist_solve_gmres(dm, b, itermax=param.itermax,
                                   eps=param.eps,
                                   orth=getattr(args, "orth", "cgs"),
                                   inv_diag=inv_diag, precond=precond,
                                   restart=getattr(args, "restart", 30))
        elif param.bench == "bicgstab":
            from sparsebench.parallel.dist import dist_solve_bicgstab

            print("Test type: BICGSTAB")
            inv_diag, precond = resolve_precond_pair()
            res = dist_solve_bicgstab(dm, b, itermax=param.itermax,
                                      eps=param.eps, inv_diag=inv_diag,
                                      precond=precond)
        elif param.bench == "minres":
            from sparsebench.parallel.dist import dist_solve_minres

            print("Test type: MINRES")
            # Jacobi only (M must be SPD — solvers/minres.py); cheb was
            # rejected by the CLI before the sharded dispatch
            inv_diag = None
            if getattr(args, "precond", "none") == "jacobi":
                inv_diag = make_inv_diag()
            res = dist_solve_minres(dm, b, itermax=param.itermax,
                                    eps=param.eps, inv_diag=inv_diag)
        elif param.bench == "spmv":
            from sparsebench.parallel.profiled import dist_bench_spmv

            print("Test type: SPMVM")
            dist_bench_spmv(dm, prof, itermax=param.itermax)
            iterations = max(param.itermax - 1, 1)  # reference main.c:213-215
            print(prof.report(iterations, comm=comm))
            return 0
        else:
            raise SystemExit(
                f"distributed bench type {param.bench!r} not supported"
            )
    if xexact is not None:
        diff = check_residual(res.x, xexact)
        print(f"Difference between computed and exact  = {diff:f}")

    iterations = iterations or res.iterations
    if getattr(args, "profile", False) and param.bench == "cg":
        # full multi-rank report: per-region min/max/avg + per-rank comm
        # kB / kB/s / walltime (reference profiler.c:47-124). Gated to
        # the bench that feeds the timers — the CLI warns for others
        print(prof.report(iterations, comm=comm))
    else:
        # fused mode has no per-region attribution — volumes only
        print(HLINE)
        print("Communication")
        print("rank\tkB")
        total = 0.0
        for i, words in enumerate(comm.comm_volumes()):
            kb = 1.0e-3 * words * policy.value_bytes
            print(f"{i} {kb:11.2f}")
            total += kb
        print(f"Total data volume {total:.2f} kB")
        print(HLINE)
    return 0
