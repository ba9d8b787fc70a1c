"""Command-line driver (reference src/main.c).

Flag parity with the reference getopt interface (src/main.c:99-154, help
text src/main.c:24-40): ``-h -c -f -m -t -x -y -z -i -e``, plus runtime
options the reference fixes at compile time (format, dtypes, C/sigma — see
config.mk:1-8) and runtime controls (shards, profile mode, trace dir).

Flow mirrors main (src/main.c:83-230):
  banner -> init matrix (generate | .mtx | .bmx) -> [partition] ->
  convert format -> profiler factors -> solve/bench -> report.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np

from sparsebench.config import (
    DTypePolicy,
    Parameter,
    print_parameter,
    read_parameter,
)
from sparsebench.version import __version__


BANNER = r"""
   _____                             ____                  __
  / ___/____  ____ ______________   / __ )___  ____  _____/ /_
  \__ \/ __ \/ __ `/ ___/ ___/ _ \ / __  / _ \/ __ \/ ___/ __ \
 ___/ / /_/ / /_/ / /  (__  )  __// /_/ /  __/ / / / /__/ / / /
/____/ .___/\__,_/_/  /____/\___//_____/\___/_/ /_/\___/_/ /_/
    /_/                        sparse solver benchmarks
"""


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="sparsebench",
        description="Sparse solver benchmark (CG / SpMV over "
        "CRS, CCRS, SELL-C-sigma, ELL, DIA formats).",
        allow_abbrev=False,
    )
    # reference flags (src/main.c:24-40)
    ap.add_argument("-c", metavar="FILE", dest="convert",
                    help="Convert MM matrix to binary matrix file (.bmx)")
    ap.add_argument("-f", metavar="FILE", dest="par_file",
                    help="Load options from a parameter file")
    ap.add_argument("-m", metavar="FILE", dest="mm_file",
                    help="Load a matrix market file")
    ap.add_argument("-t", dest="bench", default=None,
                    choices=["cg", "spmv", "gmres", "cheb", "bicgstab",
                             "minres"],
                    help="Benchmark type. Default cg.")
    ap.add_argument("-x", type=int, default=None, help="Generated size in x")
    ap.add_argument("-y", type=int, default=None, help="Generated size in y")
    ap.add_argument("-z", type=int, default=None, help="Generated size in z")
    ap.add_argument("-i", type=int, default=None, dest="itermax",
                    help="Number of solver iterations. Default 150.")
    ap.add_argument("-e", type=float, default=None, dest="eps",
                    help="Convergence criteria epsilon. Default 0.0.")
    # runtime options (compile-time in the reference, config.mk:1-8)
    ap.add_argument("--fmt", default=None,
                    choices=["auto", "crs", "ccrs", "sell", "ell", "dia",
                    "bslab", "stencil"],
                    help="Matrix format (reference MTX_FMT). Default auto: "
                    "dia for generated and banded matrices, bslab "
                    "otherwise. 'stencil' is a MATRIX-FREE apply for "
                    "generated problems only (zero matrix bytes streamed).")
    ap.add_argument("--sub", type=int, default=None,
                    help="bslab slice height in 128-row lane groups "
                    "(default 64, auto-shrunk for small matrices)")
    ap.add_argument("--dtype", default=None, choices=["f64", "f32", "bf16"],
                    help="Value dtype (reference FLOAT_TYPE). Default f32 "
                    "(the reference compiles double — pass f64 for "
                    "reference precision).")
    ap.add_argument("--index-dtype", default=None, choices=["i32", "i64"],
                    help="Index dtype (reference UINT_TYPE). Default i32.")
    ap.add_argument("-C", "--chunk-height", type=int, default=None,
                    help="SELL-C-sigma chunk height C (0 = auto)")
    ap.add_argument("--sigma", type=int, default=None,
                    help="SELL-C-sigma sorting scope (0 = full sort)")
    # beyond the reference
    ap.add_argument("--shards", type=int, default=None,
                    help="Shard the solve over this many mesh devices")
    ap.add_argument("--exchange", default=None,
                    choices=["auto", "ppermute", "allgather"],
                    help="Halo exchange backend for sharded solves")
    ap.add_argument("--overlap", action="store_true",
                    help="Overlap the halo exchange with the interior "
                    "apply (--fmt stencil --shards N): the boundary-plane "
                    "ppermutes run concurrently with the zero-halo interior "
                    "apply, then one-plane corrections restore exactness, "
                    "so the transfer can hide under the apply. The "
                    "reference's MPI_Neighbor_alltoallv is blocking "
                    "(comm.c:627-651).")
    ap.add_argument("--profile", action="store_true",
                    help="Per-region timing report (reference profiler table)")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="Write an XLA profiler trace (LIKWID analog)")
    ap.add_argument("--checkpoint", metavar="PATH", default=None,
                    help="Checkpoint solver state to PATH and resume from it")
    ap.add_argument("--checkpoint-every", type=int, default=50,
                    help="Iterations between checkpoints (default 50)")
    ap.add_argument("--precond", default="none",
                    choices=["none", "jacobi", "cheb", "cheb-jacobi"],
                    help="Preconditioning (beyond the reference, which is "
                    "unpreconditioned). 'jacobi': PCG for -t cg, right-"
                    "preconditioned GMRES for -t gmres, M^-1 A Chebyshev "
                    "with weighted-Lanczos bounds for -t cheb. 'cheb': "
                    "Chebyshev polynomial PCG (-t cg, variants standard/"
                    "cs) — degree SpMVs per apply, ZERO extra allreduces; "
                    "'cheb-jacobi': the polynomial on the Jacobi-scaled "
                    "operator (needs the diagonal)")
    ap.add_argument("--precond-degree", type=int, default=3,
                    help="Chebyshev preconditioner polynomial degree "
                    "(default 3; only with --precond cheb/cheb-jacobi)")
    ap.add_argument("--cg-variant", default="standard",
                    choices=["standard", "cs", "sstep", "pipe"],
                    dest="cg_variant",
                    help="CG formulation: the reference's (2 allreduces/"
                    "iter), single-reduction Chronopoulos-Gear 'cs' "
                    "(1 fused allreduce/iter; latency win on meshes), "
                    "'sstep' communication-avoiding CG (1 fused allreduce "
                    "per --sstep iterations), or 'pipe' pipelined CG "
                    "(the allreduce overlaps the matvec)")
    ap.add_argument("--sstep", type=int, default=4,
                    help="Basis size s for --cg-variant sstep (default 4; "
                    "the s x s gram conditioning recommends s <= 8)")
    ap.add_argument("--nrhs", type=int, default=1,
                    help="Solve N right-hand sides simultaneously with "
                    "blocked CG (-t cg, serial, plain path): one matrix "
                    "read per iteration serves all N columns, so per-RHS "
                    "cost beats N separate solves on the bandwidth-bound "
                    "SpMV (solvers/cg_multi.py)")
    ap.add_argument("--refine", action="store_true",
                    help="Mixed-precision iterative refinement for -t cg: "
                    "outer true-residual sweeps at --dtype, inner CG one "
                    "precision down (f64->f32, f32->bf16) — the inner "
                    "solve streams roughly half the bytes per iteration "
                    "(solvers/refine.py). -i caps the inner iterations "
                    "per sweep; -e is the outer (true-residual) target, "
                    "0 = run to the low precision's floor.")
    ap.add_argument("--refine-sweeps", type=int, default=12,
                    help="Max outer refinement sweeps (default 12; the "
                    "loop also exits on -e or on stagnation)")
    ap.add_argument("--restart", type=int, default=30,
                    help="GMRES(m) restart length (default 30; the Arnoldi "
                    "basis is a dense (m+1, n) block on device)")
    ap.add_argument("--orth", default="cgs", choices=["cgs", "cgs2"],
                    help="GMRES orthogonalization: classical Gram-Schmidt "
                    "or reorthogonalized CGS2 (robust for ill-conditioned "
                    "bases; ~2x orthogonalization cost)")
    ap.add_argument("--band", type=int, default=None,
                    help="generateRGL: half-bandwidth of the random graph "
                    "(default 512)")
    ap.add_argument("--deg", type=float, default=None,
                    help="generateRGL: target average degree (default 16)")
    ap.add_argument("--seed", type=int, default=None,
                    help="generateRGL: graph seed (default 1)")
    ap.add_argument("--rcm", action="store_true",
                    help="Reverse Cuthill-McKee row/col reordering before "
                    "format conversion (cuts BSLAB padding / enables DIA "
                    "on scattered band matrices)")
    ap.add_argument("--banner", action="store_true",
                    help="Print the device table (reference affinity map)")
    ap.add_argument("--version", action="version", version=__version__)
    return ap


def apply_args(param: Parameter, args: argparse.Namespace) -> Parameter:
    """CLI overrides .par file overrides defaults (reference main.c order:
    options are processed in command-line order; -f loads first in
    practice)."""
    if args.par_file:
        read_parameter(param, args.par_file)
    if args.mm_file:
        param.filename = args.mm_file
    for key_cli, key_param in [
        ("x", "nx"), ("y", "ny"), ("z", "nz"), ("itermax", "itermax"),
        ("eps", "eps"), ("fmt", "fmt"), ("dtype", "dtype"),
        ("index_dtype", "index_dtype"), ("chunk_height", "chunk_height"),
        ("sigma", "sigma"), ("shards", "shards"), ("bench", "bench"),
        ("exchange", "exchange"), ("band", "band"), ("deg", "deg"),
        ("seed", "seed"),
    ]:
        v = getattr(args, key_cli, None)
        if v is not None:
            setattr(param, key_param, v)
    return param


def init_matrix(param: Parameter, rank: int = 0, size: int = 1):
    """Reference initMatrix (src/main.c:54-81)."""
    from sparsebench.host import HostCSR, generate_stencil, read_mm
    from sparsebench.host.binfile import rank_row_range, read_bmx

    fn = param.filename
    if fn == "generate":
        return generate_stencil(param.nx, param.ny, param.nz, rank=rank, size=size)
    if fn == "generate7P":
        return generate_stencil(
            param.nx, param.ny, param.nz, rank=rank, size=size, use_7pt=True
        )
    if fn.endswith(".mtx"):
        if size > 1:
            # master-read + scatter analog: each shard slices its row block
            from sparsebench.parallel.partition import slice_coo_rows

            coo = read_mm(fn)
            return HostCSR.from_coo(slice_coo_rows(coo, rank, size))
        print("Read MTX matrix")
        return HostCSR.from_coo(read_mm(fn))
    if fn.endswith(".bmx"):
        from sparsebench.host.binfile import read_bmx_header

        print("Read BMX matrix")
        total_nr, _ = read_bmx_header(fn)
        rng = rank_row_range(rank, size, total_nr) if size > 1 else None
        return read_bmx(fn, row_range=rng, size=size)
    raise SystemExit(f"Unknown matrix file format: {fn}")


def write_bin_matrix(filename: str) -> None:
    """Reference writeBinMatrix (src/main.c:42-52)."""
    from sparsebench.host import HostCSR, read_mm
    from sparsebench.host.binfile import write_bmx

    csr = HostCSR.from_coo(read_mm(filename))
    out = filename.rsplit(".", 1)[0] + ".bmx"  # util.c changeFileEnding
    print(f"Writing matrix to {out}")
    write_bmx(csr, out)


def main(argv: Optional[list] = None) -> int:
    ap = build_argparser()
    args = ap.parse_args(argv)
    param = apply_args(Parameter(), args)

    if args.convert:
        write_bin_matrix(args.convert)
        return 0

    policy = DTypePolicy.from_names(param.dtype, param.index_dtype)
    policy.ensure_x64()
    from sparsebench.utils import device_platform, enable_compile_cache

    device_platform()  # a missing GPU is an error, not a CPU run
    enable_compile_cache()  # setup is compile-dominated

    import jax

    from sparsebench.formats import from_csr
    from sparsebench.profiler import Profiler, trace
    from sparsebench.solvers.cg import check_residual, init_vectors, solve_cg
    from sparsebench.solvers.profiled import bench_spmv, solve_cg_profiled

    devices = jax.devices()
    print(BANNER)
    print(
        f"sparsebench {__version__} | format {param.fmt} | "
        f"precision {param.dtype}/{param.index_dtype} | "
        f"{len(devices)}x {devices[0].device_kind}"
    )
    if args.banner:
        from sparsebench.utils import device_banner

        print(device_banner())

    print(print_parameter(param))  # reference printParameter (parameter.c:66-73)
    generated = param.filename in ("generate", "generate7P")

    # flag-value validation BEFORE the sharded dispatch below — these
    # must fail identically for serial and --shards runs (an invalid
    # value reaching the solvers surfaces as a raw traceback)
    if args.cg_variant == "sstep" and args.sstep < 1:
        raise SystemExit("--sstep must be >= 1")
    if args.restart < 1:
        raise SystemExit("--restart must be >= 1")
    # No silently-ignored flags:
    # warn when a solver-specific flag cannot reach the chosen bench.
    # Defaults come from the parser itself so the two cannot drift.
    for flag, attr, benches in (
        ("--orth", "orth", ("gmres",)),
        ("--restart", "restart", ("gmres",)),
        ("--cg-variant", "cg_variant", ("cg",)),
        ("--checkpoint", "checkpoint", ("cg",)),
        ("--precond", "precond", ("cg", "gmres", "cheb", "bicgstab",
                                  "minres")),
        ("--refine", "refine", ("cg",)),
        ("--nrhs", "nrhs", ("cg",)),
        # only the CG loop and the SpMV bench feed the region timers
        # (reference PROFILE sites: CGSolver.c + main.c:200-216); other
        # benches would print an all-zeros table
        ("--profile", "profile", ("cg", "spmv")),
    ):
        if getattr(args, attr) != ap.get_default(attr) and (
            param.bench not in benches
        ):
            print(
                f"warning: {flag} has no effect with -t {param.bench}",
                file=sys.stderr,
            )
    if args.sstep != ap.get_default("sstep") and not (
        args.cg_variant == "sstep" and param.bench == "cg"
    ):
        print("warning: --sstep has no effect without -t cg "
              "--cg-variant sstep", file=sys.stderr)
    if (args.checkpoint_every != ap.get_default("checkpoint_every")
            and not args.checkpoint):
        print("warning: --checkpoint-every has no effect without "
              "--checkpoint", file=sys.stderr)
    if (args.precond_degree != ap.get_default("precond_degree")
            and args.precond not in ("cheb", "cheb-jacobi")):
        print("warning: --precond-degree has no effect without "
              "--precond cheb/cheb-jacobi", file=sys.stderr)
    if (args.refine_sweeps != ap.get_default("refine_sweeps")
            and not args.refine):
        print("warning: --refine-sweeps has no effect without --refine",
              file=sys.stderr)
    if args.overlap and (param.shards <= 1 or param.fmt != "stencil"):
        raise SystemExit(
            "--overlap applies to the distributed matrix-free stencil "
            "only (--fmt stencil --shards N): the stored-format exchange "
            "is already a compacted-tail gather; overlap there would "
            "need an interior/boundary row split (not implemented)"
        )
    if args.refine and (args.precond != "none"
                        or args.cg_variant != "standard"
                        or args.checkpoint or args.profile):
        raise SystemExit(
            "--refine combines with the plain CG path only (no "
            "--precond/--cg-variant/--checkpoint/--profile: the inner "
            "solve IS the acceleration)"
        )
    if args.nrhs < 1:
        raise SystemExit("--nrhs must be >= 1")
    if args.nrhs > 1 and param.bench == "cg" and (
        args.precond != "none" or args.cg_variant != "standard"
        or args.checkpoint or args.profile or args.refine
        or param.shards > 1 or param.fmt == "stencil"
    ):
        raise SystemExit(
            "--nrhs > 1 uses the blocked serial CG path on a stored "
            "format only (no --precond/--cg-variant/--checkpoint/"
            "--profile/--refine/--shards/--fmt stencil)"
        )
    if args.precond in ("cheb", "cheb-jacobi") and param.bench not in (
        "cg", "gmres", "bicgstab"
    ):
        raise SystemExit(
            f"--precond {args.precond} supports -t cg/gmres/bicgstab "
            "(preconditioning the Chebyshev solver with a Chebyshev "
            "polynomial is the same iteration twice: raise --iter instead)"
        )

    t0 = time.perf_counter()
    if param.shards > 1:
        if param.fmt == "stencil":
            from sparsebench.parallel.stencil_dist import (
                run_distributed_stencil,
            )

            return run_distributed_stencil(param, policy, args)
        from sparsebench.parallel.driver import run_distributed

        return run_distributed(param, policy, args)

    csr = None
    row_counts = None
    rgl = param.filename == "generateRGL"
    sub_opts = {"sub": args.sub} if args.sub else {}
    if rgl:
        # Irregular benchmark matrix: seeded random-graph Laplacian,
        # generated and laid out entirely ON DEVICE (host/rgl.py spec,
        # formats/rgl_build.py builder). n = nx*ny*nz.
        if param.fmt not in ("auto", "bslab"):
            raise SystemExit(
                "generateRGL builds on-device in bslab layout; use "
                "--fmt auto|bslab (host formats would need a "
                "disqualifyingly slow host build + upload at scale)"
            )
        from sparsebench.formats.rgl_build import rgl_bslab

        n = param.nx * param.ny * param.nz
        A, nnz = rgl_bslab(
            n, band=param.band, deg=param.deg, seed=param.seed,
            policy=policy, **sub_opts,
        )
        param.fmt = "bslab"
        total_nr, model_nnz = n, nnz
        print(f"RGL: n={n} band={param.band} deg~{param.deg} seed="
              f"{param.seed} nnz={nnz} padding={A.padding_ratio:.2f}")
    elif generated and param.fmt in ("auto", "bslab", "dia", "stencil"):
        # Fast path: analytic ON-DEVICE stencil build, no CSR intermediate
        # and no host->device transfer. auto picks dia: the generated
        # matrix is banded, and DIA's SpMV is gather-free. bslab remains
        # the general-format (non-banded) answer.
        pick = "dia" if param.fmt == "auto" else param.fmt
        if pick == "stencil":
            from sparsebench.formats.stencil import StencilOperator

            A, row_counts = StencilOperator.from_stencil(
                param.nx, param.ny, param.nz,
                use_7pt=param.filename == "generate7P",
                policy=policy,
            )
        elif pick == "bslab":
            from sparsebench.formats.bslab import BslabMatrix

            A, row_counts = BslabMatrix.from_stencil(
                param.nx, param.ny, param.nz,
                use_7pt=param.filename == "generate7P",
                policy=policy, **sub_opts,
            )
        else:
            from sparsebench.formats.dia import DiaMatrix

            A, row_counts = DiaMatrix.from_stencil(
                param.nx, param.ny, param.nz,
                use_7pt=param.filename == "generate7P",
                policy=policy,
            )
        param.fmt = pick
        total_nr, model_nnz = A.total_nr, 27 * A.total_nr
    else:
        csr = init_matrix(param)
        if args.rcm:
            from sparsebench.host.rcm import permute_csr, rcm_permutation

            perm = rcm_permutation(csr)
            csr = permute_csr(csr, perm)
            print(f"RCM reordering applied ({csr.nr} rows)")
        if param.fmt == "auto":
            from sparsebench.formats.dia import DiaUnsuitableError

            try:
                A = from_csr("dia", csr, policy)
                param.fmt = "dia"
            except DiaUnsuitableError:
                A = from_csr("bslab", csr, policy, **sub_opts)
                param.fmt = "bslab"
        else:
            extra = dict(sub_opts) if param.fmt == "bslab" else {}
            A = from_csr(
                param.fmt, csr, policy, C=param.chunk_height,
                sigma=param.sigma, **extra,
            )
        total_nr = csr.total_nr
        model_nnz = (
            csr.model_total_nnz if csr.model_total_nnz > 0 else csr.total_nnz
        )
    print(f"Setup took {time.perf_counter() - t0:.2f}s (format {param.fmt})")
    from sparsebench.formats.base import physical_spmv_bytes

    xb = policy.value_bytes
    phys = physical_spmv_bytes(A, xb) - (A.nc + A.nr) * xb
    print(
        f"SpMV streams {phys / max(1, A.nnz):.1f} B/nnz physical "
        f"(stored dtypes x padding) vs the reference model's "
        f"{policy.value_bytes + policy.index_bytes} B/nnz"
    )

    prof = Profiler()
    prof.init_factors(
        total_nr, model_nnz, policy.value_bytes, policy.index_bytes
    )

    def make_vectors():
        if rgl:
            # RGL row sums are exactly 1 (host/rgl.py): b = A @ 1 = ones,
            # exact solution x == 1 — the same oracle as the stencil.
            n = A.nr
            return (np.zeros(n, policy.value), np.ones(n, policy.value),
                    np.ones(n, policy.value))
        return init_vectors(csr, dtype=policy.value, generated=generated,
                            row_lengths=row_counts)

    def make_inv_diag(announce: bool = True):
        """1/diag(A) for --precond jacobi (any solver), original row order."""
        if csr is not None:
            d = csr.diagonal()
        elif generated:
            # analytic stencil: the generator's diagonal is the constant
            # 27 for both the 27-pt and 7-pt variants (reference
            # src/matrix.c:87-92)
            d = np.full(A.nr, 27.0)
        else:
            # device-built operators without a host CSR (generateRGL):
            # the varying diagonal is not on the host — refusing beats
            # silently preconditioning with a wrong constant
            raise SystemExit(
                f"--precond {args.precond} needs the matrix diagonal on "
                "the host; generateRGL builds on device. Use --shards N "
                "(the host-spec RGL path) for preconditioned RGL solves."
            )
        if announce:
            print("Preconditioner: Jacobi")
        return np.where(d != 0, 1.0 / np.where(d != 0, d, 1), 1.0)

    def make_cheb_precond(inv_diag):
        """ChebPrecond from fused-Lanczos precond-mode bounds, for
        --precond cheb / cheb-jacobi (the latter estimates spec(D^-1 A))."""
        from sparsebench.solvers.precond import cheb_precond_for

        bdt = np.float64 if policy.value == np.float64 else np.float32
        permute = (A.permute_vector
                   if getattr(A, "permuted_output", False) else None)
        pc = cheb_precond_for(
            A, A.nr, bdt, degree=args.precond_degree,
            permute=permute, inv_diag=inv_diag,
        )
        scaled = " on D^-1 A" if inv_diag is not None else ""
        print(f"Preconditioner: Chebyshev(degree {pc.degree}, "
              f"bounds [{pc.lmin:.4g}, {pc.lmax:.4g}]){scaled}")
        return pc

    def resolve_precond_pair():
        """(inv_diag, precond) for the solver from --precond — the four
        resolve_apply_m combinations (solvers/precond.py)."""
        inv_diag = None
        precond = None
        if args.precond in ("jacobi", "cheb-jacobi"):
            inv_diag = make_inv_diag(announce=args.precond == "jacobi")
        if args.precond in ("cheb", "cheb-jacobi"):
            precond = make_cheb_precond(inv_diag)
        return inv_diag, precond

    def build_lo_matrix():
        """Low-precision twin of A (same layout, same row order) for
        --refine: rebuilt from the same spec one value-dtype down."""
        from sparsebench.solvers.refine import refine_lo_policy

        lo, lo_name = refine_lo_policy(policy)
        print(f"Refinement: outer {args.dtype or 'f32'} sweeps, "
              f"inner CG in {lo_name}")
        if param.fmt == "stencil":
            return A  # the matrix-free apply adopts the vector dtype
        if rgl:
            from sparsebench.formats.rgl_build import rgl_bslab

            A_lo, _nnz = rgl_bslab(
                param.nx * param.ny * param.nz, band=param.band,
                deg=param.deg, seed=param.seed, policy=lo,
                **sub_opts,
            )
            return A_lo
        if csr is None:
            # analytic on-device stencil build (dia / bslab)
            if param.fmt == "bslab":
                from sparsebench.formats.bslab import BslabMatrix

                A_lo, _rc = BslabMatrix.from_stencil(
                    param.nx, param.ny, param.nz,
                    use_7pt=param.filename == "generate7P",
                    policy=lo, **sub_opts,
                )
            else:
                from sparsebench.formats.dia import DiaMatrix

                A_lo, _rc = DiaMatrix.from_stencil(
                    param.nx, param.ny, param.nz,
                    use_7pt=param.filename == "generate7P",
                    policy=lo,
                )
            return A_lo
        extra = dict(sub_opts) if param.fmt == "bslab" else {}
        return from_csr(
            param.fmt, csr, lo, C=param.chunk_height, sigma=param.sigma,
            **extra,
        )

    iterations = 0
    with trace(args.trace):
        if param.bench == "cg":
            print("Test type: CG")
            x0, b, xexact = make_vectors()
            if args.precond in ("cheb", "cheb-jacobi") and (
                args.cg_variant not in ("standard", "cs", "pipe")
            ):
                raise SystemExit(
                    f"--precond {args.precond} combines with "
                    "--cg-variant standard/cs/pipe only"
                )
            inv_diag, precond = resolve_precond_pair()
            if args.precond != "none" and (args.checkpoint or args.profile):
                raise SystemExit(
                    "--precond combines with the plain CG path only"
                )
            if args.cg_variant != "standard" and (args.checkpoint
                                                  or args.profile):
                raise SystemExit(
                    "--cg-variant combines with the plain CG path only"
                )
            if args.nrhs > 1:
                from sparsebench.solvers.cg_multi import solve_cg_multi

                print(f"Blocked CG: {args.nrhs} right-hand sides")
                B = np.repeat(np.asarray(b)[:, None], args.nrhs, axis=1)
                res = solve_cg_multi(A, B, itermax=param.itermax,
                                     eps=param.eps)
                if xexact is not None:  # shared tail checks all columns
                    xexact = np.repeat(np.asarray(xexact)[:, None],
                                       args.nrhs, axis=1)
            elif args.refine:
                from sparsebench.solvers.refine import solve_cg_refine

                res = solve_cg_refine(
                    A, b, A_lo=build_lo_matrix(),
                    outer_max=args.refine_sweeps,
                    inner_iters=param.itermax, eps=param.eps,
                )
            elif args.checkpoint:
                from sparsebench.solvers.checkpoint import (
                    solve_cg_checkpointed,
                )

                res = solve_cg_checkpointed(
                    A, b, checkpoint_path=args.checkpoint,
                    checkpoint_every=args.checkpoint_every,
                    itermax=param.itermax, eps=param.eps,
                )
            elif args.profile:
                res = solve_cg_profiled(
                    A, b, prof, itermax=param.itermax, eps=param.eps
                )
            else:
                res = solve_cg(A, b, itermax=param.itermax, eps=param.eps,
                               inv_diag=inv_diag, precond=precond,
                               variant=args.cg_variant, sstep=args.sstep)
                print(prof.report_aggregate(res.iterations,
                                            res.solve_seconds))
            iterations = res.iterations
            if xexact is not None:
                diff = check_residual(res.x, xexact)
                print(f"Difference between computed and exact  = {diff:f}")
        elif param.bench == "spmv":
            print("Test type: SPMVM")
            bench_spmv(A, prof, itermax=param.itermax, fused_reps=20)
            iterations = param.itermax - 1 if param.itermax > 1 else 1
        elif param.bench == "gmres":
            print("Test type: GMRES")
            from sparsebench.solvers.gmres import solve_gmres

            b = np.ones(A.nr, dtype=policy.value)
            inv_diag, precond = resolve_precond_pair()
            res = solve_gmres(A, b, itermax=param.itermax, eps=param.eps,
                              orth=args.orth, inv_diag=inv_diag,
                              precond=precond, restart=args.restart)
            iterations = res.iterations
        elif param.bench == "cheb":
            print("Test type: CHEBFD")
            from sparsebench.solvers.chebyshev import solve_chebyshev

            x0, b, xexact = make_vectors()
            inv_diag = (make_inv_diag() if args.precond == "jacobi"
                        else None)
            res = solve_chebyshev(A, b, itermax=param.itermax, eps=param.eps,
                                  inv_diag=inv_diag)
            iterations = res.iterations
            if xexact is not None:
                diff = check_residual(res.x, xexact)
                print(f"Difference between computed and exact  = {diff:f}")
        elif param.bench == "bicgstab":
            print("Test type: BICGSTAB")
            from sparsebench.solvers.bicgstab import solve_bicgstab

            x0, b, xexact = make_vectors()
            inv_diag, precond = resolve_precond_pair()
            res = solve_bicgstab(A, b, itermax=param.itermax,
                                 eps=param.eps, inv_diag=inv_diag,
                                 precond=precond)
            iterations = res.iterations
            if xexact is not None:
                diff = check_residual(res.x, xexact)
                print(f"Difference between computed and exact  = {diff:f}")
        elif param.bench == "minres":
            print("Test type: MINRES")
            from sparsebench.solvers.minres import solve_minres

            x0, b, xexact = make_vectors()
            # Jacobi only: MINRES needs M SPD; p_k(A) of an indefinite A
            # is not (solvers/minres.py module doc) — cheb/cheb-jacobi
            # already exit above via the cheb-bench restriction
            inv_diag = (make_inv_diag() if args.precond == "jacobi"
                        else None)
            res = solve_minres(A, b, itermax=param.itermax, eps=param.eps,
                               inv_diag=inv_diag)
            iterations = res.iterations
            if xexact is not None:
                diff = check_residual(res.x, xexact)
                print(f"Difference between computed and exact  = {diff:f}")

    if (args.profile and param.bench == "cg") or param.bench == "spmv":
        # gated to the benches that feed the timers (warned above)
        print(prof.report(iterations))
    return 0


if __name__ == "__main__":
    sys.exit(main())
