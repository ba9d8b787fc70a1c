"""sparsebench — a sparse solver benchmark framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
RRZE-HPC/SparseBench (an MPI+OpenMP C benchmark of distributed CG and SpMV
over CRS / SELL-C-sigma / CCRS sparse formats; see SURVEY.md).

Design stance (not a port):
  * compile-time C polymorphism (one matrix format per binary,
    reference Makefile:20,32) becomes runtime format objects registered in
    :mod:`sparsebench.formats`;
  * MPI rank SPMD (reference src/comm.c) becomes ``shard_map`` over a
    ``jax.sharding.Mesh`` with XLA collectives (psum / ppermute / all_gather);
  * OpenMP/SIMD loops (reference src/matrix-*.c, src/solver.c) become XLA
    fused element-wise ops and reductions;
  * the two-stage matrix representation is kept: host ingest produces a
    :class:`~sparsebench.host.csr.HostCSR` intermediate (the reference's
    ``GMatrix``, src/matrix.h:29-35) which is lowered to a device-resident
    format before the solve.

Public API: the config/host names below import eagerly (numpy-only);
everything touching jax is a PEP 562 lazy re-export so that
``import sparsebench`` stays backend-free — the CLI's host-only
paths (``-c file.mtx`` conversion, ``--help``) must not initialize a
backend (which would reserve most of the GPU's memory for nothing).

    from sparsebench import (
        Parameter, DTypePolicy,               # config + .par files
        HostCSR, read_mm, generate_stencil,   # host ingest
        from_csr,                             # device format registry
        solve_cg, solve_gmres, solve_chebyshev,   # serial solvers
        build_distributed, dist_solve_cg,         # mesh-sharded solve
        Profiler,                             # region roofline report
    )
"""

from sparsebench import _malloc_tuning

# Pooled allocator + malloc tuning for the lazy-memory dev VM (the
# reference's `allocate` analog, SURVEY §2.14) — ctypes/os only, no jax.
_malloc_tuning.apply()

from sparsebench.version import __version__  # noqa: E402
from sparsebench.config import (  # noqa: E402
    DTypePolicy,
    Parameter,
    read_parameter,
)

# jax-touching names resolve lazily on first attribute access
_LAZY_EXPORTS = {
    # host ingest (numpy-only, but kept lazy for import-time symmetry)
    "HostCSR": "sparsebench.host",
    "read_mm": "sparsebench.host",
    "generate_stencil": "sparsebench.host",
    # device formats (imports jax)
    "from_csr": "sparsebench.formats",
    # solvers (import jax)
    "solve_cg": "sparsebench.solvers.cg",
    "check_residual": "sparsebench.solvers.cg",
    "init_vectors": "sparsebench.solvers.cg",
    "solve_gmres": "sparsebench.solvers.gmres",
    "solve_chebyshev": "sparsebench.solvers.chebyshev",
    "solve_bicgstab": "sparsebench.solvers.bicgstab",
    "solve_minres": "sparsebench.solvers.minres",
    # distributed (imports jax)
    "build_distributed": "sparsebench.parallel.dist",
    "dist_solve_cg": "sparsebench.parallel.dist",
    "dist_spmv": "sparsebench.parallel.dist",
    # profiler (host-side timers)
    "Profiler": "sparsebench.profiler",
}

__all__ = [
    "__version__",
    "Parameter",
    "read_parameter",
    "DTypePolicy",
    *_LAZY_EXPORTS,
]


def __getattr__(name: str):
    mod = _LAZY_EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        )
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(__all__)
