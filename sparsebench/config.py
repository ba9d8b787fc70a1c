"""Runtime configuration: parameters, .par files, and dtype policy.

Reference parity:
  * ``Parameter`` mirrors the reference struct {filename, nx, ny, nz,
    itermax, eps} (src/parameter.h:8-13) with the reference defaults
    (src/parameter.c:12-20: generate, 100^3, 150 iterations, eps 0).
  * ``read_parameter`` parses the same ``key value  # comment`` .par files
    (src/parameter.c:22-62; examples hpcg.par / hpcgmm.par).
  * The reference fixes CG_FLOAT / CG_UINT at compile time
    (config.mk:7-8, src/util.h:35-53). Here everything is runtime
    config: :class:`DTypePolicy` selects value/index dtypes per run.

Additions (no reference equivalent):
  * ``fmt`` / ``chunk_height`` / ``sigma`` are runtime parameters — the
    reference bakes the format into the binary and hard-codes C=sigma=1
    (src/matrix-SCS.c:42-43); its (stale) test-suite API treats them as
    runtime arguments (tests/common.h:20-23), which we adopt.
  * mesh/sharding controls for the distributed solve.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Parameter:
    """Benchmark parameters (reference src/parameter.h:8-13 + runtime extras)."""

    # --- reference-parity fields (src/parameter.c:12-20 defaults) ---
    filename: str = "generate"
    nx: int = 100
    ny: int = 100
    nz: int = 100
    itermax: int = 150
    eps: float = 0.0

    # --- runtime format selection (compile-time in the reference) ---
    fmt: str = "auto"          # auto | crs | ccrs | sell | ell | dia | bslab
                               # | stencil; auto: dia when the matrix is
                               # banded enough, else bslab
    chunk_height: int = 0      # SELL C; 0 = format default (32)
    sigma: int = 0             # SELL sigma sorting scope; 0 = format default
    # Value dtype default is f32, diverging from the reference's
    # PRECISION=double (config.mk:7): f32 CG converges the reference's
    # generated problem to max|x-1| ~ 2e-6 and halves the bytes per
    # iteration. `--dtype f64` restores reference precision (native on
    # the GPU); whether f64 should be the default is an open question.
    dtype: str = "f32"         # value dtype: f64 | f32 | bf16  (ref FLOAT_TYPE)
    index_dtype: str = "i32"   # index dtype: i32 | i64         (ref UINT_TYPE)

    # --- distributed controls ---
    shards: int = 1            # number of mesh devices for the row partition
    exchange: str = "auto"     # halo exchange impl: auto | ppermute | allgather

    # --- generateRGL (irregular random-graph Laplacian, host/rgl.py) ---
    band: int = 512            # half-bandwidth of the random graph
    deg: float = 16.0          # target average degree
    seed: int = 1              # graph seed

    # --- bench type (reference -t flag, src/main.c:22,116-129) ---
    bench: str = "cg"          # cg | spmv | gmres | cheb | bicgstab


_INT_KEYS = {"nx", "ny", "nz", "itermax", "chunk_height", "sigma", "shards",
             "band", "seed"}
_REAL_KEYS = {"eps", "deg"}
_STR_KEYS = {"filename", "fmt", "dtype", "index_dtype", "exchange", "bench"}


def read_parameter(param: Parameter, filename: str) -> Parameter:
    """Parse a .par file into ``param`` (reference src/parameter.c:22-62).

    Grammar: one ``key value`` pair per line, ``#`` starts a comment,
    unknown keys are ignored — identical behavior to the reference's
    PARSE_PARAM macro chain, extended with the runtime keys above.
    """
    with open(filename, "r") as fp:
        for line in fp:
            line = line.split("#", 1)[0]
            toks = line.split()
            if len(toks) < 2:
                continue
            key, val = toks[0], toks[1]
            if key in _INT_KEYS:
                setattr(param, key, int(val))
            elif key in _REAL_KEYS:
                setattr(param, key, float(val))
            elif key in _STR_KEYS:
                setattr(param, key, val)
    return param


def print_parameter(param: Parameter) -> str:
    """Render parameters like the reference (src/parameter.c:66-73)."""
    lines = [
        "Parameters",
        "Iterative solver parameters:",
        f"\tMax iterations: {param.itermax}",
        f"\tepsilon (stopping tolerance) : {param.eps:f}",
    ]
    return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Value/index dtype selection (reference src/util.h:35-53, runtime here).

    ``value`` is the CG_FLOAT analog, ``index`` the CG_UINT analog. f64
    requires ``jax.config.update('jax_enable_x64', True)`` which
    :func:`ensure_x64` performs on demand.
    """

    value: np.dtype
    index: np.dtype

    @staticmethod
    def from_names(value: str = "f64", index: str = "i32") -> "DTypePolicy":
        vmap = {
            "f64": np.float64,
            "f32": np.float32,
            "bf16": None,  # resolved lazily to jnp.bfloat16
        }
        imap = {"i32": np.int32, "i64": np.int64}
        if value not in vmap:
            raise ValueError(f"unknown value dtype {value!r}")
        if index not in imap:
            raise ValueError(f"unknown index dtype {index!r}")
        if value == "bf16":
            import jax.numpy as jnp

            vdt = np.dtype(jnp.bfloat16)
        else:
            vdt = np.dtype(vmap[value])
        return DTypePolicy(value=vdt, index=np.dtype(imap[index]))

    @property
    def needs_x64(self) -> bool:
        return self.value == np.float64 or self.index == np.int64

    def ensure_x64(self) -> None:
        if self.needs_x64:
            import jax

            jax.config.update("jax_enable_x64", True)

    @property
    def value_bytes(self) -> int:
        return self.value.itemsize

    @property
    def index_bytes(self) -> int:
        return self.index.itemsize
