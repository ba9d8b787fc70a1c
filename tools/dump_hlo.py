"""`make asm` analog (reference Makefile:26-30 emits per-object assembly
listings): dump the optimizer's output for the hot solves so kernel-level
changes can be inspected without a GPU.

Writes, per format in {dia, stencil}:
  build/asm/cg_<fmt>_lowered.txt    — StableHLO as traced (pre-optimization)
  build/asm/cg_<fmt>_optimized.txt  — the backend's optimized HLO

On the GPU the optimized text shows XLA's fused kernels; on the CPU it
is the portable equivalent. Usage:
    python tools/dump_hlo.py [outdir]   (or `make asm`)
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main(outdir: str = "build/asm") -> int:
    import jax
    import jax.numpy as jnp

    from sparsebench.config import DTypePolicy
    from sparsebench.formats.dia import DiaMatrix
    from sparsebench.formats.stencil import StencilOperator
    from sparsebench.solvers.cg import cg_loop, init_vectors

    os.makedirs(outdir, exist_ok=True)
    policy = DTypePolicy.from_names("f32", "i32")
    n = 16

    builds = {
        "dia": lambda: DiaMatrix.from_stencil(n, n, n, policy=policy),
        "stencil": lambda: StencilOperator.from_stencil(n, n, n,
                                                        policy=policy),
    }
    for name, build in builds.items():
        A, counts = build()
        _, b, _ = init_vectors(row_lengths=counts, dtype=np.float32)
        b_in = (A.permute_vector(jnp.asarray(b))
                if getattr(A, "permuted_output", False) else jnp.asarray(b))
        x0 = jnp.zeros_like(b_in)

        def step(A, b, x0, eps):
            x, k, hist = cg_loop(A, b, x0, itermax=10, eps=eps)
            return x, hist

        lowered = jax.jit(step).lower(A, b_in, x0, jnp.float32(0))
        with open(os.path.join(outdir, f"cg_{name}_lowered.txt"), "w") as f:
            f.write(lowered.as_text())
        compiled = lowered.compile()
        with open(os.path.join(outdir, f"cg_{name}_optimized.txt"), "w") as f:
            f.write(compiled.as_text())
        print(f"{name}: wrote cg_{name}_{{lowered,optimized}}.txt "
              f"({jax.default_backend()} backend)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "build/asm"))
