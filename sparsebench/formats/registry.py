"""Runtime format registry.

Replaces the reference's compile-time format selection (one
``matrix-$(MTX_FMT).o`` linked per binary, Makefile:20,32; ``#ifdef``
dispatch in src/matrix.h:14-22) with a name -> class mapping.
"""

from __future__ import annotations

from typing import Dict, Type

FORMATS: Dict[str, type] = {}


def register_format(name: str):
    def deco(cls):
        FORMATS[name] = cls
        cls.name = name
        return cls

    return deco


def get_format(name: str) -> Type:
    try:
        return FORMATS[name]
    except KeyError:
        raise ValueError(
            f"unknown matrix format {name!r}; available: {sorted(FORMATS)}"
        ) from None


def from_csr(name: str, csr, policy=None, **opts):
    """Build a device matrix of format ``name`` from the CSR intermediate
    (the reference's ``convertMatrix(Matrix*, GMatrix*)``, src/matrix.h:56)."""
    return get_format(name).from_csr(csr, policy=policy, **opts)


def _register_builtin_formats() -> None:
    # Imported for registration side effects.
    from sparsebench.formats import (  # noqa: F401
        bslab,
        crs,
        dia,
        sell,
        stencil,
    )


_register_builtin_formats()
