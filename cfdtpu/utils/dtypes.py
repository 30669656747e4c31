"""Precision policy.

The reference runs PETSc in float64 everywhere. dtype="auto" resolves to
float64 on the CPU backend and to float32 on an accelerator, where it is
sufficient for the engineering quantities (drag/lift, FFR, WSS) with the
looser Newton/Krylov tolerances below. float64 is native on the H100 too;
float32 stays the accelerator default because every record and
tolerance so far is float32, and the choice is to be remade per
benchmark cell from measurements (ROADMAP C6). Every scenario/solver
accepts an explicit dtype override.
"""

from __future__ import annotations

import numpy as np


def resolve_dtype(dtype) -> np.dtype:
    if dtype is None or dtype == "auto":
        import jax

        cpu = jax.default_backend() == "cpu"
        return np.dtype(np.float64 if cpu else np.float32)
    return np.dtype(dtype)


def default_tolerances(dtype) -> dict:
    """Dtype-appropriate Newton/Krylov tolerances (f64 values follow the
    reference PETSc defaults, stabilized_schur.py:269-273)."""
    if np.dtype(dtype) == np.float32:
        return {
            "snes_rtol": 1e-5,
            "snes_atol": 1e-8,
            "snes_stol": 1e-6,
            "ksp_rtol": 1e-4,
        }
    return {
        "snes_rtol": 1e-8,
        "snes_atol": 1e-10,
        "snes_stol": 1e-8,
        "ksp_rtol": 1e-5,
    }
