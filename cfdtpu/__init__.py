"""cfdtpu — incompressible Navier-Stokes FEM framework for hemodynamics in JAX.

A ground-up JAX/XLA rebuild of the capabilities of the reference
FEniCSx/PETSc framework (JuanJoZP/cfd-hemodynamic): stabilized equal-order
finite elements, matrix-free Newton-Krylov solvers, hemodynamic boundary
conditions (weak pressure, Nitsche, backflow, resistance outlets), vascular
geometry scenarios and an experiment matrix — all designed for accelerator
execution:

- element kernels are vmapped JAX functions over cells,
- global assembly is scatter-add / segment_sum (no sparse matrices needed
  on the hot path),
- Newton linearization is matrix-free via jax.jvp (exact Jacobian action),
- Krylov solvers (FGMRES/CG) run fully under jit with lax loops,
- distribution is shard_map over mesh partitions with psum collectives
  (replacing MPI ghost updates / PETSc parallel assembly).

Double precision is enabled globally; all arrays carry explicit dtypes, so
float32 execution (the accelerator default) is selected per-simulation via
the `dtype` argument rather than a global flag.
"""

import jax

# Explicit-dtype discipline: enable x64 so float64 is *available*; every
# array in the framework is created with an explicit dtype, so the float32
# path simply constructs the mesh/state in float32.
jax.config.update("jax_enable_x64", True)

# On the GPU, float32 matmuls may otherwise run as TF32 (10-bit mantissa)
# on the tensor cores, which destroys Krylov orthogonalization (GMRES
# stagnates at its iteration cap). Full float32 products are required for
# the linear algebra; the matmuls here are small, so the cost is
# negligible.
jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"
