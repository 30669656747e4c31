"""Pipe-with-cylinder scenario (DFG geometry twin).

Rebuild of /root/reference/src/scenarios/pipe_cylinder.py: the dfg_1
geometry with parabolic inlet and p = 0 Dirichlet outlet; the
benchmark-data twin of the FEATFLOW DFG reference series shipped in
cfdtpu/validation (reference keeps them in src/benchmark_data/pipe_cylinder).
"""

from __future__ import annotations

import os

import numpy as np

from ..geom.dfg import generate_dfg_mesh
from ..spaces import BoundaryCondition
from ..utils import resolve_dtype
from .base import Scenario


class PipeCylinderSimulation(Scenario):
    fluid_marker = 1
    inlet_marker = 2
    outlet_marker = 3
    wall_marker = 4
    obstacle_marker = 5

    def __init__(
        self,
        solver_name,
        dt,
        T,
        f=(0, 0),
        *,
        rho=1,
        mu=1 / 1000,
        u_max=0.3,
        res_scale=1.0,
        dtype="auto",
        **solver_kwargs,
    ):
        self._mesh = None
        self._bcu = None
        self._bcp = None
        self.u_max = float(u_max)
        self.res_scale = float(res_scale)
        self._dtype = resolve_dtype(dtype)
        super().__init__(
            solver_name, "pipe_cylinder", rho, mu, dt, T, f,
            **solver_kwargs,
        )
        self.setup()

    @property
    def mesh(self):
        if self._mesh is None:
            self._mesh = generate_dfg_mesh(
                res_scale=self.res_scale, dtype=self._dtype,
                inlet_marker=self.inlet_marker,
                outlet_marker=self.outlet_marker,
                wall_marker=self.wall_marker,
                obstacle_marker=self.obstacle_marker,
            )
        return self._mesh

    @property
    def bcu(self):
        if self._bcu is None:
            u_max = self.u_max

            def inlet(x):
                values = np.zeros((2, x.shape[1]))
                values[0] = 4 * u_max * x[1] * (0.41 - x[1]) / (0.41 ** 2)
                return values

            bcu_in = BoundaryCondition(inlet)
            bcu_in.initTopological(
                1, self.mesh.tagged_facets(self.inlet_marker)
            )
            bcu_walls = BoundaryCondition(np.zeros(2, dtype=self._dtype))
            bcu_walls.initTopological(
                1, self.mesh.tagged_facets(self.wall_marker)
            )
            bcu_obs = BoundaryCondition(np.zeros(2, dtype=self._dtype))
            bcu_obs.initTopological(
                1, self.mesh.tagged_facets(self.obstacle_marker)
            )
            self._bcu = [bcu_in, bcu_obs, bcu_walls]
        return self._bcu

    @property
    def bcp(self):
        if self._bcp is None:
            bc_out = BoundaryCondition(0.0)
            bc_out.initTopological(
                1, self.mesh.tagged_facets(self.outlet_marker)
            )
            self._bcp = [bc_out]
        return self._bcp

    def initial_velocity(self, x):
        return np.zeros((2, x.shape[1]), dtype=self._dtype)


class PipeCylinder2D2Simulation(PipeCylinderSimulation):
    """DFG 2D-2: unsteady periodic vortex shedding at Re = 100
    (u_max = 1.5, U_mean = 1.0). Writes a per-step `bdforces.txt` with
    columns `timestep time cd cl` — the same quantities as the FEATFLOW
    reference series the reference repo ships as oracles
    (/root/reference/src/benchmark_data/pipe_cylinder/bdforces_q2_lv3_dt3:1-8,
    shipped subset: cfdtpu/validation/data/pipe_cylinder). Compare with
    cfdtpu.validation.dfg.featflow_reference_stats / DFG_2D2_INTERVALS
    (c_Dmax, c_Lmax, Strouhal) once the shedding is developed
    (scripts/validate_dfg2d2.py)."""

    def __init__(self, solver_name, dt, T, **kw):
        kw.setdefault("u_max", 1.5)
        kw.setdefault("mu", 1e-3)
        self._force_rows = []
        super().__init__(solver_name, dt, T, **kw)

    def _coef_scale(self):
        # c = 2 F / (rho U_mean^2 L), U_mean = 2/3 u_max, L = 0.1
        um = 2.0 / 3.0 * self.u_max
        return 2.0 / (float(self.solver.rho) * um * um * 0.1)

    def solve(self, output_folder, afterStepCallback=None):
        import jax
        import jax.numpy as jnp

        from ..postprocess.forces import BoundaryForce

        bf = BoundaryForce(
            self.solver.V, self.solver.Q,
            self.mesh.tagged_facets(self.obstacle_marker),
        )
        scale = self._coef_scale()
        self._force_rows = []
        # forces stay ON DEVICE during the march: a float() per step is
        # a host sync that serializes the async dispatch queue, over
        # thousands of shedding steps. Pairs
        # are packed into (64, 2) chunks device-side; each full chunk is
        # fetched in ONE batched device_get and appended to
        # bdforces_partial.txt, so a run killed mid-march (crash,
        # timeout) keeps its series up to the last flush and a
        # checkpoint-resumed continuation appends to it seamlessly.
        from ..dist.process import is_main_process

        main = is_main_process()
        part_path = os.path.join(output_folder, "bdforces_partial.txt")
        if self.resume_from and os.path.exists(part_path):
            # Reconcile the partial series against the checkpoint we are
            # about to resume from: flush cadence (64 rows) and
            # checkpoint cadence are independent, so a leg killed
            # mid-march may have flushed PAST the checkpoint step —
            # replaying from the checkpoint would then append duplicate
            # rows with time jumping backward (non-monotonic t breaks
            # the zero-crossing Strouhal/period stats). Row index k
            # holds step k+1, so a checkpoint at step c owns exactly the
            # first c rows; drop anything beyond. (The trailing case —
            # rows missing BEHIND the checkpoint — cannot happen: the
            # pre_checkpoint hook below flushes before every save.)
            step_ckpt = int(np.load(self.resume_from)["step"])
            prior = np.loadtxt(part_path, ndmin=2)
            self._force_rows = [
                (int(r[0]), float(r[1]), float(r[2]), float(r[3]))
                for r in prior if int(r[0]) < step_ckpt
            ]
            if main and len(self._force_rows) < prior.shape[0]:
                with open(part_path, "w") as f:
                    f.write("# timestep time cd cl\n")
                    for row in self._force_rows:
                        f.write(f"{row[0]} {row[1]:.6f} {row[2]:.8e} "
                                f"{row[3]:.8e}\n")
        elif main:
            os.makedirs(output_folder, exist_ok=True)
            with open(part_path, "w") as f:
                f.write("# timestep time cd cl\n")
        pend: list = []

        def flush():
            if not pend or not main:
                pend.clear()
                return
            ts = [t for t, _ in pend]
            arr = np.asarray(jax.device_get(
                jnp.stack([v for _, v in pend])
            ))
            pend.clear()
            base = len(self._force_rows)
            with open(part_path, "a") as f:
                for j in range(arr.shape[0]):
                    row = (base + j, ts[j], scale * float(arr[j, 0]),
                           scale * float(arr[j, 1]))
                    self._force_rows.append(row)
                    f.write(f"{row[0]} {row[1]:.6f} {row[2]:.8e} "
                            f"{row[3]:.8e}\n")

        def record(t):
            fd, fl = bf.drag_lift(
                self.solver.u_sol, self.solver.p_sol, self.solver.mu
            )
            pend.append((float(t), jnp.stack([fd, fl])))
            if len(pend) == 64:
                flush()
            if afterStepCallback:
                afterStepCallback(t)

        # flush before every checkpoint save (base.solve calls the hook
        # after the step callback has recorded the checkpointed step):
        # the on-disk partial can then never trail the checkpoint
        self.pre_checkpoint = flush
        try:
            out_path = super().solve(output_folder, record)
        finally:
            self.pre_checkpoint = lambda: None
        flush()
        if not main:
            return out_path
        with open(f"{out_path}/bdforces.txt", "w") as f:
            f.write("# timestep time cd cl\n")
            for row in self._force_rows:
                f.write(f"{row[0]} {row[1]:.6f} {row[2]:.8e} "
                        f"{row[3]:.8e}\n")
        return out_path
