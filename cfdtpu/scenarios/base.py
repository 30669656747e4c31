"""Scenario base class: solver loading, the time loop, outputs, early stop.

Faithful rebuild of the reference Scenario contract
(/root/reference/src/scenario.py:20-360): abstract mesh/bcu/bcp properties,
solver discovery by module name with kwarg filtering (:61-105), the
time-stepping loop that writes per-step output, logs L2 error against an
exact solution when provided (:231-256), checks the early-stop criterion
(||u_sol - u_prev||_inf / ||u_sol||_inf) / dt < tol every 10 steps
(:268-304), and writes final L2 norms (:315-323).
"""

from __future__ import annotations

import inspect
import os
import sys
from abc import ABC, abstractmethod
from importlib import import_module
from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp

from ..mesh import Mesh
from ..spaces import BoundaryCondition
from ..solvers.base import SolverBase


class Scenario(ABC):
    @property
    @abstractmethod
    def mesh(self) -> Mesh:
        ...

    @property
    @abstractmethod
    def bcu(self) -> list[BoundaryCondition]:
        ...

    @property
    @abstractmethod
    def bcp(self) -> list[BoundaryCondition]:
        ...

    @abstractmethod
    def initial_velocity(self, x: np.ndarray) -> np.ndarray:
        ...

    def exact_velocity(self, t):
        pass

    def __init__(
        self,
        solver_name: str,
        scenario_name: str,
        rho: float,
        mu: float,
        dt: float,
        T: float,
        f,
        early_stop_tolerance: float = 1e-3,
        output_every: int = 1,
        checkpoint_every: int = 0,
        resume_from: str | None = None,
        **solver_kwargs,
    ):
        self.solver_name = solver_name
        self.scenario_name = scenario_name
        self.early_stop_tolerance = early_stop_tolerance
        self.output_every = max(1, int(output_every))
        self.checkpoint_every = int(checkpoint_every)
        self.resume_from = resume_from

        try:
            solver_module = import_module(f"cfdtpu.solvers.{solver_name}")
        except ImportError as e:
            available = self._list_available_solvers()
            raise ImportError(
                f"Could not import solver '{solver_name}'. "
                f"Ensure cfdtpu/solvers/{solver_name}.py exists and all its "
                f"dependencies are available.\nUnderlying error: {e}\n"
                f"Available solvers: {available}"
            ) from e

        if not hasattr(solver_module, "Solver"):
            raise ValueError(
                f"Solver module 'cfdtpu/solvers/{solver_name}.py' does not "
                f"define a 'Solver' class."
            )

        self.solverClass: type[SolverBase] = solver_module.Solver

        sig = inspect.signature(self.solverClass.__init__)
        accepted = sig.parameters
        has_var_keyword = any(
            p.kind == inspect.Parameter.VAR_KEYWORD for p in accepted.values()
        )
        filtered_kwargs = (
            solver_kwargs
            if has_var_keyword
            else {k: v for k, v in solver_kwargs.items() if k in accepted}
        )
        try:
            self.solver = self.solverClass(
                self.mesh,
                dt,
                rho,
                mu,
                f,
                initial_velocity=self.initial_velocity,
                **filtered_kwargs,
            )
        except TypeError as e:
            raise RuntimeError(
                f"Failed to instantiate solver '{solver_name}': {e}. Check "
                f"that the Solver class has the correct constructor signature."
            ) from e

        self.T = T
        self.has_exact_solution = (
            self.__class__.exact_velocity is not Scenario.exact_velocity
        )
        self.dt = dt
        self._is_setup = False

    @staticmethod
    def _list_available_solvers():
        solvers_dir = os.path.join(
            os.path.dirname(os.path.dirname(__file__)), "solvers"
        )
        try:
            files = os.listdir(solvers_dir)
            solvers = [
                f[:-3]
                for f in files
                if f.endswith(".py") and not f.startswith("_")
                and f != "base.py"
            ]
            return solvers if solvers else ["(none found)"]
        except OSError:
            return ["(could not list)"]

    # ------------------------------------------------------------------
    @property
    def facet_tags(self):
        return getattr(self, "_ft", None)

    @property
    def tags(self) -> dict:
        return {
            "inlet": getattr(self, "inlet_marker", None),
            "outlet": getattr(self, "outlet_marker", None),
            "wall": getattr(self, "wall_marker", None),
            "obstacle": getattr(self, "obstacle_marker", None),
        }

    def setup(self):
        if self._is_setup:
            return
        self.solver.setup(
            self.bcu, self.bcp, facet_tags=self.facet_tags, tags=self.tags
        )
        self._is_setup = True

        num_dofs_V = self.solver.V.num_global_dofs
        num_dofs_Q = self.solver.Q.num_global_dofs
        total = num_dofs_V + num_dofs_Q
        print(
            f"DOFs: {total} (Velocity: {num_dofs_V}, Pressure: {num_dofs_Q})"
        )
        print(f"Suggested cores: {total / 20000:.1f}")

    # ------------------------------------------------------------------
    def solve(
        self, output_folder: str,
        afterStepCallback: Callable[[float], None] | None = None,
    ) -> str:
        """Run the time loop; returns the output folder path."""
        from ..io import VTUSeriesWriter

        from ..dist.process import _NullWriter, is_main_process

        solver = self.solver
        mesh = self.mesh
        T = self.T
        main = is_main_process()  # rank-0 I/O guard
        # (reference: single-writer VTX files, src/scenario.py:151-164)
        if main:
            os.makedirs(output_folder, exist_ok=True)

        solver.initStressForm()
        if main:
            writers = {
                "v": VTUSeriesWriter(
                    f"{output_folder}/v", mesh, "velocity"
                ),
                "p": VTUSeriesWriter(
                    f"{output_folder}/p", mesh, "pressure"
                ),
                "u_residual": VTUSeriesWriter(
                    f"{output_folder}/u_residual", mesh, "u_residual"
                ),
                "p_residual": VTUSeriesWriter(
                    f"{output_folder}/p_residual", mesh, "p_residual"
                ),
                "wss": VTUSeriesWriter(
                    f"{output_folder}/wss", mesh, "shear_stress"
                ),
            }
        else:
            writers = {k: _NullWriter() for k in
                       ("v", "p", "u_residual", "p_residual", "wss")}

        t = 0.0
        i = 0
        if self.resume_from:
            t, i = self.load_checkpoint(self.resume_from)
            print(f"[checkpoint] resumed from {self.resume_from} at "
                  f"t={t:.4f} (step {i})")
        else:
            solver.u_sol = jnp.asarray(
                solver.V.interpolate(self.initial_velocity)
            )
        solver.assemble_wss()

        def write_all(t):
            writers["v"].write(t, solver.u_sol)
            writers["p"].write(t, solver.p_sol)
            writers["u_residual"].write(t, solver.u_residual)
            writers["p_residual"].write(t, solver.p_residual)
            writers["wss"].write(t, solver.shear_stress)

        write_all(t)
        # line-buffered: long runs killed by a timeout must still leave
        # their per-step stats behind (the checkpoint alone is not
        # enough to diagnose solver behaviour post-mortem)
        stats_log = (
            open(f"{output_folder}/solver_stats.txt", "w", buffering=1)
            if main else _NullWriter()
        )
        stats_log.write("# step t wall_s newton_iters ksp_iters fnorm\n")

        error_log = None
        if self.has_exact_solution and main:
            error_log = open(f"{output_folder}/err.txt", "w", buffering=1)
            error = self.compute_error_at(t)
            error_log.write("t = %.3f: error = %.3g\n" % (t, error))

        import time as _time

        # --monitor analogue of the reference's -snes_monitor/-ksp_monitor
        # PETSc options (/root/reference/src/utils/hpc.py:499-506):
        # per-step solver stats echoed to stdout, not just solver_stats.txt
        monitor = os.environ.get("CFDTPU_MONITOR") == "1"

        # the trace starts after the first step, which compiles
        trace_dir = os.environ.get("CFDTPU_PROFILE")
        tracing = False

        while t < T:
            if trace_dir and i == 1 and not tracing:
                jax.block_until_ready(solver.u_sol)
                jax.profiler.start_trace(trace_dir)
                tracing = True
                print(f"[profile] tracing to {trace_dir}")
            _t0 = _time.perf_counter()
            solver.solveStep()
            _wall = _time.perf_counter() - _t0
            i += 1
            t += self.dt
            st = getattr(solver, "last_stats", {})
            if not st.get("skipped"):
                # unfetched steps (stats_every > 1) carry no numbers —
                # suppress the row rather than corrupt the series with
                # zeros/NaNs that the campaign/--monitor tooling reads
                stats_log.write(
                    f"{i} {t:.6f} {_wall:.4f} "
                    f"{st.get('newton_iters', 0)} "
                    f"{st.get('ksp_iters', 0)} "
                    f"{st.get('fnorm', float('nan'))}\n"
                )
            if monitor and main and not st.get("skipped"):
                print(
                    f"  [monitor] step {i} t={t:.4f} "
                    f"wall={_wall:.2f}s "
                    f"newton={st.get('newton_iters', 0)} "
                    f"ksp={st.get('ksp_iters', 0)} "
                    f"fnorm={st.get('fnorm', float('nan')):.3e}",
                    flush=True,
                )
            if self.has_exact_solution:
                error = self.compute_error_at(t)
                error_log.write("t = %.3f: error = %.3g\n" % (t, error))

            if i % self.output_every == 0:
                solver.assemble_wss()
                write_all(t)

            if afterStepCallback:
                afterStepCallback(t)

            # checkpoint AFTER the step callback: per-step series
            # recorders (e.g. the DFG 2D-2 force recorder) must have seen
            # step i before the step-i checkpoint exists, so a resumed
            # leg's series can be reconciled exactly to the checkpoint
            if self.checkpoint_every and i % self.checkpoint_every == 0:
                self.pre_checkpoint()
                self.save_checkpoint(
                    os.path.join(output_folder, "checkpoint.npz"), t, i
                )

            if (i + 1) % 10 == 0:
                # one fused fetch: one host sync instead of two
                u_sol_norm, u_diff_norm = (
                    float(x) for x in jax.device_get(jnp.stack([
                        jnp.abs(solver.u_sol).max(),
                        jnp.abs(solver.u_sol - solver.u_prev).max(),
                    ]))
                )
                rel_diff = (u_diff_norm / max(u_sol_norm, 1e-12)) / self.dt
                if rel_diff < self.early_stop_tolerance:
                    print(
                        f"Early stopping at t={t:.3f}, because "
                        f"(||u_sol - u_prev||_inf / ||u_sol||_inf) / dt = "
                        f"{rel_diff:.20e} < {self.early_stop_tolerance}"
                    )
                    break

            solver.u_prev = solver.u_sol
            solver.p_prev = solver.p_sol

        if tracing:
            jax.block_until_ready(solver.u_sol)
            jax.profiler.stop_trace()
        for w in writers.values():
            w.close()
        stats_log.close()
        if self.checkpoint_every:
            self.pre_checkpoint()
            self.save_checkpoint(
                os.path.join(output_folder, "checkpoint.npz"), t, i
            )

        norm_v = float(jnp.sqrt(solver.l2_norm_sq(solver.u_sol)))
        norm_p = float(jnp.sqrt(solver.l2_norm_sq(solver.p_sol)))
        if main:
            with open(os.path.join(output_folder, "norms.txt"), "w") as f:
                f.write(f"L2 norm of velocity: {norm_v}\n")
                f.write(f"L2 norm of pressure: {norm_p}\n")

        if error_log:
            error_log.close()

        return output_folder

    # ------------------------------------------------------------------
    # Checkpoint / resume: the reference has no solver-state
    # checkpointing (SURVEY.md 5.4); with array state it is a single
    # npz of (u_sol, p_sol, u_prev, p_prev, t, step).
    # ------------------------------------------------------------------
    def pre_checkpoint(self) -> None:
        """Hook called immediately before every save_checkpoint. Scenario
        subclasses that buffer per-step series device-side (DFG 2D-2
        force recorder) override/assign this to flush, so the on-disk
        series never trails the checkpoint it will be resumed from."""

    # solver history beyond (u_sol, p_sol, u_prev, p_prev) that multistep
    # schemes need across a resume: BDF2's u^{n-1} (stabilized family)
    # and the IPCS-BDF2 extrapolation state
    _CKPT_HISTORY = ("u_prev2", "u_n1")

    def save_checkpoint(self, path: str, t: float, step: int) -> None:
        from ..dist.process import is_main_process

        if not is_main_process():
            return
        s = self.solver
        extra = {
            name: np.asarray(getattr(s, name))
            for name in self._CKPT_HISTORY
            if getattr(s, name, None) is not None
        }
        np.savez(
            path,
            u_sol=np.asarray(s.u_sol), p_sol=np.asarray(s.p_sol),
            u_prev=np.asarray(s.u_prev), p_prev=np.asarray(s.p_prev),
            t=t, step=step, **extra,
        )

    def load_checkpoint(self, path: str) -> tuple[float, int]:
        data = np.load(path)
        s = self.solver
        s.u_sol = jnp.asarray(data["u_sol"])
        s.p_sol = jnp.asarray(data["p_sol"])
        s.u_prev = jnp.asarray(data["u_prev"])
        s.p_prev = jnp.asarray(data["p_prev"])
        for name in self._CKPT_HISTORY:
            if getattr(s, name, None) is None:
                continue
            if name in data.files:
                setattr(s, name, jnp.asarray(data[name]))
            elif name == "u_n1":
                # pre-history checkpoint: the IPCS-BDF2 extrapolation
                # falls back to its own t=0 convention u_n1 = u_prev
                s.u_n1 = s.u_prev
            else:
                # BDF2-family u_prev2 missing: step_count > 0 would
                # select full BDF2 coefficients against a zero u_prev2
                # and inject a large spurious transient — tell the
                # solver to self-heal with one BDF1 step instead
                s._resume_lost_history = True
        # restore the solver's step counter too: step-indexed behaviour
        # (BC ramping over the first N steps, pc_lag rebuild phase) must
        # not restart from 0 on a resumed march — a re-applied ramp
        # would collapse the developed inflow back to alpha = 1/N
        s.step_count = int(data["step"])
        return float(data["t"]), int(data["step"])

    # ------------------------------------------------------------------
    def compute_error_at(self, t: float) -> float:
        """Relative L2 error of u_sol against exact_velocity(t)."""
        u_e = jnp.asarray(
            self.solver.V.interpolate(lambda x: self.exact_velocity(t)(x))
        )
        return self.compute_error(u_e, self.solver.u_sol)

    def compute_error(self, u, u_aprox) -> float:
        err = float(jnp.sqrt(self.solver.l2_norm_sq(u_aprox - u)))
        norm = float(jnp.sqrt(self.solver.l2_norm_sq(u)))
        return err / norm
