"""Simulation orchestrator.

Rebuild of /root/reference/src/simulation.py (same orchestration
contract, original implementation): validates arguments, loads the
scenario module dynamically (Scenario subclass picked by
introspection), filters constructor kwargs against the scenario
signature with helpful missing-parameter errors, builds the output
directory <output_dir>/<scenario>/<timestamp>_<name>/, writes
simulation_params.txt including the git commit, and runs the scenario.
"""

from __future__ import annotations

import inspect
import os
import subprocess
from datetime import datetime
from importlib import import_module
from pathlib import Path
from typing import Any, Callable, Optional, Type, Union

from .scenarios.base import Scenario


def resolve_scenario_class(module, scenario_name: str):
    """Pick the Scenario subclass a CLI scenario name means.

    Candidates are taken in DEFINITION order (vars(module) preserves
    it); inspect.getmembers is alphabetical, which used to pick
    PipeCylinder2D2Simulation for 'pipe_cylinder' and an IMPORTED base
    class for 'stenosis_with_tree_2d'. Classes defined in the module
    beat imported ones; a class whose normalized name matches the
    scenario name (modulo a Simulation/Benchmark/Scenario/Steady
    suffix) beats definition order. Returns None if the module defines
    no Scenario subclass."""
    members = [
        (k, v) for k, v in vars(module).items()
        if inspect.isclass(v) and issubclass(v, Scenario)
        and v is not Scenario
    ]
    own = [kv for kv in members if kv[1].__module__ == module.__name__]
    pool = own or members
    want = scenario_name.lower().replace("_", "")
    for k, v in pool:
        norm = k.lower().replace("_", "")
        if norm in (
            want, want + "simulation", want + "benchmark",
            want + "scenario", want + "steady",
        ):
            return v
    return pool[0][1] if pool else None


def _positive_float(label: str, raw) -> float:
    """Coerce a CLI-supplied time quantity, rejecting junk early so a
    bad flag fails at construction rather than mid-run."""
    try:
        val = float(raw)
    except (TypeError, ValueError) as e:
        raise ValueError(f"{label}={raw!r} is not a number") from e
    if val <= 0:
        raise ValueError(f"{label} must be > 0 (got {val})")
    return val


def filter_ctor_kwargs(cls, provided: dict) -> dict:
    """Keep only the entries of `provided` that `cls.__init__` accepts.

    This is the framework's config-passthrough mechanism (SURVEY §5.6):
    every layer forwards its whole kwarg pool and each constructor
    keeps what its signature names. Raises ValueError listing any
    required parameters the pool does not cover; if the signature has
    a **kwargs catch-all, the full pool goes through.
    """
    sig = inspect.signature(cls.__init__)
    accepted: dict = {}
    unmet = []
    catch_all = False
    for pname, param in sig.parameters.items():
        if pname == "self":
            continue
        if param.kind == inspect.Parameter.VAR_KEYWORD:
            catch_all = True
        elif pname in provided:
            accepted[pname] = provided[pname]
        elif param.default is inspect.Parameter.empty:
            unmet.append(pname)
    if unmet:
        hint = " ".join(f"--{p}=<value>" for p in unmet)
        raise ValueError(
            f"{cls.__name__} requires {unmet} but the run configuration "
            f"does not provide them; add e.g. {hint}"
        )
    if catch_all:
        accepted = {**provided, **accepted}
    return accepted


class Simulation:
    def __init__(
        self,
        name: str,
        simulation: Union[str, Type[Scenario]],
        solver: str,
        T: Union[float, str],
        dt: Union[float, str],
        output_dir: Union[str, Path] = "results",
        **kwargs: Any,
    ):
        for label, val in (("name", name), ("solver", solver)):
            if not (val and isinstance(val, str)):
                raise ValueError(f"'{label}' must be a non-empty string")
        if not simulation:
            raise ValueError(
                "'simulation' is required: a scenario module name or a "
                "Scenario subclass"
            )

        self.name = name
        self.solver_name = solver
        self.output_dir = output_dir
        self.kwargs = kwargs

        self._scenario_class_override = None
        if inspect.isclass(simulation) and issubclass(simulation, Scenario):
            self._scenario_class_override = simulation
            self.scenario_name = getattr(
                simulation, "__name__", "custom_scenario"
            )
        else:
            self.scenario_name = simulation

        self.T = _positive_float("T", T)
        self.dt = _positive_float("dt", dt)
        if self.dt > self.T:
            raise ValueError(
                f"time step dt={self.dt} exceeds the horizon T={self.T}"
            )

        self.mu = kwargs.get("mu")
        self.rho = kwargs.get("rho")

        self.scenario_instance = self._load_scenario()

    # ------------------------------------------------------------------
    def _load_scenario(self) -> Scenario:
        scenario_class = self._scenario_class_override

        if scenario_class is None:
            try:
                module = import_module(
                    f"cfdtpu.scenarios.{self.scenario_name}"
                )
            except ImportError as e:
                raise ImportError(
                    f"no scenario module cfdtpu/scenarios/"
                    f"{self.scenario_name}.py ({type(e).__name__}: {e}); "
                    f"known scenarios: "
                    f"{', '.join(self._list_available_scenarios())}"
                ) from e
            scenario_class = resolve_scenario_class(
                module, self.scenario_name
            )

        if scenario_class is None:
            raise ValueError(
                f"module cfdtpu.scenarios.{self.scenario_name} defines "
                f"no Scenario subclass"
            )

        pool = {
            "solver_name": self.solver_name,
            "dt": self.dt,
            "T": self.T,
            **self.kwargs,
        }
        try:
            init_args = filter_ctor_kwargs(scenario_class, pool)
        except ValueError as e:
            raise ValueError(
                f"scenario '{self.scenario_name}': {e}"
            ) from e

        print(
            f"  [SIM] Instantiating scenario "
            f"'{self.scenario_name}'...", flush=True
        )
        try:
            instance = scenario_class(**init_args)
        except TypeError as e:
            raise RuntimeError(
                f"scenario '{self.scenario_name}' rejected arguments "
                f"{sorted(init_args)}: {e}"
            ) from e
        print("  [SIM] Scenario instantiated OK.", flush=True)
        return instance

    @staticmethod
    def _list_available_scenarios() -> list[str]:
        here = Path(__file__).parent / "scenarios"
        try:
            names = sorted(
                p.stem for p in here.glob("*.py")
                if p.stem not in ("base",) and not p.stem.startswith("_")
            )
        except OSError:
            return ["(could not list)"]
        return names or ["(none found)"]

    # ------------------------------------------------------------------
    def run(
        self,
        save_path: Optional[Union[str, Path]] = None,
        afterStepCallback: Optional[Callable[[float], None]] = None,
    ) -> str:
        if save_path is None:
            stamp = datetime.now().strftime("%Y-%m-%dT%H.%M.%S")
            save_path = (
                Path(self.output_dir)
                / self.scenario_name
                / f"{stamp}_{self.name}"
            )
        save_path = os.path.abspath(save_path)

        # rank-0 I/O guard + barrier before compute, mirroring the
        # reference's `if rank == 0` + comm.barrier()
        # (/root/reference/src/simulation.py:229,267)
        from .dist.process import barrier, is_main_process

        if not is_main_process():
            barrier("simulation-setup")
            self.scenario_instance.setup()
            return self.scenario_instance.solve(
                output_folder=save_path, afterStepCallback=afterStepCallback
            )

        os.makedirs(save_path, exist_ok=True)
        self._write_params(save_path)

        print(
            f"Initializing simulation '{self.name}' with scenario "
            f"'{self.scenario_name}'..."
        )

        barrier("simulation-setup")
        self.scenario_instance.setup()
        result_path = self.scenario_instance.solve(
            output_folder=save_path, afterStepCallback=afterStepCallback
        )
        print(f"Simulation completed. Results saved to: {result_path}")
        return result_path

    def _write_params(self, save_path: str) -> None:
        """Record the run configuration + code version next to the
        outputs (simulation_params.txt, same artifact the reference
        emits)."""
        lines = [
            f"Scenario: {self.scenario_name}",
            f"Run Name: {self.name}",
            f"Solver: {self.solver_name}",
            f"mu: {'(scenario default)' if self.mu is None else self.mu}",
            f"rho: {'(scenario default)' if self.rho is None else self.rho}",
            f"T: {self.T}",
            f"dt: {self.dt}",
        ]
        lines += [
            f"{k}: {v}" for k, v in self.kwargs.items()
            if k not in ("mu", "rho")
        ]
        try:
            rev = subprocess.check_output(
                ["git", "rev-parse", "HEAD"],
                stderr=subprocess.DEVNULL,
                cwd=os.path.dirname(__file__),
            ).decode().strip()
            lines.append(f"Source Code Version (Git Commit): {rev}")
        except Exception:
            lines.append("Source Code Version: Unknown (git not valid)")
        with open(os.path.join(save_path, "simulation_params.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
