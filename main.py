"""cfdtpu unified CLI.

Same command surface as the reference CLI (/root/reference/main.py):

    python main.py simulate --simulation lid_driven2D --solver \
        stabilized_schur --T 1 --dt 0.01 --name run [--key value ...]
    python main.py experiment {mesh,solve} --config cfg.yaml [--job_idx N]
    python main.py tree --config cfg.yaml --output out.msh

Unknown --key value pairs are literal-eval'd and forwarded through
Simulation -> Scenario -> Solver constructors, each layer keeping only the
kwargs its signature declares (the reference's extensibility mechanism,
main.py:12-31).

Implementation note: subcommand flags are declared as spec tables and
installed by _add_flags — the *surface* (names, types, defaults,
required-ness) is the compatibility contract, the construction isn't.
"""

import argparse
import ast
import sys


def parse_unknown_args(tokens):
    """Freeform `--key value` / `--key=value` / bare `--flag` pairs to a
    kwargs dict, values literal-eval'd when they parse (ints, floats,
    tuples, quoted strings) and kept verbatim otherwise."""
    out = {}
    it = iter(range(len(tokens)))
    for i in it:
        tok = tokens[i]
        if not tok.startswith("--"):
            continue
        body = tok[2:]
        if "=" in body:
            key, _, raw = body.partition("=")
        elif i + 1 < len(tokens) and not tokens[i + 1].startswith("--"):
            key, raw = body, tokens[i + 1]
            next(it, None)  # consume the value token
        else:
            key, raw = body, True
        if isinstance(raw, str):
            try:
                raw = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                pass  # verbatim string (scenario / solver names etc.)
        out[key] = raw
    return out


def make_simulation(args, unknown):
    """Build the Simulation that `simulate` runs: the freeform
    `--key value` pairs plus the optional physics flags that were given
    are forwarded through Simulation -> Scenario -> Solver."""
    from cfdtpu.simulation import Simulation

    kwargs = parse_unknown_args(unknown)
    # optional physics flags ride along only when given, so scenario
    # defaults stay in charge otherwise
    kwargs.update({
        k: v
        for k, v in (("mu", args.mu), ("rho", args.rho),
                     ("p_grade", args.p_grade))
        if v is not None
    })

    print(f"Running simulation with extra args: {kwargs}")
    return Simulation(
        name=args.name,
        simulation=args.simulation,
        solver=args.solver,
        T=args.T,
        dt=args.dt,
        output_dir=args.output_dir,
        early_stop_tolerance=args.early_stop_tolerance,
        **kwargs,
    )


def run_simulate(args, unknown):
    """Run a single CFD simulation."""
    try:
        sim = make_simulation(args, unknown)
    except (ValueError, ImportError, RuntimeError) as e:
        label = {
            ValueError: "Invalid configuration",
            ImportError: "Failed to load module",
            RuntimeError: "Initialization failed",
        }[type(e)]
        print(f"\n[ERROR] {label}: {e}")
        return 1

    try:
        sim.run()
    except Exception as e:
        print(f"\n[ERROR] Simulation failed: {type(e).__name__}: {e}")
        raise
    return 0


def _add_flags(parser, spec):
    """Install a flag spec table: (name, kwargs) pairs."""
    for name, kw in spec:
        parser.add_argument(name, **kw)


_HPC_FLAGS = [
    ("--hpc", dict(
        action="store_true",
        help="Dispatch to a SLURM cluster (sbatch job generation)")),
    ("--distributed", dict(
        action="store_true",
        help="Initialize jax.distributed (multi-process SPMD launch — "
             "the mpirun -n N analogue; auto-detects the cluster env "
             "unless --coordinator/--num_processes/--process_id given; "
             "each process of a host binds one local card)")),
    ("--coordinator", dict(default=None)),
    ("--num_processes", dict(type=int, default=None)),
    ("--process_id", dict(type=int, default=None)),
]

_SIMULATE_FLAGS = [
    ("--simulation", dict(required=True,
                          help="Scenario name (e.g. dfg_1)")),
    ("--solver", dict(required=True,
                      help="Solver name (e.g. stabilized_schur)")),
    ("--mu", dict(type=float, default=None, help="Viscosity")),
    ("--rho", dict(type=float, default=None, help="Density")),
    ("--T", dict(type=float, required=True, help="Total time")),
    ("--dt", dict(type=float, required=True, help="Time step")),
    ("--name", dict(required=True, help="Name of the run")),
    ("--output_dir", dict(default="results", help="Output directory")),
    ("--early_stop_tolerance", dict(
        type=float, default=1e-5,
        help="Tolerance for early stopping the simulation")),
    ("--cores", dict(type=int, default=1,
                     help="Number of chips/processes per job (for HPC "
                          "solve)")),
    ("--p_grade", dict(type=int, default=None,
                       help="Polynomial degree for velocity and pressure "
                            "spaces (p-refinement, default: 1)")),
    ("--time_limit", dict(type=str, default=None,
                          help="Time limit for SLURM job (e.g. 00:30:00, "
                               "requires --hpc)")),
]

_EXP_COMMON_FLAGS = [
    ("--config", dict(type=str, required=True,
                      help="Path to the YAML config")),
    ("--output", dict(type=str, default="results/experiments",
                      dest="exp_output",
                      help="Base directory for results")),
    ("--job_idx", dict(type=int, default=None,
                       help="Index of the experiment to run (for job "
                            "arrays)")),
]

_EXP_SOLVE_FLAGS = [
    ("--cores", dict(type=int, default=1,
                     help="Number of chips/processes per job")),
    ("--watch", dict(action="store_true", default=False,
                     help="After submitting an HPC job, watch it")),
    ("--time_limit", dict(type=str, default=None,
                          help="Time limit for each SLURM job")),
    ("--early_stop_tolerance", dict(
        type=float, default=None,
        help="Override early stop tolerance for all experiments")),
    ("--monitor", dict(action="store_true", default=False,
                       help="Enable solver monitoring output")),
]

_TREE_FLAGS = [
    ("--config", dict(type=str, required=True,
                      help="Path to the YAML config")),
    ("--output", dict(type=str, required=True,
                      help="Output path for the mesh (.msh)")),
    ("--bind", dict(action="store_true",
                    help="Bind the current directory (container compat "
                         "flag)")),
    ("--perf_point", dict(type=float, nargs=3,
                          help="Perfusion point in mm (x y z)")),
]


def build_parser():
    parser = argparse.ArgumentParser(
        description="cfdtpu - hemodynamic CFD in JAX - Unified CLI",
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    hpc_parent = argparse.ArgumentParser(add_help=False)
    _add_flags(hpc_parent, _HPC_FLAGS)

    sub = parser.add_subparsers(dest="command", help="Command")

    sim_p = sub.add_parser("simulate", parents=[hpc_parent],
                           help="Run a CFD simulation")
    _add_flags(sim_p, _SIMULATE_FLAGS)

    exp_p = sub.add_parser("experiment", help="Experiment-matrix manager")
    exp_common = argparse.ArgumentParser(add_help=False)
    _add_flags(exp_common, _EXP_COMMON_FLAGS)
    exp_sub = exp_p.add_subparsers(dest="exp_command",
                                   help="experiment subcommands")
    mesh_p = exp_sub.add_parser(
        "mesh", parents=[exp_common, hpc_parent],
        help="Generate meshes for the experiment matrix",
    )
    mesh_p.add_argument("--mode", choices=["all", "tree", "geometry"],
                        default="all", dest="meshing_mode",
                        help="Meshing stage to run")
    solve_p = exp_sub.add_parser(
        "solve", parents=[exp_common, hpc_parent],
        help="Solve the experiment matrix",
    )
    _add_flags(solve_p, _EXP_SOLVE_FLAGS)

    tree_p = sub.add_parser("tree", parents=[hpc_parent],
                            help="Generate a vascular tree")
    _add_flags(tree_p, _TREE_FLAGS)
    return parser


def _dispatch_experiment(args, unknown):
    from cfdtpu.experiments.main import run

    return run(args)


def _dispatch_tree(args, unknown):
    from cfdtpu.geom.tree.main import run

    return run(args)


def main():
    from cfdtpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    parser = build_parser()
    args, unknown = parser.parse_known_args()

    if getattr(args, "distributed", False):
        from cfdtpu.dist.process import init_distributed, process_index

        init_distributed(args.coordinator, args.num_processes,
                         args.process_id)
        print(f"[distributed] process {process_index()} up")

    if getattr(args, "hpc", False):
        from cfdtpu.experiments.hpc import dispatch_hpc

        sys.argv = [a for a in sys.argv if a != "--hpc"]
        dispatch_hpc(args, unknown)
        return 0

    handler = {
        "simulate": run_simulate,
        "experiment": _dispatch_experiment,
        "tree": _dispatch_tree,
    }.get(args.command)
    if handler is None:
        parser.print_help()
        return 1
    return handler(args, unknown)


if __name__ == "__main__":
    sys.exit(main() or 0)
