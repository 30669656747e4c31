"""SLURM/HPC dispatch.

Rebuild of /root/reference/src/utils/hpc.py:290-628 dispatch_hpc: the
--hpc flag reroutes any CLI invocation to sbatch job submission —
experiment mesh becomes a tree job chained to a geometry job with
--dependency=afterok (:298-424), experiment solve becomes a job array
with one combination per --job_idx plus optional --monitor/--watch
(:426-560), simulate gets a VascuSynth pre-job dependency for tree
scenarios (:562-628). Here each job runs the same single-program CLI
(no mpirun; one process drives the cards, several via
jax.distributed), so the generated scripts invoke `python main.py ...`
directly.

Parity notes:
- Host<->container path remap: stages that run inside the container
  (geometry meshing, solving) see the data tree bound at /data; paths
  under $HOME/data (or $CFDTPU_HPC_DATA) are rewritten, exactly like the
  reference's /home/<user>/data -> /data rule (hpc.py:366-382, 466-476).
- --monitor forwards to the job command line; the solve path turns it
  into CFDTPU_MONITOR=1 per-step stdout stats — the analogue of the
  reference injecting -snes_monitor/-ksp_monitor PETSc options
  (hpc.py:499-506).
- --watch starts a tmux session with a sacct watcher and a `wjob <idx>`
  log-tailing helper (hpc.py:530-556); in dry-run the commands are
  printed instead.
- mesh --mode all skips the tree stage when every geometry_type in the
  matrix is plain "stenosis" (hpc.py:334-344).

When sbatch is unavailable the dispatcher prints the exact scripts and
commands it would submit (dry run) so configs remain testable anywhere.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

#: scenarios that need a bare-metal VascuSynth pre-job before solving
#: (reference hpc.py:589)
SCENARIOS_WITH_TREE = {"stenosis_with_tree"}


def remap_to_container(path: str) -> str:
    """Rewrite a host data path to its in-container bind location.

    The reference hardcodes /home/juanjo.zuluaga/data -> /data
    (hpc.py:366-382); here the host prefix is $CFDTPU_HPC_DATA when set,
    else $HOME/data."""
    host_data = os.environ.get(
        "CFDTPU_HPC_DATA", str(Path.home() / "data")
    )
    if path.startswith(host_data):
        return path.replace(host_data, "/data", 1)
    return path


def _submit(cmd: list[str], dry_run: bool) -> str | None:
    if dry_run:
        print("[HPC:dry-run] " + " ".join(cmd))
        # deterministic fake ids keep the dependency chain printable
        _submit.counter = getattr(_submit, "counter", 0) + 1
        return f"DRY{_submit.counter}"
    out = subprocess.check_output(cmd, text=True)
    job_id = None
    for line in out.splitlines():
        if line.startswith("Submitted batch job"):
            job_id = line.split()[-1]
            break
    if job_id is None:
        # sbatch --parsable / site wrappers print the bare id (possibly
        # "id;cluster") instead of the sentence — fall back to the last
        # token so afterok chains are never silently dropped
        tail = out.strip().split()
        if tail and tail[-1].split(";")[0].isdigit():
            job_id = tail[-1].split(";")[0]
    if job_id is None:
        raise RuntimeError(
            f"could not parse a job id from sbatch output: {out!r} — "
            "dependency chaining would be silently broken"
        )
    print(f"[HPC] submitted job {job_id}")
    return job_id


def _write_job_script(path: Path, body: str, ntasks: int = 1,
                      time_limit: str | None = None) -> Path:
    lines = [
        "#!/bin/bash",
        "#SBATCH --ntasks=%d" % ntasks,
    ]
    if time_limit:
        lines.append(f"#SBATCH --time={time_limit}")
    lines += ["", body, ""]
    path.write_text("\n".join(lines))
    path.chmod(0o755)
    return path


def _watch_job(job_id: str, dry_run: bool) -> None:
    """tmux sacct watcher + wjob log-tail helper
    (reference hpc.py:530-556)."""
    log_dir = str(Path.home() / "data/logs")
    session = f"watch_{job_id}"
    rc_path = Path.home() / ".wjob_rc"
    watch_cmd = (
        f"tmux new-session -d -s {session} "
        f"'watch -n 5 sacct -j {job_id} "
        f"--format=JobID,JobName,State,ExitCode,Elapsed'"
    )
    split_cmd = (
        f"tmux split-window -t {session} -h 'bash --rcfile {rc_path}'"
    )
    if dry_run or shutil.which("tmux") is None:
        print(f"[HPC:dry-run] {watch_cmd}")
        print(f"[HPC:dry-run] {split_cmd}")
        return
    rc_path.write_text(
        f'wjob() {{ tail -f {log_dir}/solve_{job_id}_"$1".out; }}\n'
        f'echo "wjob helper ready. Usage: wjob <idx>"\n'
    )
    subprocess.run(watch_cmd, shell=True)
    subprocess.run(split_cmd, shell=True)
    print(f"[HPC] tmux watch session '{session}' started "
          f"(attach: tmux attach -t {session})")


def _filter_tree_args(unknown: list[str]) -> list[str]:
    """Keep only `main.py tree` flags (--config/--output/--bind/
    --perf_point) from a simulate passthrough list."""
    keep: list[str] = []
    i = 0
    nvals = {"--config": 1, "--output": 1, "--bind": 0, "--perf_point": 3}
    while i < len(unknown):
        tok = unknown[i]
        flag = tok.split("=", 1)[0]
        if flag in nvals:
            if "=" in tok:
                keep.append(tok)
                i += 1
            else:
                keep.extend(unknown[i: i + 1 + nvals[flag]])
                i += 1 + nvals[flag]
        else:
            i += 1
    return keep


def _mesh_stages(args, config) -> list[str]:
    mode = getattr(args, "meshing_mode", None) or "geometry"
    if mode != "all":
        return [mode]
    geo_types = config.get("matrix", {}).get("geometry_type", [])
    if not isinstance(geo_types, list):
        geo_types = [geo_types]
    if geo_types and all(g == "stenosis" for g in geo_types):
        print("[HPC] pure stenosis experiment — skipping tree stage")
        return ["geometry"]
    return ["tree", "geometry"]


def dispatch_hpc(args, unknown) -> int:
    dry_run = shutil.which("sbatch") is None
    if dry_run:
        print(
            "[HPC] sbatch not found — printing the submission plan "
            "(dry run)."
        )
    workdir = Path("hpc_jobs")
    workdir.mkdir(exist_ok=True)
    py = sys.executable
    passthrough = " ".join(unknown)

    command = getattr(args, "command", None)
    if command == "simulate":
        body = (
            f"{py} main.py simulate --simulation {args.simulation} "
            f"--solver {args.solver} --T {args.T} --dt {args.dt} "
            f"--name {args.name} --output_dir {args.output_dir} "
            f"{passthrough}"
        )
        script = _write_job_script(
            workdir / "simulate.sh", body,
            ntasks=getattr(args, "cores", 1) or 1,
            time_limit=getattr(args, "time_limit", None) or "12:00:00",
        )
        cmd = ["sbatch"]
        # tree scenarios get a bare-metal VascuSynth pre-job chained
        # with afterok (reference hpc.py:588-615)
        if args.simulation in SCENARIOS_WITH_TREE:
            # forward only tree-subcommand flags from the simulate
            # passthrough: any simulate-specific extra (e.g. a solver
            # kwarg) would make the pre-job die at argparse time
            tree_args = _filter_tree_args(unknown)
            pre_body = f"{py} main.py tree {' '.join(tree_args)}".rstrip()
            pre_script = _write_job_script(
                workdir / "vascusynth_pretree.sh", pre_body,
            )
            pre_id = _submit(["sbatch", str(pre_script)], dry_run)
            if pre_id:
                cmd.append(f"--dependency=afterok:{pre_id}")
        cmd.append(str(script))
        _submit(cmd, dry_run)
        return 0

    if command == "experiment":
        from ..utils.config import load_config
        from .meshing import generate_experiment_matrix

        config = load_config(args.config)
        n = len(generate_experiment_matrix(config))
        job_idx = getattr(args, "job_idx", None)
        array_range = (
            str(job_idx) if job_idx is not None else f"0-{n - 1}"
        )

        if args.exp_command == "mesh":
            last_id = None
            for stage in _mesh_stages(args, config):
                # the tree stage runs bare-metal (host paths); the
                # geometry stage runs in the container (/data bind)
                out = (
                    remap_to_container(args.exp_output)
                    if stage == "geometry" else args.exp_output
                )
                body = (
                    f"{py} main.py experiment mesh "
                    f"--config {args.config} --mode {stage} "
                    f"--output {out} --job_idx $SLURM_ARRAY_TASK_ID"
                )
                script = _write_job_script(
                    workdir / f"hpc_{stage}.sh", body
                )
                cmd = ["sbatch", f"--array={array_range}"]
                if last_id:
                    cmd.append(f"--dependency=afterok:{last_id}")
                cmd.append(str(script))
                last_id = _submit(cmd, dry_run)
            return 0

        if args.exp_command == "solve":
            out = remap_to_container(args.exp_output)
            monitor = (
                "--monitor " if getattr(args, "monitor", False) else ""
            )
            body = (
                f"{py} main.py experiment solve --config {args.config} "
                f"--output {out} {monitor}"
                f"--job_idx $SLURM_ARRAY_TASK_ID"
            )
            script = _write_job_script(
                workdir / "hpc_solve.sh", body,
                ntasks=getattr(args, "cores", 1) or 1,
                time_limit=getattr(args, "time_limit", None)
                or "00:30:00",
            )
            cmd = ["sbatch", f"--array={array_range}"]
            cmd.append(f"--ntasks={getattr(args, 'cores', 1) or 1}")
            if getattr(args, "time_limit", None):
                cmd.append(f"--time={args.time_limit}")
            cmd.append(str(script))
            job_id = _submit(cmd, dry_run)
            if job_id and getattr(args, "watch", False):
                _watch_job(job_id, dry_run)
            return 0

    print(f"[HPC] nothing to dispatch for command {command!r}")
    return 1
