"""Multi-process (multi-host) launch support.

The reference launches SPMD ranks with `mpirun -n N python main.py ...`
(/root/reference/src/simulation_hpc.sh:14-19, README:58-69) and guards
all file I/O with `if rank == 0` (/root/reference/src/simulation.py:229,
src/scenario.py:151-164). Here the equivalent is `jax.distributed`
initialization behind the CLI `--distributed` flag: every process runs
the same program, JAX wires the global device mesh, and output is
written by process 0 only.

Launch examples (one process per GPU):
    # explicit flags: process i binds the card of its launcher's local
    # rank (LOCAL_RANK and the like), or card i when no launcher sets one
    python main.py simulate ... --distributed \
        --coordinator localhost:1234 --num_processes 2 --process_id 0
    # or rely on the environment (SLURM auto-detect binds each process
    # to the card of its SLURM_LOCALID)
    srun python main.py simulate ... --distributed
"""

from __future__ import annotations

import os

# where launchers put a process's rank among the processes of its host
LOCAL_RANK_VARS = ("LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK",
                   "SLURM_LOCALID")


def local_rank(process_id: int) -> int:
    """The card a process binds: the launcher's local rank where one of
    LOCAL_RANK_VARS is set, else `process_id`, which holds when every
    process runs on one host."""
    for var in LOCAL_RANK_VARS:
        if os.environ.get(var, "") != "":
            return int(os.environ[var])
    return int(process_id)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize jax.distributed. With no arguments, JAX auto-detects
    the cluster environment (SLURM variables).

    With explicit flags each process binds one local card (local_rank).
    Without the binding every process would claim memory on every card
    of its host."""
    import jax

    kw = {}
    if coordinator:
        kw["coordinator_address"] = coordinator
    if num_processes is not None:
        kw["num_processes"] = int(num_processes)
    if process_id is not None:
        kw["process_id"] = int(process_id)
        kw["local_device_ids"] = [local_rank(process_id)]
    jax.distributed.initialize(**kw)


def process_index() -> int:
    try:
        import jax

        return int(jax.process_index())
    except Exception:
        return 0


def process_count() -> int:
    try:
        import jax

        return int(jax.process_count())
    except Exception:
        return 1


def is_main_process() -> bool:
    return process_index() == 0


def barrier(name: str = "cfdtpu") -> None:
    """Block until all processes arrive (the comm.barrier() analogue,
    reference simulation.py:267). No-op single-process."""
    if process_count() <= 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


class _NullWriter:
    """Swallows writes on non-main processes (rank-0 I/O guard)."""

    def write(self, *a, **k):
        pass

    def close(self, *a, **k):
        pass

    def flush(self, *a, **k):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False
