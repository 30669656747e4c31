#!/bin/bash
# Single-simulation SLURM job (analogue of the reference's
# src/simulation_hpc.sh, which wrapped mpirun + singularity). One python
# process drives the node's GPUs; multi-node runs add --distributed and
# take the jax.distributed coordinator from the SLURM environment.
#SBATCH --ntasks=1
#SBATCH --time=12:00:00

python main.py simulate "$@"
