"""Smoke run of cfdtpu's main path on an NVIDIA GPU.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # four cards of one host

One card: DFG 2D-1 at the official 106,275 DOF through the CLI's
Simulation path (main.py simulate) for 12 steps, then the same case at
~9.8k DOF on the GPU in float64 and in float32, each compared with a
float64 solve on the CPU backend of the same process.

Four cards: DFG 2D-1 at 2,520 DOF in float64 with --n_shards 4 (the
halo node-BSR distribution) against the same mesh solved on one card,
and each card's peak memory.

Every phase prints one JSON object; the last line is
{"ok": true, "device": {...}}. A run that finds no GPU, or in which any
check fails, exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time

import numpy as np

DT = 0.05
# the solver configuration whose iteration counts are on record
# (bench.py): RAS-smoothed block AMG on A_uu inside a near-true Schur
# S-stage, chord Newton, operator and PC carried over 4 steps
SOLVER_KW = {
    "pc_inner_method": "rasamg_sup",
    "pc_inner_u": 0,
    "pc_inner_p": 5,
    "snes_lag_jacobian": True,
    "pc_ras_size": 32,
    "pc_lag_steps": 4,
    "stats_every": 4,
    "ksp_restart": 20,
}
SNES_MAX_IT = 100  # stabilized_schur.Solver defaults
KSP_MAX_IT = 1000

MAIN_RES_SCALE = 0.3   # 106,275 DOF
MAIN_STEPS = 12        # past the impulsive start; PC rebuilt at 1, 5, 9
REF_RES_SCALE = 1.0    # ~9.8k DOF
REF_STEPS = 3
FOUR_RES_SCALE = 2.0   # 2,520 DOF
FOUR_STEPS = 3

# The float64 runs drive Newton past its default stopping point, so that
# what is compared is the arithmetic more than where each Newton loop
# happened to stop, but short of the rounding floor, where Newton stalls
# (float64 at snes_rtol 1e-13 stalled once on an H100; 1e-11 keeps a
# margin). The float32 run keeps its dtype's own tolerances
# (utils/dtypes.py), the ones the main path runs with.
F64_TIGHT = {"snes_rtol": 1e-11, "snes_atol": 1e-14, "snes_stol": 1e-14}
# c_L is compared against the size of the force, |(c_D, c_L)|: at
# t = 0.15 the lift is under 1% of the drag, so a difference relative to
# c_L itself would amplify the field difference ~100-fold.
# GPU float64 against CPU float64: only the summation order differs
# (H100, snes_rtol 1e-11, identical iteration counts: u 1.3e-14,
# p 5.2e-15, c_D 1.3e-13, dp 6.3e-13). The bounds leave room for one
# Newton iteration more or less on either side.
F64_BOUNDS = {"u": 1e-10, "p": 1e-10, "c_D": 1e-9, "c_L": 1e-9,
              "dp": 1e-9}
# GPU float32 against CPU float64: each bound ~4x or more the largest
# of seven H100 and two CPU readings at the float32 defaults (PERF.md).
F32_BOUNDS = {"u": 1e-4, "c_D": 2e-3, "c_L": 5e-4, "dp": 2e-3}
# Four cards: the halo path (dist/halo.py) against one card, both in
# float64 with full Newton (a fresh Jacobian every iteration: no
# snes_lag_jacobian, no operator carried across steps) and otherwise the
# configuration above; only n_shards differs. The halo path has its own
# per-shard Schwarz PC and ignores the AMG/RAS options. That PC is
# one-level in the velocity, so its Krylov count grows with the mesh:
# ~150 per linear solve at 2,520 DOF in float64, ksp_max_it at 9,861
# DOF; in float32 some solves reach ksp_max_it at 2,520 already (CPU,
# 4 virtual devices; PERF.md). Larger meshes wait for a per-shard PC
# that scales (ROADMAP B1).
FOUR_DTYPE = np.float64
FOUR_KW = {**SOLVER_KW, "snes_lag_jacobian": False, "pc_lag_steps": 1}
# u: float64 leaves ~2e-10 (H100 and CPU alike). Newton: the rule of
# tests/test_dist.py. KSP: the one-level halo PC takes ~28x the serial
# AMG's 5-7 iterations per solve; 40 still fails a collapse to its
# unpreconditioned ksp_max_it.
SHARD_U_BOUND = 1e-6
SHARD_NEWTON_SLACK = 2
SHARD_KSP_FACTOR = 40


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def require_gpu(devices) -> dict:
    """The device record of the contract's last line; raises unless JAX
    runs on a GPU."""
    d = devices[0]
    if d.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX runs on {d.platform!r} ({d.device_kind})"
        )
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


def ok_line(device: dict) -> str:
    return json.dumps({"ok": True, "device": device})


def card_info() -> list[str]:
    """Each card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def peak_bytes(device) -> int:
    return int(device.memory_stats()["peak_bytes_in_use"])


def rel_l2(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def compare(got: dict, ref: dict, bounds: dict) -> tuple[dict, list]:
    """Differences of a run against its reference, and the list of
    bounds they break. Fields: relative L2 of u (and p, when bounded);
    the differences of c_D and dp relative to the reference's value, and
    of c_L relative to the reference's force |(c_D, c_L)|; each field
    bounded by its own entry."""
    diffs = {"u_rel_l2": rel_l2(got["u"], ref["u"])}
    if "p" in bounds:
        diffs["p_rel_l2"] = rel_l2(got["p"], ref["p"])
    force = float(np.hypot(ref["c_D"], ref["c_L"]))
    for key, scale in (("c_D", ref["c_D"]), ("c_L", force),
                       ("dp", ref["dp"])):
        diffs[f"{key}_rel"] = abs(got[key] - ref[key]) / abs(scale)
    fails = []
    for key, diff in diffs.items():
        field = key.split("_rel")[0]
        if diff > bounds[field]:
            fails.append(f"{key} {diff:.3e} > {bounds[field]}")
    return diffs, fails


def functionals(scenario, u, p) -> dict:
    """c_D, c_L (boundary line integrals) and the probe pressure
    difference of the state (u, p)."""
    s = scenario.solver
    keep = s.u_sol, s.p_sol
    s.u_sol, s.p_sol = u, p
    try:
        fd, fl = scenario.compute_drag_lift()
        dp = scenario.compute_pressure_diff()
    finally:
        s.u_sol, s.p_sol = keep
    return {"c_D": 500 * fd, "c_L": 500 * fl, "dp": dp}


def step_record(stats) -> dict:
    import jax

    st = jax.device_get(stats)
    return {
        "newton": int(st["newton_iters"]),
        "ksp": int(st["ksp_iters"]),
        "ksp_max": int(st["ksp_max_iters"]),
        "converged": bool(st["converged"]),
        "fnorm": float(st["fnorm"]),
    }


def check_step(rec: dict, u, p, label: str) -> None:
    check(rec["converged"], f"{label}: Newton did not converge")
    check(rec["newton"] < SNES_MAX_IT,
          f"{label}: newton {rec['newton']} >= {SNES_MAX_IT}")
    check(rec["ksp_max"] < KSP_MAX_IT,
          f"{label}: a linear solve took {rec['ksp_max']} >= {KSP_MAX_IT}")
    check(bool(np.isfinite(np.asarray(u)).all()
               and np.isfinite(np.asarray(p)).all()),
          f"{label}: non-finite state")


def dfg_steps(res_scale: float, steps: int, dtype, **kw) -> dict:
    """DFG 2D-1 for `steps` steps of DT on the default device; returns
    the final state, its functionals and per-step solver records."""
    from cfdtpu.scenarios.dfg_1 import DFG1Benchmark

    t0 = time.perf_counter()
    sc = DFG1Benchmark("stabilized_schur", dt=DT, T=steps * DT,
                       res_scale=res_scale, dtype=dtype, **kw)
    s = sc.solver
    setup_s = time.perf_counter() - t0
    records, walls = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        s.solveStep()
        rec = step_record(s.step_stats)  # fetch fences the step
        walls.append(time.perf_counter() - t0)
        check_step(rec, s.u_sol, s.p_sol, f"step {i + 1}")
        records.append(rec)
        s.u_prev, s.p_prev = s.u_sol, s.p_sol
    return {
        "u": np.asarray(s.u_sol), "p": np.asarray(s.p_sol),
        **functionals(sc, s.u_sol, s.p_sol),
        "ndofs": s.V.num_global_dofs + s.Q.num_global_dofs,
        "dtype": np.dtype(s.dtype).name,
        "setup_s": setup_s, "step_s": walls, "steps": records,
        "devices": sorted(str(d) for d in s.u_sol.devices()),
    }


def reference_comparison(res_scale: float, steps: int, ref_device,
                         runs: dict) -> list[dict]:
    """Solve the case in float64 on `ref_device`, then each of `runs`
    ({label: (dtype, bounds)}) on the default device, and compare each
    with the reference. Prints each comparison as it completes and
    returns them; the caller checks their "fails"."""
    import jax

    with jax.default_device(ref_device):
        ref = dfg_steps(res_scale, steps, np.float64,
                        **SOLVER_KW, **F64_TIGHT)
    check(ref["devices"] == [str(ref_device)],
          f"reference ran on {ref['devices']}, not {ref_device}")
    out = []
    for label, (dtype, bounds) in runs.items():
        extra = F64_TIGHT if np.dtype(dtype) == np.float64 else {}
        got = dfg_steps(res_scale, steps, dtype, **SOLVER_KW, **extra)
        diffs, fails = compare(got, ref, bounds)
        out.append({
            "phase": f"compare_{label}", "ndofs": got["ndofs"],
            "steps": steps, "dt": DT, "ref_device": ref["devices"][0],
            "device": got["devices"][0], "bounds": bounds, **diffs,
            "c_D": got["c_D"], "c_L": got["c_L"], "dp": got["dp"],
            "c_D_ref": ref["c_D"], "c_L_ref": ref["c_L"],
            "dp_ref": ref["dp"],
            "newton": [r["newton"] for r in got["steps"]],
            "ksp": [r["ksp"] for r in got["steps"]],
            "ksp_max": [r["ksp_max"] for r in got["steps"]],
            "newton_ref": [r["newton"] for r in ref["steps"]],
            "ksp_ref": [r["ksp"] for r in ref["steps"]],
            "fails": fails,
        })
        emit(out[-1])
    return out


def cli_tokens(kw: dict) -> list[str]:
    return [tok for k, v in kw.items() for tok in (f"--{k}", str(v))]


def main_path(out_dir: str) -> dict:
    """DFG 2D-1 at 106,275 DOF through main.py's Simulation."""
    import jax

    import main as cli

    argv = [
        "simulate", "--simulation", "dfg_1",
        "--solver", "stabilized_schur",
        # T half a step short of MAIN_STEPS * DT: exactly MAIN_STEPS
        # steps whatever the rounding of the accumulated time
        "--T", str((MAIN_STEPS - 0.5) * DT), "--dt", str(DT),
        "--name", "chip_smoke", "--output_dir", out_dir,
        "--res_scale", str(MAIN_RES_SCALE), "--dtype", "auto",
        "--output_every", str(MAIN_STEPS + 1),
        *cli_tokens(SOLVER_KW),
    ]
    args, unknown = cli.build_parser().parse_known_args(argv)
    t0 = time.perf_counter()
    sim = cli.make_simulation(args, unknown)
    setup_s = time.perf_counter() - t0
    scenario = sim.scenario_instance
    solver = scenario.solver

    marks, states = [], []

    def after_step(t):
        marks.append(time.perf_counter())
        states.append((solver.u_sol, solver.p_sol, solver.step_stats))

    t_start = time.perf_counter()
    sim.run(afterStepCallback=after_step)
    jax.block_until_ready(states[-1][:2])
    check(len(states) == MAIN_STEPS,
          f"ran {len(states)} steps, expected {MAIN_STEPS}")
    walls = np.diff([t_start] + marks)
    for i, (u, p, stats) in enumerate(states):
        rec = step_record(stats)
        check_step(rec, u, p, f"step {i + 1}")
        emit({"phase": "main_path_step", "step": i + 1,
              "t": round((i + 1) * DT, 6), **rec,
              "wall_s": float(walls[i]), **functionals(scenario, u, p)})
    # steps 8 and 12 fetch their stats (stats_every 4): both marks are
    # fenced, so the window is device time plus host overhead
    last4 = 4 / (marks[-1] - marks[-5])
    return {
        "phase": "main_path", "simulation": "dfg_1",
        "ndofs": solver.V.num_global_dofs + solver.Q.num_global_dofs,
        "dtype": np.dtype(solver.dtype).name, "dt": DT,
        "steps": MAIN_STEPS, "solver_kw": SOLVER_KW,
        "setup_s": setup_s, "compile_s": float(walls[0]),
        "steps_per_s_last4": last4,
        "peak_bytes_in_use": peak_bytes(jax.devices()[0]),
    }


def four_cards() -> dict:
    """The halo-sharded solve on 4 cards against one card."""
    import jax

    devices = jax.devices()
    check(len(devices) >= 4, f"need 4 cards, have {len(devices)}")
    sharded = dfg_steps(FOUR_RES_SCALE, FOUR_STEPS, FOUR_DTYPE,
                        n_shards=4, **FOUR_KW)
    peaks_sharded = [peak_bytes(d) for d in devices[:4]]
    serial = dfg_steps(FOUR_RES_SCALE, FOUR_STEPS, FOUR_DTYPE, **FOUR_KW)
    peaks_after = [peak_bytes(d) for d in devices[:4]]
    u_rel = rel_l2(sharded["u"], serial["u"])
    newton = [r["newton"] for r in sharded["steps"]]
    newton_s = [r["newton"] for r in serial["steps"]]
    ksp = [r["ksp"] for r in sharded["steps"]]
    ksp_s = [r["ksp"] for r in serial["steps"]]
    ksp_factor = max(k / max(ks, 1) for k, ks in zip(ksp, ksp_s))
    result = {
        "phase": "four_cards", "ndofs": sharded["ndofs"],
        "dtype": sharded["dtype"], "steps": FOUR_STEPS, "dt": DT,
        "n_shards": 4, "sharded_devices": sharded["devices"],
        "serial_devices": serial["devices"],
        "u_rel_l2": u_rel, "newton": newton, "newton_serial": newton_s,
        "ksp": ksp, "ksp_serial": ksp_s, "ksp_factor": ksp_factor,
        "ksp_max": [r["ksp_max"] for r in sharded["steps"]],
        "c_D": sharded["c_D"], "c_D_serial": serial["c_D"],
        "setup_s": sharded["setup_s"], "setup_s_serial": serial["setup_s"],
        "step_s": sharded["step_s"], "step_s_serial": serial["step_s"],
        "peak_bytes_sharded": peaks_sharded,
        "peak_bytes_after_serial": peaks_after,
    }
    emit(result)
    check(u_rel <= SHARD_U_BOUND, f"u_rel_l2 {u_rel:.3e} > {SHARD_U_BOUND}")
    for n, ns in zip(newton, newton_s):
        check(n <= ns + SHARD_NEWTON_SLACK,
              f"newton {n} > serial {ns} + {SHARD_NEWTON_SLACK}")
    check(ksp_factor <= SHARD_KSP_FACTOR,
          f"ksp factor {ksp_factor:.2f} > {SHARD_KSP_FACTOR}")
    return result


def main(argv=None) -> int:
    # every line reaches the log even when a time limit kills the run
    sys.stdout.reconfigure(line_buffering=True)
    from cfdtpu.utils.compile_cache import use_compile_cache

    cache_dir = use_compile_cache()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded solve and its "
                         "one-card comparison")
    opts = ap.parse_args(argv)

    import jax

    device = require_gpu(jax.devices())
    precision = jax.config.jax_default_matmul_precision
    emit({"phase": "device", **device, "cards": card_info(),
          "matmul_precision": precision, "x64": jax.config.jax_enable_x64,
          "compile_cache": cache_dir, "jax": jax.__version__})
    # float32 products in TF32 break the FGMRES orthogonalisation
    check(precision == "highest", f"matmul precision {precision!r}")

    if opts.four_cards:
        four_cards()
    else:
        with tempfile.TemporaryDirectory() as out_dir:
            emit(main_path(out_dir))
        cmp = reference_comparison(
            REF_RES_SCALE, REF_STEPS, jax.devices("cpu")[0],
            {"gpu_f32": (np.float32, F32_BOUNDS),
             "gpu_f64": (np.float64, F64_BOUNDS)},
        )
        fails = [f"{r['phase']}: {f}" for r in cmp for f in r["fails"]]
        check(not fails, "; ".join(fails))

    # the card's name and power limit, on the line before the last
    for line in card_info():
        print(line, flush=True)
    print(ok_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
